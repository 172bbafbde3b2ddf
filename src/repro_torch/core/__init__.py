"""The port's carbon, energy, telemetry, fault and availability models, and
engine snapshots: NumPy host code copied from the reference package's
``core`` (``tests/test_torch_engine_copy.py`` holds each module to its
source), with the Green advisor (``advisor``) and the carbon predictor
(``predictor``)."""
