"""`repro_torch.api` — the declarative Experiment layer (the ONE entry point).

    from repro_torch.api import Environment, Experiment, ExperimentSpec, ModelRef

    spec = ExperimentSpec(model=ModelRef("paper-charlm"),
                          federated=FederatedConfig(mode="async", ...),
                          environment=Environment(download_bps=50e6))
    result = Experiment(spec).run(on_round=lambda ev: print(ev.round_idx))
    spec.save("exp.json")     # shareable artifact; reload reproduces result

Strategies ("sync", "async", ...) dispatch through the string-keyed
registry in `repro_torch.federated.runtime`; carbon/energy/network models all
come from the spec's `Environment` rather than module defaults.

The modules of this package, ``core`` and the engine in ``federated`` are
copies of the reference package's NumPy host code, held to their sources by
``tests/test_torch_engine_copy.py``. ``sweep`` runs specs serially,
lane-batched or across worker processes (fault-tolerant on request); its
``device=`` is where real-learner specs run.
"""
from repro_torch.api.environment import Environment
from repro_torch.api.experiment import Experiment, Result, run_spec
from repro_torch.api.spec import ExperimentSpec, ModelRef
from repro_torch.api.sweep import sweep
from repro_torch.federated.runtime import (STRATEGIES, LaneRunner, LaneTask,
                                           RoundEvent, Strategy, get_strategy,
                                           register_strategy)

__all__ = [
    "Environment", "Experiment", "ExperimentSpec", "LaneRunner", "LaneTask",
    "ModelRef", "Result", "RoundEvent", "STRATEGIES", "Strategy",
    "get_strategy", "register_strategy", "run_spec", "sweep",
]
