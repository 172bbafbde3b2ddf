"""The port's event engine and carbon accounting against the reference's, on
the surrogate learner: the same spec through both packages' ``Experiment``
gives a bit-equal ``Result.to_dict()`` (all but ``wall_s``) and bit-equal
session columns. Also the spec's JSON across packages, one checkpoint and
resume per strategy (the reference's snapshot contract), and the config
accounting the engine reads (parameter count, training FLOPs a token).
"""
import dataclasses
import os
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.api as ref_api  # noqa: E402
from repro.configs import FederatedConfig as RefFed  # noqa: E402
from repro.configs import RunConfig as RefRun  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.availability import diurnal_availability  # noqa: E402
from repro.core.carbon import UTC_OFFSET_H  # noqa: E402
from repro.core.faults import FaultModel, wave_hazard_schedule  # noqa: E402
from repro.core.profiles import COUNTRY_MIX  # noqa: E402
import repro_torch.api as port_api  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.snapshot import InjectedCrash  # noqa: E402
from repro_torch.core.telemetry import _ACC_DTYPES  # noqa: E402

torch.set_num_threads(2)

SPECS = sorted((Path(__file__).resolve().parents[1] / "examples" / "specs")
               .glob("*.json"))
MODES = ("sync", "async", "carbon-aware")


def _port_spec(ref_spec):
    """The reference spec's JSON, loaded by the port."""
    spec = port_api.ExperimentSpec.from_json(ref_spec.to_json())
    assert spec.content_hash() == ref_spec.content_hash()
    assert spec.to_dict() == ref_spec.to_dict()
    return spec


def _assert_same_columns(got, want):
    a, b = got.columns(), want.columns()
    assert a.device_names == b.device_names
    assert a.country_names == b.country_names
    assert len(a) == len(b) > 0
    for f in _ACC_DTYPES:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        assert np.array_equal(x, y), f


def _assert_same_result(got, want):
    g, w = got.to_dict(), want.to_dict()
    g.pop("wall_s")
    w.pop("wall_s")
    assert g == w
    assert got.log.eval_history == want.log.eval_history
    _assert_same_columns(got.log, want.log)


@pytest.mark.parametrize("path", SPECS, ids=lambda p: p.stem)
def test_example_spec_matches_reference(path):
    """The six example specs: sync, async and carbon-aware, bursty faults,
    availability churn and a population in streaming telemetry."""
    ref_spec = ref_api.ExperimentSpec.load(str(path))
    spec = port_api.ExperimentSpec.load(str(path))
    assert spec.content_hash() == ref_spec.content_hash()
    _assert_same_result(port_api.Experiment(spec).run(),
                        ref_api.Experiment(ref_spec).run())


def _faulty_spec(mode, telemetry="full", max_rounds=12):
    """A diurnal grid with wave hazards, correlated bursts and diurnal
    availability, with retries, checkpoint salvage and (sync)
    over-selection: every branch of the engine's fault and churn paths."""
    countries = tuple(COUNTRY_MIX)
    env = ref_api.Environment.preset(
        "diurnal",
        fault=FaultModel(hazard_schedule=wave_hazard_schedule(countries,
                                                              base=0.08),
                         hazard_phase_h=dict(UTC_OFFSET_H),
                         burst_rate_per_day=4.0, burst_duration_s=2400.0,
                         burst_fail_prob=0.6, seed=7),
        availability=diurnal_availability(countries))
    fed = RefFed(mode=mode, concurrency=12, aggregation_goal=9, seed=3,
                 dropout_rate=0.05, retry_limit=2, retry_backoff_s=30.0,
                 checkpoint_period_s=120.0,
                 over_select_fraction=0.25 if mode == "sync" else 0.0,
                 min_report_fraction=0.5 if mode == "sync" else 0.0)
    run = RefRun(target_perplexity=1.0, max_rounds=max_rounds,
                 telemetry=telemetry, telemetry_sample=64)
    return ref_api.ExperimentSpec(model=ref_api.ModelRef("paper-charlm"),
                                  federated=fed, run=run, environment=env,
                                  learner="surrogate")


@pytest.mark.parametrize("mode", MODES)
def test_faults_and_availability_match_reference(mode):
    ref_spec = _faulty_spec(mode)
    want = ref_api.Experiment(ref_spec).run()
    part = want.log.participation()
    # the environment really failed, retried and interrupted sessions
    assert part.get("failed", 0) + part.get("retried", 0) > 0
    assert part.get("interrupted", 0) > 0
    _assert_same_result(port_api.Experiment(_port_spec(ref_spec)).run(),
                        want)


@pytest.mark.parametrize("mode", MODES)
def test_checkpoint_and_resume_is_bit_exact(mode, tmp_path, monkeypatch):
    """Killed after round 7 with a checkpoint every 3 rounds, then resumed
    from the file: the same result as the uninterrupted run, bit for bit."""
    spec = _port_spec(_faulty_spec(mode, telemetry="streaming"))
    whole = port_api.Experiment(spec).run()
    path = str(tmp_path / "snap.npz")
    monkeypatch.setenv("REPRO_CRASH_ROUND", "7")
    monkeypatch.setenv("REPRO_CRASH_KIND", "raise")
    with pytest.raises(InjectedCrash):
        port_api.Experiment(spec).run(checkpoint_path=path,
                                      checkpoint_every_rounds=3)
    monkeypatch.delenv("REPRO_CRASH_ROUND")
    assert os.path.exists(path)
    resumed = port_api.Experiment.resume(path)
    assert resumed.checkpoint_stats["saves"] > 0
    _assert_same_result(resumed, whole)


def test_real_learner_snapshot_names_the_port_learner(tmp_path):
    spec = port_api.ExperimentSpec(
        model=port_api.ModelRef("paper-charlm", reduced=True),
        learner="real")
    with pytest.raises(ValueError, match="port's real learner"):
        port_api.Experiment(spec, device="cpu").run(
            checkpoint_path=str(tmp_path / "x.npz"),
            checkpoint_every_rounds=1)


@pytest.mark.parametrize("arch", ["paper-charlm", "smollm-135m", "rwkv6-7b"])
def test_config_accounting_matches_reference(arch):
    """What the engine charges a session reads these three numbers."""
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert cfg.train_flops_per_token() == ref.train_flops_per_token()


def test_unported_arch_raises():
    spec = port_api.ExperimentSpec(model=port_api.ModelRef("mixtral-8x22b"))
    with pytest.raises(KeyError, match="not ported yet"):
        port_api.Experiment(spec).run()
