"""The port's scalar oracle (``repro_torch.federated.reference.run_scalar``):
the port's columnar sync and async engines reproduce it seed for seed, to
the reference's own tolerance (rel 1e-9, as ``tests/test_columnar.py``
holds the reference's engines to its oracle), and it equals the reference
package's oracle on the same specs bit for bit: TaskLog stats and
CarbonBreakdown."""
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import FederatedConfig as JFed  # noqa: E402
from repro.configs import RunConfig as JRun  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.federated.reference import run_scalar as jrun_scalar  # noqa: E402
from repro.federated.surrogate import SurrogateLearner as JSurrogate  # noqa: E402
from repro_torch.configs import FederatedConfig, RunConfig, get_config  # noqa: E402
from repro_torch.federated.reference import run_scalar  # noqa: E402
from repro_torch.federated.runtime import get_strategy  # noqa: E402
from repro_torch.federated.surrogate import SurrogateLearner  # noqa: E402

# tests/test_columnar.py's strategy-equivalence cases (mode, concurrency)
CASES = [("sync", 120), ("async", 120), ("async", 37)]
TARGET = 175.0


def _fed(cls, mode, conc):
    return cls(mode=mode, concurrency=conc, aggregation_goal=int(conc * 0.8))


@functools.lru_cache(maxsize=None)
def _port_scalar(mode, conc):
    cfg, fed, run = get_config("paper-charlm"), _fed(FederatedConfig, mode,
                                                     conc), \
        RunConfig(target_perplexity=TARGET)
    return run_scalar(cfg, fed, run, SurrogateLearner(cfg, fed, run))


def _stats(res):
    return {"rounds": res.rounds, "sessions": res.log.n_sessions,
            "participation": res.log.participation(),
            "mean_staleness": res.log.mean_staleness(),
            "duration_h": res.duration_h,
            "reached_target": res.reached_target,
            "final_perplexity": res.final_perplexity,
            "carbon": res.carbon.as_dict()}


@pytest.mark.parametrize("mode,conc", CASES)
def test_columnar_engine_matches_the_ports_oracle(mode, conc):
    cfg, fed, run = get_config("paper-charlm"), _fed(FederatedConfig, mode,
                                                     conc), \
        RunConfig(target_perplexity=TARGET)
    vec = get_strategy(mode).run(cfg, fed, run,
                                 SurrogateLearner(cfg, fed, run))
    ref = _port_scalar(mode, conc)
    assert vec.rounds == ref.rounds
    assert vec.log.n_sessions == ref.log.n_sessions
    assert vec.log.participation() == ref.log.participation()
    for k, v in vec.carbon.as_dict().items():
        assert v == pytest.approx(ref.carbon.as_dict()[k], rel=1e-9), k
    assert vec.duration_h == pytest.approx(ref.duration_h, rel=1e-9)
    assert vec.log.mean_staleness() == pytest.approx(
        ref.log.mean_staleness(), rel=1e-9)


@pytest.mark.parametrize("mode,conc", CASES)
def test_ports_oracle_equals_the_reference_oracle(mode, conc):
    cfg, fed, run = jget_config("paper-charlm"), _fed(JFed, mode, conc), \
        JRun(target_perplexity=TARGET)
    want = _stats(jrun_scalar(cfg, fed, run, JSurrogate(cfg, fed, run)))
    assert _stats(_port_scalar(mode, conc)) == want


def test_oracle_flushes_in_flight_sessions_as_the_reference_does():
    """The async oracle's cancelled-session flush at task end (the
    reference's own check in tests/test_columnar.py), on a short run."""
    kw = dict(mode="async", concurrency=64, aggregation_goal=48)
    cfg, fed, run = get_config("paper-charlm"), FederatedConfig(**kw), \
        RunConfig(target_perplexity=TARGET, max_rounds=25)
    got = run_scalar(cfg, fed, run, SurrogateLearner(cfg, fed, run))
    jcfg, jfed, jrun = jget_config("paper-charlm"), JFed(**kw), \
        JRun(target_perplexity=TARGET, max_rounds=25)
    want = jrun_scalar(jcfg, jfed, jrun, JSurrogate(jcfg, jfed, jrun))
    assert got.log.participation().get("cancelled", 0) > 0
    assert _stats(got) == _stats(want)
    vec = get_strategy("async").run(cfg, fed, run,
                                    SurrogateLearner(cfg, fed, run))
    assert vec.log.participation() == got.log.participation()
    assert vec.carbon.total_kg == pytest.approx(got.carbon.total_kg,
                                                rel=1e-9)
