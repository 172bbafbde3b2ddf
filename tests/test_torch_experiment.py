"""The paper's workload end to end on the CPU: ``repro_torch.api.Experiment``
with the port's real learner against ``repro.api.Experiment`` with the JAX
learner, from the same weights, in sync, async and carbon-aware mode with
the int8 uplink codec.

Every ``summary()`` key is equal, and so are the participation and the
mean staleness, except the perplexity, which is held within rel 1e-4: the
tolerance of ``tests/test_torch_slice.py`` for the port learner in the
reference engine.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.api as ref_api  # noqa: E402
from repro.configs import FederatedConfig as RefFed  # noqa: E402
from repro.configs import RunConfig as RefRun  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
import repro_torch.api as port_api  # noqa: E402
from repro_torch.data import FederatedDataset  # noqa: E402
from repro_torch.federated import RealLearner  # noqa: E402

torch.set_num_threads(2)

MODES = ("sync", "async", "carbon-aware")


def _tiny_charlm():
    """tests/test_system.py's tiny config."""
    return dataclasses.replace(
        ref_reduced(ref_get_config("paper-charlm"), layers=1, d_model=64,
                    d_ff=64, vocab=256),
        lstm_hidden=64, max_context=16)


def _spec(mode):
    fed = RefFed(mode=mode, concurrency=6,
                 aggregation_goal=4 if mode == "sync" else 3,
                 client_lr=0.3, server_lr=0.02, client_batch_size=8,
                 staleness_cap=8, compression="int8")
    # target_perplexity 1.0 cannot be reached: every run goes 4 rounds
    run = RefRun(target_perplexity=1.0, max_rounds=4, max_hours=1e6,
                 eval_clients=4)
    return ref_api.ExperimentSpec(
        model=ref_api.ModelRef.from_config(_tiny_charlm()), federated=fed,
        run=run, learner="real", seq_len=16, max_client_steps=3)


def _assert_summaries_match(got, want, rel):
    g, w = got.summary(), want.summary()
    assert sorted(g) == sorted(w)
    for k in w:
        if k == "perplexity":
            assert math.isfinite(g[k])
            if rel is not None:
                assert g[k] == pytest.approx(w[k], rel=rel)
        else:
            assert g[k] == w[k], k
    assert got.log.participation() == want.log.participation()
    assert got.log.mean_staleness() == want.log.mean_staleness()


def _codec_calls_from_log(log, mode):
    """What the engine's record implies for the learner's codec calls, as
    chip_smoke.py derives its K1/K2 launch counts: a sync round that is not
    starved makes one ``client_deltas`` call (one codec pass over the
    stacked cohort); an async or carbon-aware update calls ``client_delta``
    once for each contributor, and the contributors are the completed
    sessions of the log while every window closes on an update."""
    if mode == "sync":
        return {"client_deltas": log.rounds - log.starved_rounds,
                "client_delta": 0}
    return {"client_deltas": 0, "client_delta": log.completed_sessions()}


def _count_calls(learner, calls):
    for name in calls:
        def counted(*a, _f=getattr(learner, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        setattr(learner, name, counted)


@pytest.mark.parametrize("mode", MODES)
def test_port_experiment_matches_reference(mode):
    ref_spec = _spec(mode)
    spec = port_api.ExperimentSpec.from_json(ref_spec.to_json())
    assert spec.content_hash() == ref_spec.content_hash()
    ref_exp = ref_api.Experiment(ref_spec)
    init = jax.device_get(ref_exp.build_learner().params)
    cfg = port_api.Experiment(spec).model_config
    ds = FederatedDataset(vocab_size=cfg.vocab_size, seq_len=spec.seq_len,
                          char_vocab=cfg.char_vocab,
                          max_word_len=cfg.max_word_len)
    learner = RealLearner(cfg, spec.federated, spec.run, ds,
                          max_client_steps=spec.max_client_steps,
                          device="cpu", init_params=init)
    calls = {"client_deltas": 0, "client_delta": 0}
    _count_calls(learner, calls)
    rounds = []
    got = port_api.Experiment(spec, learner=learner, device="cpu").run(
        on_round=rounds.append)
    want = ref_exp.run()
    _assert_summaries_match(got, want, rel=1e-4)
    assert got.rounds == len(rounds) == 4
    assert [e.round_idx for e in rounds] == [1, 2, 3, 4]
    assert calls == _codec_calls_from_log(got.log, mode)
    assert sum(calls.values()) > 0


def test_port_experiment_builds_its_learner_on_the_cpu():
    """With no learner given, the port builds its own (from its own seeded
    init, so only the perplexity may differ from the reference's run)."""
    ref_spec = _spec("async")
    exp = port_api.Experiment(port_api.ExperimentSpec.from_json(
        ref_spec.to_json()), device="cpu")
    learner = exp.build_learner()
    assert isinstance(learner, RealLearner)
    assert learner.device == torch.device("cpu")
    got = exp.run()
    _assert_summaries_match(got, ref_api.Experiment(ref_spec).run(),
                            rel=None)


def test_real_learner_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = port_api.ExperimentSpec.from_json(_spec("sync").to_json())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_api.Experiment(spec).run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_api.Experiment(spec, device="cuda").build_learner()
    assert port_api.Experiment(spec, device="cpu").build_learner().real
    # a surrogate run touches no tensor, so it needs no device
    surrogate = spec.replace(learner="surrogate")
    assert port_api.Experiment(surrogate).run().rounds == 4
