"""The port's first slice as a whole: federated rounds of the CharLM on the
port learner against the JAX reference learner, from the same transferred
init with the same cohorts, and the port learner injected into the
reference ``Experiment`` engine.

Tolerances: with no compression, server params within 1e-5 (the
reference's client-step tolerance) and perplexity within rtol 1e-4; with
int8 compression perplexity within rtol 1e-3, because a delta that differs
in its last bit can flip one rounding at a .5 boundary of the codec.

The param check uses a server SGD step, which carries the clients'
last-bit differences (about 3e-8 here) through unchanged. FedAdam does not:
it divides each mean-delta entry by its own RMS plus eps = 1e-8, so an
entry near 1e-7 whose last bits differ moves by up to lr times that
relative difference (params then differ by about 4e-5 after six steps in
this test). The FedAdam runs are therefore held by perplexity, here and in
the reference-engine runs below.
"""
import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import Experiment, ExperimentSpec, ModelRef  # noqa: E402
from repro.configs import FederatedConfig as JFed  # noqa: E402
from repro.configs import RunConfig as JRun  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data import FederatedDataset as JDataset  # noqa: E402
from repro.federated.real import RealLearner as JLearner  # noqa: E402
from repro_torch.configs import (FederatedConfig, RunConfig,  # noqa: E402
                                 model_config_from_dict)
from repro_torch.data import FederatedDataset  # noqa: E402
from repro_torch.federated.real import RealLearner  # noqa: E402
from repro_torch.launch import train  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _tiny_charlm():
    """tests/test_system.py's tiny config."""
    return dataclasses.replace(
        jreduced(jget_config("paper-charlm"), layers=1, d_model=64, d_ff=64,
                 vocab=256),
        lstm_hidden=64, max_context=16)


def _port(jcfg, jfed, jrun, seq_len, init):
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    ds = FederatedDataset(vocab_size=cfg.vocab_size, seq_len=seq_len,
                          char_vocab=cfg.char_vocab,
                          max_word_len=cfg.max_word_len)
    return RealLearner(cfg, FederatedConfig(**dataclasses.asdict(jfed)),
                       RunConfig(**dataclasses.asdict(jrun)), ds,
                       device="cpu", init_params=init)


@pytest.mark.parametrize("compression,server_opt", [("none", "sgd"),
                                                    ("int8", "adam")])
def test_rounds_match_jax_learner(compression, server_opt):
    """3 sync rounds (vmapped cohort path in JAX) then 3 FedBuff applies
    with staleness (per-client path, stale base params)."""
    jcfg = dataclasses.replace(_tiny_charlm(), d_model=32, lstm_hidden=32,
                               d_ff=32, vocab_size=128)
    jfed = JFed(mode="sync", concurrency=4, aggregation_goal=3,
                client_lr=0.3, server_lr=0.02, client_batch_size=4,
                staleness_cap=4, compression=compression,
                server_optimizer=server_opt)
    jrun = JRun(max_rounds=6, eval_clients=4)
    jds = JDataset(vocab_size=jcfg.vocab_size, seq_len=8,
                   char_vocab=jcfg.char_vocab, max_word_len=jcfg.max_word_len)
    jl = JLearner(jcfg, jfed, jrun, jds, max_client_steps=3)
    tl = _port(jcfg, jfed, jrun, 8, jax.device_get(jl.params))
    tl.max_steps = 3
    rtol = 1e-4 if compression == "none" else 1e-3
    rng = np.random.default_rng(0)
    for _ in range(3):
        cohort = rng.choice(10_000, size=3, replace=False).tolist()
        for lr in (jl, tl):
            d, w = lr.client_deltas(cohort)
            lr.apply(d, w, n_contributors=len(cohort))
        np.testing.assert_allclose(tl.eval_perplexity(), jl.eval_perplexity(),
                                   rtol=rtol)
    for _ in range(3):
        cids = rng.choice(10_000, size=2, replace=False).tolist()
        vers = [jl.version - 1, jl.version - 2]
        for lr in (jl, tl):
            out = [lr.client_delta(c, v) for c, v in zip(cids, vers)]
            lr.apply([d for d, _ in out], [w for _, w in out],
                     staleness=[lr.version - v for v in vers])
        np.testing.assert_allclose(tl.eval_perplexity(), jl.eval_perplexity(),
                                   rtol=rtol)
    assert tl.version == jl.version == 6
    assert len(tl._history) == len(jl._history) == 4
    if compression == "none":
        for k, v in jax.device_get(jl.params).items():
            np.testing.assert_allclose(tl.params[k].numpy(), v, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_port_learner_in_reference_experiment(mode):
    """The port learner injected into the unchanged reference engine
    reproduces the JAX learner's summary, and trains as test_system.py
    asks: sync ppl < 0.7 ppl0 in 10 rounds, async < 0.8 ppl0 at 8."""
    if mode == "sync":
        fed = JFed(mode="sync", concurrency=6, aggregation_goal=4,
                   client_lr=0.3, server_lr=0.02, client_batch_size=8)
        run, bound = JRun(target_perplexity=5.0, max_rounds=10,
                          max_hours=1e6), 0.7
    else:
        fed = JFed(mode="async", concurrency=6, aggregation_goal=3,
                   client_lr=0.3, server_lr=0.02, staleness_cap=8)
        run, bound = JRun(target_perplexity=5.0, max_rounds=8,
                          max_hours=1e6), 0.8
    spec = ExperimentSpec(model=ModelRef.from_config(_tiny_charlm()),
                          federated=fed, run=run, learner="real", seq_len=16)
    jexp = Experiment(spec)
    jl = jexp.build_learner()
    ppl0 = jl.eval_perplexity()
    tl = _port(jexp.model_config, fed, run, 16, jax.device_get(jl.params))
    assert tl.eval_perplexity() == pytest.approx(ppl0, rel=1e-5)
    want = jexp.run().summary()
    got = Experiment(spec, learner=tl).run().summary()
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "perplexity":
            assert got[k] == pytest.approx(want[k], rel=1e-4)
        else:
            assert got[k] == want[k], k
    assert got["rounds"] == run.max_rounds
    assert got["perplexity"] < bound * ppl0


def test_train_cli_runs_on_cpu(capsys, tmp_path):
    """The train CLI (a thin CLI over the port's Experiment since the
    reference's own CLI was copied) runs a reduced real sync run on the
    CPU through the engine, with the int8 codec."""
    out_json = tmp_path / "s.json"
    assert train.main(["--reduced", "--device", "cpu", "--concurrency", "3",
                       "--aggregation-goal", "2", "--rounds", "2",
                       "--seq-len", "8", "--batch-size", "4",
                       "--compression", "int8", "--json",
                       str(out_json)]) == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines()
             if l.startswith("[train] paper-charlm sync")]
    assert len(lines) == 1 and "rounds=2 " in lines[0]
    ppl = float(lines[0].split("ppl=")[1].split()[0])
    assert np.isfinite(ppl)
    import json
    summary = json.loads(out_json.read_text())
    assert summary["rounds"] == 2 and summary["sessions"] > 0
    assert np.isfinite(summary["perplexity"])
    with pytest.raises(SystemExit):
        train.main(["--help"])
    help_text = capsys.readouterr().out
    assert "--device" in help_text and "--ckpt" in help_text


def test_cohort_selection_matches_reference_engine():
    from repro.federated.runtime import _POPULATION as ref_population
    from repro.federated.runtime import _select_cohort as ref_select
    from repro_torch.federated.runtime import _POPULATION, _select_cohort
    assert _POPULATION == ref_population == 5_000_000
    for seed in (0, 7):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):
            np.testing.assert_array_equal(
                _select_cohort(a, 20, _POPULATION),
                ref_select(b, 20, ref_population))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)
