"""Federated training of the dense transformer (smollm-135m) in the port
against the JAX reference, on the CPU, from weights carried across with
``params_from_jax``:

* ``DecoderLM.loss`` and its gradient (``torch.func.grad_and_value``, as
  the cohort step takes it; attention's gradient from the plain version of
  K3's backward) at the reduced smollm-135m against JAX's ``loss`` and
  ``jax.grad``: loss within rel 1e-5, each gradient leaf within 1e-5 of
  max(1, its largest entry), the reference's client-step tolerance; a
  padding batch (mask all zero) gives loss 0 and a zero gradient.
* ``repro_torch.api.Experiment`` against ``repro.api.Experiment`` on the
  reduced smollm spec, sync and async, with and without the int8 codec:
  every summary key equal, perplexity within rel 1e-4 (1e-3 with int8),
  as ``tests/test_torch_experiment.py`` holds the CharLM.
* The train CLI's smollm example (``--arch smollm-135m --reduced --mode
  async --concurrency 6``) with ``--device cpu`` against the reference CLI,
  and the spec CLI's ``--roundtrip-check`` on its spec.

The reference's init draws wq, wk and wv at 1/sqrt(heads), not
1/sqrt(d_model) (ROADMAP §3), which makes attention almost one-hot and
the model chaotic in f32: a relative noise of 1e-7 in the init (one f32
rounding) moves the JAX learner's own perplexity after 3 sync rounds by
6.6%, and its loss gradient by up to 2.8e-4 (the embedding's, whose
largest entry is 4.8). So the runs start from the reference's init with
those three projections rescaled to 1/sqrt(d_model), as ``chip_smoke.py``
checks full-width serving, where the same noise moves JAX's perplexity by
4e-6 (sync) and 1e-5 (async) and its gradient by under 4e-7. The gradient
is also held under the reference's own init, where the bound is that
tolerance plus twice the change of JAX's own gradient under that noise.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as ref_api  # noqa: E402
import repro.launch.train as ref_train  # noqa: E402
from repro.configs import FederatedConfig as RefFed  # noqa: E402
from repro.configs import RunConfig as RefRun  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
import repro_torch.api as port_api  # noqa: E402
import repro_torch.api.__main__ as api_cli  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.configs import model_config_from_dict  # noqa: E402
from repro_torch.data import FederatedDataset  # noqa: E402
from repro_torch.federated import RealLearner  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

torch.set_num_threads(2)

ARCH = "smollm-135m"


def _rescaled(params):
    """wq, wk and wv at 1/sqrt(d_model) (from the reference's
    1/sqrt(heads)); the other leaves as they are."""
    out = dict(params)
    for w in ("wq", "wk", "wv"):
        t = np.asarray(params[f"blocks/{w}"])
        out[f"blocks/{w}"] = t * np.float32(math.sqrt(t.shape[-2] /
                                                      t.shape[1]))
    return out


def _jax_model():
    spec = ref_train.reduced_model_ref(ARCH)
    jcfg = spec.resolve()
    jm = jget_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    return jm, jax.device_get(jp), cfg


def _batch(cfg, seed=0, B=4, S=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S - 1), np.float32)
    mask[-1, 5:] = 0.0                      # a ragged row
    return {"tokens": toks, "labels": toks, "mask": mask}


def _torch_batch(b):
    return {k: torch.as_tensor(v, dtype=torch.long if v.dtype.kind == "i"
                               else torch.float32) for k, v in b.items()}


@pytest.mark.parametrize("init", ["rescaled", "reference"])
def test_loss_and_gradient_match_jax(init):
    jm, jp, cfg = _jax_model()
    if init == "rescaled":
        jp = _rescaled(jp)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grad_fn = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb),
                                         has_aux=True))
    (jl, jaux), jg = grad_fn({k: jnp.asarray(v) for k, v in jp.items()})
    slack = {k: 0.0 for k in jg}
    if init == "reference":
        rng = np.random.default_rng(1)
        noisy = {k: jnp.asarray(v * (1 + 1e-7 * rng.standard_normal(v.shape)
                                     .astype(np.float32)))
                 for k, v in jp.items()}
        jg2 = grad_fn(noisy)[1]
        slack = {k: 2 * float(np.abs(np.asarray(jg[k]) -
                                     np.asarray(jg2[k])).max()) for k in jg}

    tm = get_model(cfg)
    tp = params_from_jax(jp, "cpu", cfg)
    tb = _torch_batch(batch)
    loss, metrics = tm.loss(tp, tb)
    assert float(metrics["aux"]) == float(jaux["aux"]) == 0.0
    assert float(metrics["xent"]) == float(loss)
    g, value = torch.func.grad_and_value(lambda p: tm.loss(p, tb)[0])(tp)
    assert float(value) == float(loss)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    assert sorted(g) == sorted(jg)
    for k in jg:
        want = np.asarray(jg[k])
        err = float(np.abs(g[k].numpy() - want).max())
        bound = 1e-5 * max(1.0, float(np.abs(want).max())) + slack[k]
        assert err <= bound, f"{k}: max abs err {err} > {bound}"


def test_a_padding_batch_gives_zero_loss_and_a_zero_gradient():
    """The cohort pads a client's missing steps with an all-zero batch and
    a zero mask: its loss is 0 and its gradient finite and zero, so the
    masked step keeps the params exactly."""
    _, jp, cfg = _jax_model()
    tm = get_model(cfg)
    tp = params_from_jax(jp, "cpu", cfg)
    pad = {k: np.zeros_like(v) for k, v in _batch(cfg).items()}
    g, loss = torch.func.grad_and_value(
        lambda p: tm.loss(p, _torch_batch(pad))[0])(tp)
    assert float(loss) == 0.0
    for k, v in g.items():
        assert torch.equal(v, torch.zeros_like(v)), k


def _spec(mode, compression):
    fed = RefFed(mode=mode, concurrency=6,
                 aggregation_goal=4 if mode == "sync" else 3,
                 client_lr=0.3, server_lr=0.02, client_batch_size=8,
                 staleness_cap=8, compression=compression)
    # target_perplexity 1.0 cannot be reached: every run goes 3 rounds
    run = RefRun(target_perplexity=1.0, max_rounds=3, max_hours=1e6,
                 eval_clients=4)
    return ref_api.ExperimentSpec(
        model=ref_train.reduced_model_ref(ARCH), federated=fed, run=run,
        learner="real", seq_len=16, max_client_steps=3)


def _start_from(ref_learner, params):
    """The JAX learner restarted from `params` (NumPy) at version 0."""
    ref_learner.params = {k: jnp.asarray(v) for k, v in params.items()}
    ref_learner._history = [(0, dict(params))]


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_port_experiment_matches_reference_on_smollm(mode, compression):
    ref_spec = _spec(mode, compression)
    spec = port_api.ExperimentSpec.from_json(ref_spec.to_json())
    assert spec.content_hash() == ref_spec.content_hash()
    ref_exp = ref_api.Experiment(ref_spec)
    init = _rescaled(jax.device_get(ref_exp.build_learner().params))
    _start_from(ref_exp.learner, init)
    cfg = port_api.Experiment(spec).model_config
    assert cfg.name.startswith(ARCH)
    ds = FederatedDataset(vocab_size=cfg.vocab_size, seq_len=spec.seq_len)
    learner = RealLearner(cfg, spec.federated, spec.run, ds,
                          max_client_steps=spec.max_client_steps,
                          device="cpu", init_params=init)
    got = port_api.Experiment(spec, learner=learner, device="cpu").run()
    want = ref_exp.run()
    g, w = got.summary(), want.summary()
    assert sorted(g) == sorted(w)
    for k in w:
        if k == "perplexity":
            assert math.isfinite(g[k])
            assert g[k] == pytest.approx(
                w[k], rel=1e-3 if compression == "int8" else 1e-4)
        else:
            assert g[k] == w[k], k
    assert got.rounds == 3
    assert got.log.participation() == want.log.participation()
    assert got.log.mean_staleness() == want.log.mean_staleness()


def test_train_cli_smollm_example_on_the_cpu(tmp_path, monkeypatch):
    """The reference train CLI's second example, cut to 2 rounds, on the
    reduced model with --device cpu: its JSON summary as the reference
    CLI's (perplexity within rel 1e-4), from the JAX learner's init with
    wq/wk/wv rescaled in both, and a checkpoint of every leaf, moved from
    that init."""
    args = ["--arch", ARCH, "--reduced", "--mode", "async",
            "--concurrency", "6", "--rounds", "2"]
    spec_path = tmp_path / "spec.json"
    assert train.main(args + ["--save-spec", str(spec_path)]) == 0
    ref_exp = ref_api.Experiment(ref_api.ExperimentSpec.load(str(spec_path)))
    init = _rescaled(jax.device_get(ref_exp.build_learner().params))
    _start_from(ref_exp.learner, init)
    want = ref_exp.run().summary()

    class FromInit(port_api.Experiment):
        def _make_learner(self):
            learner = super()._make_learner()
            spec = self.spec
            return RealLearner(self.model_config, spec.federated, spec.run,
                               learner.dataset,
                               max_client_steps=spec.max_client_steps,
                               device=learner.device, init_params=init)
    monkeypatch.setattr(train, "Experiment", FromInit)
    out, ckpt = tmp_path / "port.json", tmp_path / "ckpt"
    assert train.main(args + ["--device", "cpu", "--json", str(out),
                              "--ckpt", str(ckpt)]) == 0
    got = json.loads(out.read_text())
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "perplexity":
            assert got[k] == pytest.approx(want[k], rel=1e-4)
        else:
            assert got[k] == want[k], k
    tree, meta = load_checkpoint(str(ckpt))
    assert meta == {"rounds": 2, "arch": ARCH}
    assert sorted(tree["params"]) == sorted(init)
    for k, v in tree["params"].items():
        assert v.shape == init[k].shape and np.isfinite(v).all(), k
        assert not np.array_equal(v, init[k]), k


def test_spec_cli_round_trips_a_smollm_spec(tmp_path, capsys):
    """The spec CLI runs the train CLI's reduced smollm spec twice on the
    CPU (``--roundtrip-check``: the reloaded spec reproduces the summary)
    and writes the summary ``Experiment(spec).run()`` gives."""
    spec_path, out = tmp_path / "spec.json", tmp_path / "result.json"
    assert train.main(["--arch", ARCH, "--reduced", "--mode", "async",
                       "--concurrency", "6", "--rounds", "2",
                       "--save-spec", str(spec_path)]) == 0
    assert api_cli.main([str(spec_path), "--roundtrip-check", "--out",
                         str(out), "--quiet", "--device", "cpu"]) == 0
    assert "roundtrip-check OK" in capsys.readouterr().out
    spec = port_api.ExperimentSpec.load(str(spec_path))
    want = port_api.Experiment(spec, device="cpu").run().summary()
    got = json.loads(out.read_text())["summary"]
    assert got == want
    assert got["rounds"] == 2 and math.isfinite(got["perplexity"])
