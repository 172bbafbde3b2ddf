"""The port's dense transformer and serving path against the JAX reference:
the shared layers, the smollm-135m config, and prefill / decode / greedy
serving of the reduced smollm-135m (``reduced(cfg, layers=2)``), with the
JAX model's init carried across by ``params_from_jax`` (or the port's init
carried back), on the same tokens.

Tolerances: the layers at 1e-6 (f32 elementwise work). Model logits and
caches at 1e-4 of the larger of 1 and the tensor's largest entry (two
layers of f32 matrix products summed in another order). The scale matters
with this random init: cache entries reach about 45, and one layer's f32
rounding alone puts each package 2e-4 to 4e-4 from a float64 run of the
same layer; the logits (up to about 4) of the fourth decode step lie 9e-5
(port) and 1.1e-4 (JAX) from a float64 run. Greedy tokens are held equal,
and each step's top-two logit gap is asserted to exceed 1e-3, so equality
is not luck.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import param_count as jparam_count  # noqa: E402
from repro_torch.configs import (get_config, model_config_from_dict,  # noqa: E402
                                 reduced)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import get_model, param_count  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_numpy  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _pair(decode_window=0, seed=0):
    """(JAX model, JAX params, port model, port params) of the reduced
    smollm-135m, the port's params transferred from the JAX init."""
    jcfg = jreduced(jget_config("smollm-135m"), layers=2)
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    jm = jget_model(jcfg, decode_window=decode_window)
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    tm = get_model(cfg, decode_window=decode_window)
    return jm, jp, tm, params_from_jax(jax.device_get(jp), "cpu", cfg)


def _tokens(shape, vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(got, want):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), want,
                               atol=TOL * max(1.0, np.abs(want).max()))


def _cache_close(cache, jcache):
    for k in ("k", "v"):
        _close(cache[k], jcache[k])


def _gap(lg):
    top2 = np.sort(np.asarray(lg, np.float32), axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    gamma = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        _np(tcm.rms_norm(torch.tensor(x), torch.tensor(gamma))),
        jcm.rms_norm(jnp.asarray(x), jnp.asarray(gamma)), atol=1e-6)
    pos = np.arange(7, 12)
    cos, sin = tcm.rope_angles(torch.tensor(pos), 64, 10000.0)
    jcos, jsin = jcm.rope_angles(jnp.asarray(pos), 64, 10000.0)
    np.testing.assert_allclose(_np(cos), jcos, atol=1e-6)
    np.testing.assert_allclose(_np(sin), jsin, atol=1e-6)
    np.testing.assert_allclose(
        _np(tcm.apply_rope(torch.tensor(x), cos, sin)),
        jcm.apply_rope(jnp.asarray(x), jcos, jsin), atol=1e-6)
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) / 8
         for s in ((32, 48), (32, 48), (48, 32))]
    np.testing.assert_allclose(
        _np(tcm.swiglu(torch.tensor(h), *map(torch.tensor, w))),
        jcm.swiglu(jnp.asarray(h), *map(jnp.asarray, w)), atol=1e-6)
    np.testing.assert_allclose(_np(tcm.swish(torch.tensor(h))),
                               jcm.swish(jnp.asarray(h)), atol=1e-6)


def test_smollm_config_and_param_count():
    cfg = get_config("smollm-135m")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jget_config("smollm-135m"))
    assert param_count(cfg) == jparam_count(jget_config("smollm-135m")) \
        == 134_515_008
    small = reduced(cfg, layers=2)
    assert param_count(small) == jparam_count(jreduced(
        jget_config("smollm-135m"), layers=2))


def test_prefill_and_decode_match_jax():
    jm, jp, tm, tp = _pair()
    toks = _tokens((2, 12), tm.cfg.vocab_size)
    jlg, jcache = jm.prefill(jp, jnp.asarray(toks), pad_to=16)
    lg, cache = tm.prefill(tp, torch.tensor(toks), pad_to=16)
    _close(lg, jlg)
    _cache_close(cache, jcache)
    assert cache["pos"] == int(jcache["pos"]) == 12
    empty, axes = tm.init_cache(2, 16, dtype=torch.float32)
    jempty, jaxes = jm.init_cache(2, 16, dtype=jnp.float32)
    assert axes == jaxes and empty["pos"] == int(jempty["pos"]) == 0
    for k in ("k", "v"):
        assert tuple(empty[k].shape) == jempty[k].shape
        assert not empty[k].any()
    step = jax.jit(jm.decode_step)
    for _ in range(4):
        assert _gap(jlg) > 1e-3
        nxt = np.asarray(jnp.argmax(jlg, axis=-1)).astype(np.int32)
        assert np.array_equal(torch.argmax(lg, -1).numpy(), nxt)
        jlg, jcache = step(jp, jcache, jnp.asarray(nxt))
        lg, cache = tm.decode_step(tp, cache, torch.tensor(nxt))
        _close(lg, jlg)
        _cache_close(cache, jcache)
        assert cache["pos"] == int(jcache["pos"])


def test_ring_buffer_decode_matches_jax():
    """decode_window: prefill keeps the last 8 positions, decode writes the
    ring at pos % C."""
    jm, jp, tm, tp = _pair(decode_window=8, seed=1)
    toks = _tokens((2, 12), tm.cfg.vocab_size, seed=4)
    jlg, jcache = jm.prefill(jp, jnp.asarray(toks))
    lg, cache = tm.prefill(tp, torch.tensor(toks))
    assert cache["k"].shape[2] == jcache["k"].shape[2] == 8
    _close(lg, jlg)
    for i in range(10):
        nxt = _tokens((2,), tm.cfg.vocab_size, seed=10 + i)
        jlg, jcache = jm.decode_step(jp, jcache, jnp.asarray(nxt))
        lg, cache = tm.decode_step(tp, cache, torch.tensor(nxt))
        _close(lg, jlg)
        _cache_close(cache, jcache)


def test_prefill_plus_decode_equals_full_forward():
    """The reference's own check (tests/test_models.py): prefill(t[:-1]) +
    decode(t[-1]) logits equal the full forward's last-position logits."""
    jm, jp, tm, tp = _pair(seed=2)
    toks = torch.tensor(_tokens((2, 12), tm.cfg.vocab_size, seed=5))
    x = tm._stack(tp, tm._embed(tp, toks))
    full = tm.logits(tp, x[:, -1:, :])[:, 0]
    _, cache = tm.prefill(tp, toks[:, :-1], pad_to=16)
    dec, _ = tm.decode_step(tp, cache, toks[:, -1])
    _close(dec, _np(full))
    jx, _, _ = jm._stack(jp, jm._embed(jp, jnp.asarray(toks.numpy())))
    _close(full, jm.logits(jp, jx[:, -1:, :])[:, 0])


def test_serve_greedy_tokens_match_jax():
    """The slice as a whole: the port's serve.run on the CPU and a JAX
    greedy loop over the same (port-drawn) weights and prompts give the
    same tokens."""
    res = serve.run("smollm-135m", reduced=True, batch=3, prompt_len=10,
                    gen=6, device="cpu", seed=7)
    cfg = res.config
    assert tuple(res.tokens.shape) == (3, 6)
    # the same draws as run(): params first, then the prompts
    g = torch.Generator().manual_seed(7)
    tp, _ = get_model(cfg).init(g)
    toks = torch.randint(0, cfg.vocab_size, (3, 10), generator=g)
    jcfg = jreduced(jget_config("smollm-135m"), layers=2)
    jm = jget_model(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params_to_numpy(tp).items()}
    jlg, jcache = jm.prefill(jp, jnp.asarray(toks.numpy()), pad_to=16)
    out = []
    for _ in range(6):
        assert _gap(jlg) > 1e-3
        nxt = jnp.argmax(jlg, axis=-1).astype(jnp.int32)
        out.append(np.asarray(nxt))
        jlg, jcache = jm.decode_step(jp, jcache, nxt)
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(out, 1))
    _close(res.logits, jlg)


@pytest.mark.parametrize("arch", ["smollm-135m", "paper-charlm"])
def test_serve_cli_runs_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"[serve] {arch}-reduced")
    assert "decoded 3 tokens/seq" in out[1]


def test_serve_flags(monkeypatch):
    """--reduced defaults to on (as in the reference) and --no-reduced
    reaches the full width."""
    seen = {}

    def fake_run(arch, **kw):
        seen.update(kw, arch=arch)
        raise SystemExit(0)

    monkeypatch.setattr(serve, "run", fake_run)
    for argv, want in (([], True), (["--no-reduced"], False),
                       (["--reduced"], True)):
        with pytest.raises(SystemExit):
            serve.main(argv + ["--seed", "3"])
        assert seen["reduced"] is want and seen["seed"] == 3
        assert seen["device"] == "cuda" and seen["arch"] == "smollm-135m"
    assert serve.serve_config("smollm-135m", False) == get_config(
        "smollm-135m")


def test_serve_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run("smollm-135m", device="cuda")


def test_unported_parts_raise():
    moe = model_config_from_dict(dataclasses.asdict(
        jreduced(jget_config("mixtral-8x22b"))))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        get_model(moe)
    _, _, tm, tp = _pair()
    _, cache = tm.prefill(tp, torch.zeros((1, 4), dtype=torch.long),
                          pad_to=8)
    tm.kv_quant = True
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tm.decode_step(tp, cache, torch.zeros(1, dtype=torch.long))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tm.init_cache(1, 8)
