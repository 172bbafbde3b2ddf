"""The port's RWKV6 and its serving path against the JAX reference: the
rwkv6-7b config and parameter count, the init's keys, shapes and axes, the
time-mix and channel-mix pieces, and prefill / decode / greedy serving of
the reduced rwkv6-7b (``reduced(cfg, layers=2)``: d_model 256, 4 WKV heads
of 64), with the JAX model's init carried across by ``params_from_jax`` (or
the port's init carried back), on the same tokens.

Tolerance: 1e-4 of the larger of 1 and the tensor's largest entry, for
every tensor. The scale matters with this random init: the reference draws
wr/wk/wv/wg at 1/sqrt(heads), so r, k and v have standard deviations near
8 and the WKV states reach about 1,500; there the two packages' f32 sums,
taken in other orders, differ by about 3e-6 of the scale, and the logits
(up to about 4) by about 1e-5. Greedy tokens are held equal, and each
step's top-two logit gap is asserted to exceed 1e-3, so equality is not
luck.
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
from repro.models import param_shapes_and_axes  # noqa: E402
from repro_torch.configs import (get_config, model_config_from_dict,  # noqa: E402
                                 reduced)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import get_model, param_count  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_numpy  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4
ARCH = "rwkv6-7b"


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _jcfg():
    return jreduced(jget_config(ARCH), layers=2)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params) of the reduced
    rwkv6-7b, the port's params transferred from the JAX init."""
    jcfg = _jcfg()
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    jm = jget_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tm = get_model(cfg)
    return jm, jp, tm, params_from_jax(jax.device_get(jp), "cpu", cfg)


def _tokens(shape, vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(got, want):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), want,
                               atol=TOL * max(1.0, np.abs(want).max()))


def _states_close(st, jst):
    for k in ("wkv", "tm_tok", "cm_tok"):
        _close(st[k], jst[k])
    assert st["pos"] == int(jst["pos"])


def _gap(lg):
    top2 = np.sort(np.asarray(lg, np.float32), axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


def _layer(params, l, to):
    return {k.split("/", 1)[1]: to(v[l]) for k, v in params.items()
            if k.startswith("blocks/")}


def test_config_and_param_count():
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(ARCH))
    assert param_count(cfg) == cfg.param_count() == \
        jparam_count(jget_config(ARCH)) == 7_576_621_056
    assert param_count(reduced(cfg, layers=2)) == jparam_count(_jcfg())
    assert serve.serve_config(ARCH, False) == cfg
    small = serve.serve_config(ARCH, True)
    assert dataclasses.asdict(small) == dataclasses.asdict(_jcfg())


def test_init_keys_shapes_and_axes_match_jax(pair):
    jm, jp, tm, tp = pair
    params, axes = tm.init(torch.Generator().manual_seed(0))
    jshapes, jaxes = param_shapes_and_axes(jm.cfg)
    assert axes == jaxes
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in jshapes.items()}
    assert all(v.dtype == torch.float32 for v in params.values())
    again, _ = tm.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(params[k], again[k]) for k in params)
    # the reference's init kinds: zeros for mu, w0 and u, ones for norms;
    # normal at 1/sqrt(fan) elsewhere (1/sqrt(heads) for wr/wk/wv/wg)
    for k in ("blocks/mu_x", "blocks/mu_rkvwg", "blocks/w0", "blocks/u",
              "blocks/cm_mu_k", "blocks/cm_mu_r"):
        assert not params[k].any()
    for k in ("final_norm", "blocks/tm_norm", "blocks/ln_out"):
        assert bool((params[k] == 1).all())
    assert abs(float(params["blocks/wr"].std()) - 0.5) < 0.02
    # params_from_jax carries the JAX init over unchanged
    for k, v in jax.device_get(jp).items():
        assert np.array_equal(tp[k].numpy(), np.asarray(v)), k


def test_pieces_match_jax(pair):
    jm, jp, tm, tp = pair
    lp = _layer(tp, 1, lambda v: v)
    jlp = _layer(jp, 1, lambda v: v)
    rng = np.random.default_rng(0)
    B, S, d = 2, 5, tm.cfg.d_model
    x, xp = (rng.standard_normal((B, S, d)).astype(np.float32)
             for _ in range(2))
    tok = rng.standard_normal((B, d)).astype(np.float32)
    # the zero-initialised mixers and u would hide terms: give them values
    for k in ("mu_x", "mu_rkvwg", "w0", "u", "cm_mu_k", "cm_mu_r"):
        val = (rng.standard_normal(lp[k].shape) * 0.3).astype(np.float32)
        lp[k] = torch.tensor(val)
        jlp[k] = jnp.asarray(val)
    X, XP, TOK = map(torch.tensor, (x, xp, tok))
    _close(tm._ddlerp(lp, X, XP), jm._ddlerp(jlp, x, xp))
    _close(tm._decay(lp, X), jm._decay(jlp, x))
    s0 = (rng.standard_normal((B, tm.n_heads, 64, 64)) * 0.1).astype(
        np.float32)
    state = torch.tensor(s0)
    y, last, out_state = tm._time_mix(lp, X, TOK, state)
    jy, jlast, js = jm._time_mix(jlp, x, tok, jnp.asarray(s0))
    assert out_state is state
    _close(y, jy)
    _close(last, jlast)
    _close(state, js)
    y, last = tm._channel_mix(lp, X, TOK)
    jy, jlast = jm._channel_mix(jlp, x, tok)
    _close(y, jy)
    _close(last, jlast)


def test_prefill_and_decode_match_jax(pair):
    jm, jp, tm, tp = pair
    toks = _tokens((2, 12), tm.cfg.vocab_size)
    jlg, jst = jm.prefill(jp, jnp.asarray(toks), pad_to=16)
    lg, st = tm.prefill(tp, torch.tensor(toks), pad_to=16)
    _close(lg, jlg)
    _states_close(st, jst)
    assert st["pos"] == 12
    empty, axes = tm.init_cache(2, 16, dtype=torch.float32)
    jempty, jaxes = jm.init_cache(2, 16, dtype=jnp.float32)
    assert axes == jaxes and empty["pos"] == int(jempty["pos"]) == 0
    for k in ("wkv", "tm_tok", "cm_tok"):
        assert tuple(empty[k].shape) == jempty[k].shape
        assert empty[k].dtype == torch.float32 and not empty[k].any()
    assert tm.init_cache(2, 16)[0]["tm_tok"].dtype == torch.bfloat16
    step = jax.jit(jm.decode_step)
    for _ in range(4):
        assert _gap(jlg) > 1e-3
        nxt = np.asarray(jnp.argmax(jlg, axis=-1)).astype(np.int32)
        assert np.array_equal(torch.argmax(lg, -1).numpy(), nxt)
        jlg, jst = step(jp, jst, jnp.asarray(nxt))
        lg, out = tm.decode_step(tp, st, torch.tensor(nxt))
        assert out is st
        _close(lg, jlg)
        _states_close(st, jst)


def test_prefill_plus_decode_equals_full_forward(pair):
    """The reference's own check (tests/test_models.py): prefill(t[:-1]) +
    decode(t[-1]) logits equal the full forward's last-position logits;
    here also the carried states equal the full prompt's."""
    jm, jp, tm, tp = pair
    toks = torch.tensor(_tokens((2, 12), tm.cfg.vocab_size, seed=5))
    states, _ = tm._zero_states(2, torch.float32)
    x, states = tm._stack(tp, tp["embed"][toks.long()], states)
    full = tm.logits(tp, x[:, -1:, :])[:, 0]
    _, cache = tm.prefill(tp, toks[:, :-1], pad_to=16)
    dec, cache = tm.decode_step(tp, cache, toks[:, -1])
    _close(dec, _np(full))
    for k in ("wkv", "tm_tok", "cm_tok"):
        _close(cache[k], _np(states[k]))
    jst, _ = jm._zero_states(2, jnp.float32)
    jx, _ = jm._stack(jp, jp["embed"][jnp.asarray(toks.numpy())], jst)
    jx = jcm.rms_norm(jx[:, -1:], jp["final_norm"])
    _close(full, jnp.einsum("bsd,dv->bsv", jx, jp["unembed"])[:, 0])


def test_serve_greedy_tokens_match_jax():
    """The slice as a whole: the port's serve.run on the CPU and a JAX
    greedy loop over the same (port-drawn) weights and prompts give the
    same tokens."""
    res = serve.run(ARCH, reduced=True, batch=3, prompt_len=10, gen=6,
                    device="cpu", seed=7)
    cfg = res.config
    assert cfg.family == "ssm" and tuple(res.tokens.shape) == (3, 6)
    # the same draws as run(): params first, then the prompts
    g = torch.Generator().manual_seed(7)
    tp, _ = get_model(cfg).init(g)
    toks = torch.randint(0, cfg.vocab_size, (3, 10), generator=g)
    jm = jget_model(_jcfg())
    jp = {k: jnp.asarray(v) for k, v in params_to_numpy(tp).items()}
    jlg, jst = jm.prefill(jp, jnp.asarray(toks.numpy()), pad_to=16)
    step = jax.jit(jm.decode_step)
    out = []
    for _ in range(6):
        assert _gap(jlg) > 1e-3
        nxt = jnp.argmax(jlg, axis=-1).astype(jnp.int32)
        out.append(np.asarray(nxt))
        jlg, jst = step(jp, jst, nxt)
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(out, 1))
    _close(res.logits, jlg)


def test_serve_cli_runs_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"[serve] {ARCH}-reduced")
    assert "decoded 3 tokens/seq" in out[1]


def test_training_is_not_ported_yet(pair):
    _, _, tm, tp = pair
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tm.loss(tp, {"tokens": torch.zeros((1, 4), dtype=torch.long)})


def test_model_uses_the_wkv_op(pair, monkeypatch):
    """Every layer's recurrence, in prefill and in each decode step, goes
    through ops.wkv (K5 on the card) with f32 inputs and the layer's state
    updated in place."""
    from repro_torch.kernels.wkv import ops as wops
    _, _, tm, tp = pair
    calls = []
    real = wops.wkv

    def spy(r, k, v, w, u, state):
        calls.append((r.shape, r.dtype, w.dtype, u.dtype,
                      state.data_ptr()))
        return real(r, k, v, w, u, state)

    monkeypatch.setattr(wops, "wkv", spy)
    toks = torch.tensor(_tokens((2, 7), tm.cfg.vocab_size, seed=9))
    _, cache = tm.prefill(tp, toks)
    L = tm.cfg.num_layers
    ptrs = [cache["wkv"][l].data_ptr() for l in range(L)]
    tm.decode_step(tp, cache, toks[:, -1])
    tm.decode_step(tp, cache, toks[:, -2])
    assert len(calls) == 3 * L
    assert [c[0][1] for c in calls] == [7] * L + [1] * 2 * L
    assert all(c[1] == c[2] == c[3] == torch.float32 for c in calls)
    assert [c[4] for c in calls] == ptrs * 3


def test_profile_serve_names_k5_and_needs_a_card():
    from repro_torch.launch import profile_serve
    name = ("void (anonymous namespace)::wkv_fwd_kernel<float, 64>(float "
            "const*, float const*, float const*, float const*, float "
            "const*, float*, float*, int, int, (anonymous namespace)::"
            "Strides)")
    assert profile_serve._serve_kind(name) == "WKV (K5)"
    assert profile_serve._serve_kind("decode_partial_kernel") == \
        "decode attention (K4)"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_serve.main(["--arch", ARCH])
