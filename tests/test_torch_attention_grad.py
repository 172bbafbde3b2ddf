"""The gradient of the port's flash attention (K3's backward) against the
JAX reference and against torch autograd, on the CPU.

* ``ref.attention_bwd_ref`` (the plain version of the backward kernels,
  written out from the formulas) against ``torch.autograd`` through
  ``ref.attention_ref`` and against ``jax.vjp`` through the reference's
  ``repro.models.common.flash_attention`` (which the JAX models
  differentiate; the TPU kernel has no backward), on the same NumPy inputs:
  causal, sliding window, non-causal, GQA, a ragged S, D 16/32/64.
  Tolerance 2e-5 times max(1, the reference's largest entry), f32: the
  reference's flash-attention tolerance, scaled to the gradient's size.
* ``ref.attention_fwd_ref``: o bit-equal to ``attention_ref`` (the eval
  path's), and lse the log-sum-exp of the masked scaled scores.
* The ``torch.autograd.Function`` (``swa_attention/autograd.py``) under
  ``torch.func.vmap(torch.func.grad_and_value(...))``, as the learner's
  cohort step takes it, against a per-client loop; each of its two vmap
  rules runs once a call, folding the cohort into one launch.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import common as jcm  # noqa: E402
from repro_torch.kernels.swa_attention import autograd as agrad  # noqa: E402
from repro_torch.kernels.swa_attention import kernel as akernel  # noqa: E402
from repro_torch.kernels.swa_attention import ref as aref  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402

torch.set_num_threads(2)

TOL = 2e-5
# B, S, Hq, Hkv, D, window, causal
CASES = {
    "causal": (2, 64, 4, 4, 32, 0, True),
    "window": (2, 64, 4, 2, 64, 16, True),
    "non_causal": (2, 48, 4, 2, 16, 0, False),
    "gqa": (1, 40, 6, 2, 32, 0, True),
    "ragged_s": (2, 37, 4, 2, 16, 0, True),
    "window_non_causal": (1, 33, 4, 1, 64, 8, False),
}


def _inputs(case, seed=0):
    B, S, Hq, Hkv, D, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                      (B, S, Hq, D))]


def _assert_close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


@pytest.mark.parametrize("name", CASES)
def test_bwd_ref_matches_autograd_and_jax(name):
    B, S, Hq, Hkv, D, window, causal = CASES[name]
    qn, kn, vn, don = _inputs(CASES[name])
    q, k, v, do = (torch.tensor(a) for a in (qn, kn, vn, don))
    o, lse = aref.attention_fwd_ref(q, k, v, causal=causal, window=window)
    assert torch.equal(o, aref.attention_ref(q, k, v, causal=causal,
                                             window=window))
    dq, dk, dv = aref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        aref.attention_ref(*leaves, causal=causal, window=window), leaves, do)
    for got, w, n in zip((dq, dk, dv), want, "qkv"):
        _assert_close(got, w.numpy(), what=f"d{n} vs torch autograd")

    out, vjp = jax.vjp(lambda a, b, c: jcm.flash_attention(
        a, b, c, causal=causal, window=window), jnp.asarray(qn),
        jnp.asarray(kn), jnp.asarray(vn))
    _assert_close(o, out, what="o vs JAX")
    for got, w, n in zip((dq, dk, dv), vjp(jnp.asarray(don)), "qkv"):
        _assert_close(got, w, what=f"d{n} vs jax.vjp")


@pytest.mark.parametrize("name", CASES)
def test_lse_is_the_log_sum_exp_of_the_masked_scores(name):
    B, S, Hq, Hkv, D, window, causal = CASES[name]
    qn, kn, _, _ = _inputs(CASES[name], seed=1)
    g = Hq // Hkv
    s = np.einsum("bqhd,bkhd->bhqk", qn.astype(np.float64),
                  np.repeat(kn, g, axis=2).astype(np.float64)) / math.sqrt(D)
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    mask = np.ones((S, S), bool)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    s = np.where(mask, s, -np.inf)
    top = s.max(axis=-1, keepdims=True)
    want = (top + np.log(np.exp(s - top).sum(-1, keepdims=True)))[..., 0]
    _, lse = aref.attention_fwd_ref(torch.tensor(qn), torch.tensor(kn),
                                    torch.tensor(kn), causal=causal,
                                    window=window)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, S)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)


def _count_vmap_rules(monkeypatch):
    calls = {"forward": 0, "backward": 0}
    for cls, key in ((agrad._Attention, "forward"),
                     (agrad._AttentionBwd, "backward")):
        rule = cls.vmap

        def counted(*a, _rule=rule, _key=key):
            calls[_key] += 1
            return _rule(*a)
        monkeypatch.setattr(cls, "vmap", staticmethod(counted))
    return calls


@pytest.mark.parametrize("name", ["window", "gqa", "ragged_s"])
def test_function_under_vmap_of_grad_matches_a_per_client_loop(
        name, monkeypatch):
    """The cohort step's form: vmap over N clients of grad_and_value of a
    loss through the Function, with an unbatched weight: one call of each
    vmap rule for the whole cohort, and each client's gradient and loss as
    a per-client loop gives them (plain torch autograd through
    ``attention_ref``)."""
    B, S, Hq, Hkv, D, window, causal = CASES[name]
    N = 3
    rng = np.random.default_rng(2)
    qkv = {n: torch.tensor(rng.standard_normal((N, B, S, h, D)),
                           dtype=torch.float32)
           for n, h in (("q", Hq), ("k", Hkv), ("v", Hkv))}
    w = torch.tensor(rng.standard_normal((B, S, Hq, D)), dtype=torch.float32)
    calls = _count_vmap_rules(monkeypatch)

    def loss(p):
        o = tcm.flash_attention(p["q"], p["k"], p["v"], causal=causal,
                                window=window)
        return (torch.tanh(o) * w).sum()

    grads, losses = torch.func.vmap(torch.func.grad_and_value(loss))(qkv)
    assert calls == {"forward": 1, "backward": 1}
    for i in range(N):
        leaves = [qkv[n][i].clone().requires_grad_() for n in "qkv"]
        o = aref.attention_ref(*leaves, causal=causal, window=window)
        ref_loss = (torch.tanh(o) * w).sum()
        want = torch.autograd.grad(ref_loss, leaves)
        assert float(losses[i]) == pytest.approx(float(ref_loss.detach()),
                                                 rel=1e-6)
        for n, wt in zip("qkv", want):
            _assert_close(grads[n][i], wt.numpy(), what=f"client {i} d{n}")


def test_flash_attention_takes_the_function_only_for_a_gradient():
    """With an input that requires a gradient, ``common.flash_attention``
    differentiates through the Function (its backward is the plain
    backward on the CPU); under ``torch.no_grad()`` it is the forward
    alone, as serving and eval take it; the Function's second derivative
    raises."""
    qn, kn, vn, don = _inputs(CASES["gqa"], seed=3)
    q, k, v = (torch.tensor(a).requires_grad_() for a in (qn, kn, vn))
    o = tcm.flash_attention(q, k, v)
    assert o.grad_fn is not None and "_Attention" in type(o.grad_fn).__name__
    with torch.no_grad():
        assert torch.equal(tcm.flash_attention(q, k, v), o.detach())
    g = torch.autograd.grad(o, (q, k, v), torch.tensor(don),
                            create_graph=True)
    want = aref.attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                  *aref.attention_fwd_ref(q.detach(),
                                                          k.detach(),
                                                          v.detach()),
                                  torch.tensor(don))
    for got, w in zip(g, want):
        assert torch.equal(got.detach(), w)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        torch.autograd.grad(g[0].sum(), q)


def test_backward_wrappers_refuse_what_they_cannot_run():
    """The kernel wrappers take CUDA tensors only, and the backward f32
    only ("not ported yet" in bf16); nothing is launched or counted."""
    akernel.reset_launches()
    q = torch.zeros(1, 8, 2, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        akernel.attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        akernel.attention_bwd(q, q, q, q, lse, q)
    qb = q.bfloat16()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        akernel.attention_bwd(qb, qb, qb, qb, lse, qb)
    assert set(akernel.LAUNCHES.values()) == {0}
