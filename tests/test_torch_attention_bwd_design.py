"""The order of work of the port's attention backward kernels, emulated on
the CPU and held against the JAX reference's gradient.

The CUDA kernels ``swa_attention_bwd_dq`` and ``swa_attention_bwd_dkdv``
(``swa_attention_bwd.cu``) run only on the card. What can be checked here
is the order of work they follow, written out in torch at f32 on the same
inputs (numpy normals from a seed), with P recomputed from the lse that
``attention_fwd_ref`` gives:

* every product in 3xTF32 (x = hi + lo, both rounded to TF32, and a.b ~
  lo.hi + hi.lo + hi.hi; ``rna_tf32`` / ``mm_3xtf32`` of
  ``test_torch_attention_design.py``);
* dQ: blocks of ``OWN`` query rows walk the ``WALK``-key tiles of their
  band in order, recomputing S and dP, and add dS K tile by tile; delta
  is each row's sum of dO o over float4 lanes, then a butterfly over the
  lanes;
* dK/dV: a cluster of ``cluster_size(g)`` blocks shares ``OWN`` keys;
  the block of rank r walks the group's query heads r, r + C, ... and,
  for each, the ``WALK``-query tiles of their band, in that order,
  recomputing S^T and dP^T, and adds P^T dO and dS^T Q tile by tile; the
  ranks' partial dK and dV are then summed in rank order.

dq, dk and dv must match ``jax.vjp`` through the reference's
``repro.models.common.flash_attention`` within 2e-5 times max(1, the
reference's largest entry): the tolerance the plain backward is held to
(``test_torch_attention_grad.py``).

Run as a script, this prints the same emulation's error with one TF32
pass (hi.hi only), the reason for the split:
``PYTHONPATH=src python tests/test_torch_attention_bwd_design.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import common as jcm  # noqa: E402
from repro_torch.kernels.swa_attention import ref as aref  # noqa: E402
from test_torch_attention_design import (mm_1xtf32, mm_3xtf32,  # noqa: E402
                                         rna_tf32)

torch.set_num_threads(2)

LOG2E = 1.4426950408889634
OWN, WALK = 64, 32          # swa_attention_bwd.cu: kBR, kBT
TOL = 2e-5


def cluster_size(g):
    """The dK/dV kernel's cluster: the largest divisor of the group size g
    up to 8."""
    return max(c for c in range(1, 9) if g % c == 0)


def _visible(rows, keys, S, causal, window):
    ok = (rows[:, None] < S) & (keys[None, :] < S)
    if causal:
        ok &= keys[None, :] <= rows[:, None]
    if window > 0:
        ok &= keys[None, :] > rows[:, None] - window
    return ok


def _delta(do, o):
    """sum over D of do * o, (..., D) -> (...): a float4 a lane, then a
    butterfly over the D / 4 lanes of a row."""
    D = do.shape[-1]
    x = (do * o).reshape(*do.shape[:-1], D // 4, 4)
    part = ((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]
    lane = torch.arange(D // 4)
    m = 1
    while m < D // 4:
        part = part + part[..., lane ^ m]
        m <<= 1
    return part[..., 0]


def emulate_dq(q, k, v, o, lse, do, *, causal, window, mm=mm_3xtf32):
    """The dQ kernel's order of work: q, o, do (B,S,Hq,D), k/v (B,S,Hkv,D),
    lse (B,Hq,S) -> (dq (B,S,Hq,D), delta (B,Hq,S))."""
    B, S, Hq, D = q.shape
    g = Hq // k.shape[2]
    sl2 = LOG2E / math.sqrt(D)
    qh, oh, doh = (x.permute(0, 2, 1, 3) for x in (q, o, do))
    kh, vh = (x.permute(0, 2, 1, 3).repeat_interleave(g, 1) for x in (k, v))
    delta = _delta(doh, oh)                              # (B, Hq, S)
    lse2 = lse * LOG2E
    dq = torch.zeros(B, Hq, S, D)
    for q0 in range(0, S, OWN):
        rows = torch.arange(q0, min(q0 + OWN, S))
        lo = max(0, q0 - window + 1) // WALK * WALK if window > 0 else 0
        hi = min(q0 + OWN, S) if causal else S
        acc = torch.zeros(B, Hq, len(rows), D)
        for k0 in range(lo, hi, WALK):
            keys = torch.arange(k0, min(k0 + WALK, S))
            kt, vt = kh[:, :, keys], vh[:, :, keys]
            s = mm(qh[:, :, rows], kt.transpose(-1, -2))
            dp = mm(doh[:, :, rows], vt.transpose(-1, -2))
            p = torch.exp2(s * sl2 - lse2[:, :, rows, None])
            p = p.masked_fill(~_visible(rows, keys, S, causal, window), 0.0)
            ds = p * (dp - delta[:, :, rows, None])
            acc = acc + mm(ds, kt)
        dq[:, :, rows] = acc * (1.0 / math.sqrt(D))
    return dq.permute(0, 2, 1, 3), delta


def emulate_dkdv(q, k, v, lse, do, delta, *, causal, window, mm=mm_3xtf32):
    """The dK/dV kernel's order of work, with the dQ kernel's delta ->
    (dk, dv) (B,S,Hkv,D), summed over each group's heads: by rank, then
    over the ranks in order."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    C = cluster_size(g)
    sl2 = LOG2E / math.sqrt(D)
    qh, doh = (x.permute(0, 2, 1, 3).reshape(B, Hkv, g, S, D)
               for x in (q, do))
    kh, vh = (x.permute(0, 2, 1, 3) for x in (k, v))     # (B, Hkv, S, D)
    lse2 = (lse * LOG2E).reshape(B, Hkv, g, S)
    delta = delta.reshape(B, Hkv, g, S)
    dk, dv = torch.zeros(B, Hkv, S, D), torch.zeros(B, Hkv, S, D)
    for k0 in range(0, S, OWN):
        keys = torch.arange(k0, min(k0 + OWN, S))
        lo = k0 if causal else 0
        hi = min(S, k0 + OWN - 1 + window) if window > 0 else S
        kb, vb = kh[:, :, keys], vh[:, :, keys]
        parts = []
        for rank in range(C):
            dka = torch.zeros(B, Hkv, len(keys), D)
            dva = torch.zeros(B, Hkv, len(keys), D)
            for hg in range(rank, g, C):
                for q0 in range(lo, hi, WALK):
                    rows = torch.arange(q0, min(q0 + WALK, S))
                    qt, dot = qh[:, :, hg, rows], doh[:, :, hg, rows]
                    st = mm(kb, qt.transpose(-1, -2))    # (.., keys, rows)
                    dpt = mm(vb, dot.transpose(-1, -2))
                    pt = torch.exp2(st * sl2 - lse2[:, :, hg, None, rows])
                    pt = pt.masked_fill(
                        ~_visible(rows, keys, S, causal, window).T, 0.0)
                    dst = pt * (dpt - delta[:, :, hg, None, rows])
                    dva = dva + mm(pt, dot)
                    dka = dka + mm(dst, qt)
            parts.append((dka, dva))
        dka, dva = parts[0]
        for pk, pv in parts[1:]:
            dka, dva = dka + pk, dva + pv
        dk[:, :, keys] = dka * (1.0 / math.sqrt(D))
        dv[:, :, keys] = dva
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


CASES = {
    # B, S, Hq, Hkv, D, window, causal: the sync training shape at B 2, the
    # serving length at B 1, a window, a group of 9 (3 heads a rank),
    # non-causal, a ragged S, D 16/32/128
    "training": (2, 64, 9, 3, 64, 0, True),
    "serving_length": (1, 1024, 9, 3, 64, 0, True),
    "window": (2, 160, 4, 2, 32, 40, True),
    "group_of_9": (1, 96, 9, 1, 32, 0, True),
    "non_causal": (2, 80, 4, 1, 16, 0, False),
    "ragged_s": (2, 37, 4, 2, 64, 0, True),
    "d128_window_non_causal": (1, 100, 2, 1, 128, 24, False),
}


def _errors(name, mm):
    """max |emulated - jax.vjp| / max(1, max |jax.vjp|) of dq, dk, dv."""
    B, S, Hq, Hkv, D, window, causal = CASES[name]
    rng = np.random.default_rng(S + D + window)
    qn, kn, vn, don = (rng.standard_normal(s).astype(np.float32)
                       for s in ((B, S, Hq, D), (B, S, Hkv, D),
                                 (B, S, Hkv, D), (B, S, Hq, D)))
    q, k, v, do = (torch.tensor(a) for a in (qn, kn, vn, don))
    o, lse = aref.attention_fwd_ref(q, k, v, causal=causal, window=window)
    dq, delta = emulate_dq(q, k, v, o, lse, do, causal=causal, window=window,
                           mm=mm)
    dk, dv = emulate_dkdv(q, k, v, lse, do, delta, causal=causal,
                          window=window, mm=mm)
    _, vjp = jax.vjp(lambda a, b, c: jcm.flash_attention(
        a, b, c, causal=causal, window=window), jnp.asarray(qn),
        jnp.asarray(kn), jnp.asarray(vn))
    out = {}
    for n, got, want in zip("qkv", (dq, dk, dv), vjp(jnp.asarray(don))):
        want = np.asarray(want)
        out[f"d{n}"] = float(np.abs(got.numpy() - want).max()) / \
            max(1.0, float(np.abs(want).max()))
    return out


@pytest.mark.parametrize("name", CASES)
def test_bwd_3xtf32_tiles_match_jax_vjp(name):
    errs = _errors(name, mm_3xtf32)
    assert all(e <= TOL for e in errs.values()), errs


def test_cluster_size_divides_the_group():
    assert [cluster_size(g) for g in (1, 2, 3, 4, 6, 8, 9, 12, 16)] == \
        [1, 2, 3, 4, 6, 8, 3, 6, 8]


def test_delta_butterfly_is_the_row_sum():
    x, y = (torch.tensor(a) for a in np.random.default_rng(3).standard_normal(
        (2, 5, 64)).astype(np.float32))
    np.testing.assert_allclose(_delta(x, y).numpy(), (x * y).sum(-1).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(rna_tf32(torch.tensor([1.0])), torch.tensor([1.0]))


if __name__ == "__main__":
    for case in ("training", "serving_length"):
        e3, e1 = _errors(case, mm_3xtf32), _errors(case, mm_1xtf32)
        print(f"K3 backward emulation {case} {CASES[case]}: max err / "
              f"max(1, |ref|) vs jax.vjp, 3xTF32 {e3}, one TF32 pass {e1}")
