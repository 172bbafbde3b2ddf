"""The arithmetic of the port's attention kernels, emulated on the CPU and
held against the JAX reference.

The CUDA kernels K3 (``swa_attention.cu``) and K4 (``decode_attention.cu``)
run only on the card. What can be checked here is the order of work they
follow, written out in torch at f32 on the same inputs (numpy normals from
a seed):

* K4 cuts each (batch, kv head)'s cache into the splits of
  ``plan_splits``, walks each split in tiles of ``TILE`` slots with an
  online softmax, and merges the splits' partials. The planner must cover
  every slot once; the emulation must match the reference's
  ``decode_attention_ref`` and its Pallas kernel within the reference's f32
  tolerance (1e-5).
* K3 multiplies on the tensor cores in 3xTF32: x = hi + lo, both rounded
  to TF32 (10 mantissa bits, to nearest, ties away from zero), and a.b ~
  hi.hi + hi.lo + lo.hi. Its tiled online softmax (64 query rows, 32-key
  tiles for f32, exp2 of log2-scaled scores) with that rounding must match
  the reference's ``attention_ref`` within 2e-5.

Run as a script, this prints the same K3 emulation's error with one TF32
pass (hi.hi only), the reason for the split:
``PYTHONPATH=src python tests/test_torch_attention_design.py``.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention.kernel import \
    decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as j_decode_ref  # noqa: E402
from repro.kernels.swa_attention.ref import \
    attention_ref as j_attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dkernel  # noqa: E402

torch.set_num_threads(2)

LOG2E = 1.4426950408889634
K3_ROWS, K3_KEYS = 64, 32          # swa_attention.cu: kBQ, kBK for f32


def _normals(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ------------------------------------------------------------------- K4
def _cover(split, n_split, start, end):
    """How often each slot in [0, end) is read by splits [s * split,
    min((s + 1) * split, end)) walked in TILE-slot tiles from start."""
    seen = np.zeros(end, np.int64)
    for s in range(n_split):
        s0, s1 = s * split, min((s + 1) * split, end)
        for t0 in range(s0, s1, dkernel.TILE):
            seen[t0:min(t0 + dkernel.TILE, s1)] += 1
    return seen[start:]


@pytest.mark.parametrize("C", [1, 17, 31, 32, 33, 100, 1088, 4096, 100_000])
def test_k4_planner_covers_every_slot_once(C):
    for B in (1, 3, 8, 64):
        for Hkv in (1, 3, 8):
            split, n_split = dkernel.plan_splits(B, C, Hkv)
            assert split % dkernel.TILE == 0 and split > 0
            assert 1 <= n_split <= dkernel.MAX_SPLITS
            assert (n_split - 1) * split < C <= n_split * split   # none empty
            assert np.all(_cover(split, n_split, 0, C) == 1)
            # valid_len cuts the splits: slots below it are read once, none
            # at or past it
            for vl in sorted({0, 1, C // 2, max(0, C - 1), C}):
                assert np.all(_cover(split, n_split, 0, vl) == 1)
    with pytest.raises(ValueError):
        dkernel.plan_splits(1, 0, 1)


def emulate_k4(q, kc, vc, vl):
    """K4's order of work in f32: q (B,Hq,D), caches (B,C,Hkv,D), vl (B,)
    ints -> (B,Hq,D)."""
    B, C, Hkv, D = kc.shape
    g = q.shape[1] // Hkv
    scale = 1.0 / math.sqrt(D)
    split, n_split = dkernel.plan_splits(B, C, Hkv)
    out = torch.zeros(B, Hkv, g, D)
    for b in range(B):
        qb = q[b].reshape(Hkv, g, D)
        kb, vb = kc[b].transpose(0, 1), vc[b].transpose(0, 1)  # (Hkv, C, D)
        parts = []
        for s in range(n_split):
            s0, s1 = s * split, min(s * split + split, int(vl[b]), C)
            m = torch.full((Hkv, g), -math.inf)
            l = torch.zeros(Hkv, g)
            acc = torch.zeros(Hkv, g, D)
            for t0 in range(s0, s1, dkernel.TILE):
                t1 = min(t0 + dkernel.TILE, s1)
                sc = torch.einsum("hgd,hjd->hgj", qb, kb[:, t0:t1]) * scale
                m_new = torch.maximum(m, sc.amax(-1))
                p = torch.exp(sc - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "hgj,hjd->hgd", p, vb[:, t0:t1])
                m = m_new
            parts.append((m, l, acc))
        if n_split == 1:
            m, l, acc = parts[0]
            out[b] = acc / l.clamp_min(1e-30)[..., None]
            continue
        M = torch.stack([p[0] for p in parts])
        L = torch.stack([p[1] for p in parts])
        A = torch.stack([p[2] for p in parts])
        mx = M.amax(0)
        w = torch.where(M == -math.inf, torch.zeros(()), torch.exp(M - mx))
        w = w / (L * w).sum(0).clamp_min(1e-30)
        out[b] = (w[..., None] * A).sum(0)
    return out.reshape(B, Hkv * g, D)


K4_CASES = [
    # B, C, Hq, Hkv, D, valid (the reference's cases, then the serving
    # shape's cache with its ragged lengths)
    (2, 128, 4, 2, 64, "full"),
    (3, 256, 8, 1, 32, "ragged"),
    (1, 64, 2, 2, 128, "one"),
    (2, 100, 9, 3, 64, "ragged"),
    (2, 1088, 9, 3, 64, "serving"),
]


@pytest.mark.parametrize("B,C,Hq,Hkv,D,valid", K4_CASES)
def test_k4_split_order_matches_jax(B, C, Hq, Hkv, D, valid):
    qn, kn, vn = _normals([(B, Hq, D), (B, C, Hkv, D), (B, C, Hkv, D)],
                          seed=C + D)
    vl = {"full": np.full(B, C), "one": np.ones(B, np.int64),
          "ragged": np.arange(B) * (C // 2) + 1,
          "serving": np.array([1025, 1088][:B])}[valid]
    got = emulate_k4(torch.tensor(qn), torch.tensor(kn), torch.tensor(vn),
                     vl).numpy()
    want = j_decode_ref(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                        jnp.asarray(vl))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    if C % 32 == 0:      # the Pallas kernel asserts C % block_c == 0
        pal = decode_attention_pallas(jnp.asarray(qn), jnp.asarray(kn),
                                      jnp.asarray(vn), jnp.asarray(vl),
                                      block_c=32, interpret=True)
        np.testing.assert_allclose(got, np.asarray(pal), atol=1e-5)


# ------------------------------------------------------------------- K3
def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero, on the bits: what ``to_tf32`` in swa_attention.cu computes."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's 3xTF32 mma: lo.hi + hi.lo + hi.hi, f32."""
    ah, bh = rna_tf32(a), rna_tf32(b)
    al, bl = rna_tf32(a - ah), rna_tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return rna_tf32(a) @ rna_tf32(b)


def emulate_k3(q, k, v, *, causal=True, window=0, mm=mm_3xtf32):
    """K3's order of work for f32 inputs: q (B,S,Hq,D), k/v (B,S,Hkv,D)
    -> (B,S,Hq,D); blocks of K3_ROWS query rows walk the K3_KEYS-key tiles
    of their band with an online softmax in log2 units."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    sl2 = (1.0 / math.sqrt(D)) * LOG2E
    qh = q.permute(0, 2, 1, 3)                          # (B, Hq, S, D)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(g, 1)  # (B, Hq, S, D)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(g, 1)
    out = torch.zeros(B, Hq, S, D)
    for q0 in range(0, S, K3_ROWS):
        rows = torch.arange(q0, min(q0 + K3_ROWS, S))
        q_last = int(rows[-1])
        lo = max(0, q0 - window + 1) if window > 0 else 0
        lo = lo // K3_KEYS * K3_KEYS
        hi = q_last + 1 if causal else S
        qs = qh[:, :, rows]
        m = torch.full((B, Hq, len(rows)), -math.inf)
        l = torch.zeros(B, Hq, len(rows))
        acc = torch.zeros(B, Hq, len(rows), D)
        for k0 in range(lo, hi, K3_KEYS):
            keys = torch.arange(k0, min(k0 + K3_KEYS, S))
            s = mm(qs, kh[:, :, keys].transpose(-1, -2)) * sl2
            ok = torch.ones(len(rows), len(keys), dtype=torch.bool)
            if causal:
                ok &= keys[None, :] <= rows[:, None]
            if window > 0:
                ok &= keys[None, :] > rows[:, None] - window
            s = s.masked_fill(~ok, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            m_use = torch.where(m_new == -math.inf, torch.zeros(()), m_new)
            corr = torch.exp2(m - m_use)
            p = torch.exp2(s - m_use[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + mm(p, vh[:, :, keys])
            m = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3)


K3_CASES = [
    # B, S, Hq, Hkv, D, window, causal: the serving shape at batch 1, then
    # windows (the reference's MQA and GQA cases) and non-causal
    (1, 1024, 9, 3, 64, 0, True),
    (1, 1024, 9, 3, 64, 200, True),
    (2, 128, 4, 1, 64, 32, True),
    (1, 256, 6, 3, 32, 96, True),
    (2, 100, 4, 4, 16, 0, False),
]


def _k3_case(B, S, Hq, Hkv, D, window, causal, mm):
    qn, kn, vn = _normals([(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)],
                          seed=S + D + window)
    got = emulate_k3(torch.tensor(qn), torch.tensor(kn), torch.tensor(vn),
                     causal=causal, window=window, mm=mm).numpy()
    want = np.asarray(j_attention_ref(jnp.asarray(qn), jnp.asarray(kn),
                                      jnp.asarray(vn), causal=causal,
                                      window=window))
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,causal", K3_CASES)
def test_k3_3xtf32_tiles_match_jax(B, S, Hq, Hkv, D, window, causal):
    assert _k3_case(B, S, Hq, Hkv, D, window, causal, mm_3xtf32) <= 2e-5


def test_rna_tf32_rounds_to_ten_mantissa_bits_ties_away():
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10                      # TF32's spacing at 1
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2e-7,
                      3.0, 0.0, 1.0 + 3 * ulp / 4])
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 3.0, 0.0, 1.0 + ulp])
    assert torch.equal(rna_tf32(x), want)
    # hi + lo holds x to about 2^-22 of its size
    y = torch.tensor(_normals([(4096,)], seed=1)[0])
    hi = rna_tf32(y)
    assert float(((hi + rna_tf32(y - hi)) - y).abs().max()) <= \
        2.0 ** -21 * float(y.abs().max())
    assert torch.equal(rna_tf32(one), one)


if __name__ == "__main__":
    for case in K3_CASES[:2]:
        e3 = _k3_case(*case, mm_3xtf32)
        e1 = _k3_case(*case, mm_1xtf32)
        print(f"K3 emulation {case}: max abs err vs attention_ref, 3xTF32 "
              f"{e3:.3g}, one TF32 pass {e1:.3g}")
