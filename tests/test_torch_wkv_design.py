"""The order of work of the port's WKV kernel K5 (``wkv.cu``), emulated on
the CPU and held against the JAX reference.

K5 runs only on the card. What can be checked here is the order in which
it sums, written out in torch on the same inputs (numpy draws from a seed):

* a_t = sum_i r_t[i] u[i] k_t[i]: D / 4 lanes a step, lane c summing the
  4 rows of chunk c with fmaf(r * u, k, x), then a butterfly of xor
  shuffles (D / 8, ..., 2, 1) adds the lanes' sums.
* o_t[j]: the D rows of a column split over R = 4 threads, group g
  holding the 4-row chunks g, g + 4, g + 8, ...; each thread sums its rows
  in two partial sums (rows 0 and 2 of each chunk, rows 1 and 3) and adds
  them; after the tile the block adds the groups' partials as
  ((g0 + g1) + (g2 + g3)); then o = fmaf(a_t, v_t[j], sum).
* S <- fmaf(w_t[i], S, k_t[i] * v_t[j]).

An fma is emulated by a product and sum in f64 rounded once to f32. The
emulation must match the reference's ``wkv_ref`` and its Pallas kernel in
interpret mode within the reference's tolerances (f32 3e-5, bf16 3e-2) at
its test cases, and ``wkv_ref`` within 3e-5 of the tensors' scale at one
model-scale panel (T 1024, D 64, r/k/v at standard deviation 8). The
layout of threads over the state that the source documents is checked for
coverage and shared-memory banks.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.wkv.kernel import wkv_pallas  # noqa: E402
from repro.kernels.wkv.ref import wkv_ref as j_wkv_ref  # noqa: E402
from repro_torch.kernels._build import DTYPES, HEAD_DIMS  # noqa: E402
from repro_torch.kernels.wkv import ref as wref  # noqa: E402

torch.set_num_threads(2)

# wkv.cu's layout: kR row groups, kC state columns a thread, 2 D threads
R = 4
C = 2
# BH, T, D, chunk: the reference's kernel test cases
CASES = [(1, 32, 16, 16), (2, 64, 32, 32), (3, 128, 64, 64), (2, 96, 32, 32)]


def fma(a, b, c):
    """fmaf in f32: the exact product and sum in f64, rounded to f32."""
    return (a.double() * b.double() + c.double()).float()


def butterfly(x):
    """The xor-shuffle butterfly over the last dimension (a power of 2 of
    lanes): every lane ends with the same sum."""
    n = x.shape[-1]
    lanes = torch.arange(n)
    off = n // 2
    while off:
        x = x + x[..., lanes ^ off]
        off //= 2
    return x[..., 0]


def emulate_k5(r, k, v, w, u, s0):
    """K5's order of work: r, k, v, w (P, T, D) f32 (bf16 values already
    widened), u (P, D), s0 (P, D, D) -> (o (P, T, D), S_T (P, D, D))."""
    P, T, D = r.shape
    S = s0.clone().reshape(P, D // (4 * R), R, 4, D)     # [m, g, e, j]
    ru = (r * u[:, None]).reshape(P, T, D // 4, 4)        # [t, chunk, e]
    k4 = k.reshape(P, T, D // 4, 4)
    outs = []
    for t in range(T):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        x = torch.zeros(P, D // 4)                        # a lane a chunk
        for e in range(4):
            x = fma(ru[:, t, :, e], k4[:, t, :, e], x)
        a = butterfly(x)                                  # (P,)
        r4 = rt.reshape(P, D // (4 * R), R, 4, 1)
        acc = torch.zeros(P, R, 2, D)                     # [g, e % 2, j]
        for m in range(D // (4 * R)):
            for e in range(4):
                acc[:, :, e % 2] = fma(r4[:, m, :, e], S[:, m, :, e],
                                       acc[:, :, e % 2])
        part = acc[:, :, 0] + acc[:, :, 1]
        total = (part[:, 0] + part[:, 1]) + (part[:, 2] + part[:, 3])
        outs.append(fma(a[:, None], vt, total))
        kv = kt.reshape(P, D // (4 * R), R, 4, 1) * vt[:, None, None, None, :]
        S = fma(wt.reshape(P, D // (4 * R), R, 4, 1), S, kv)
    return torch.stack(outs, dim=1), S.reshape(P, D, D)


def _inputs(BH, T, D, dtype, seed, model_scale=False):
    """numpy draws -> (jax arrays, torch f32 tensors of the same values).
    Unit scale as tests/test_kernels_wkv.py draws them: r, k, v at 0.3,
    w = sigmoid(normal), u at 0.1, a state at 0.1. Model scale as the
    reference's rwkv6 init gives them: r, k, v at 8, w = exp(-exp(normal)),
    u normal, a zero state."""
    rng = np.random.default_rng(seed)
    shp = (BH, T, D)
    sd = 8.0 if model_scale else 0.3
    xs = [rng.standard_normal(shp) * sd for _ in range(3)]
    z = rng.standard_normal(shp)
    xs.append(np.exp(-np.exp(z)) if model_scale else 1 / (1 + np.exp(-z)))
    xs.append(rng.standard_normal((BH, D)) * (1.0 if model_scale else 0.1))
    ts = [torch.tensor(x.astype(np.float32)) for x in xs]
    if dtype == "bfloat16":
        ts = [t.to(torch.bfloat16).float() for t in ts]
    s0 = np.zeros((BH, D, D), np.float32) if model_scale else (
        rng.standard_normal((BH, D, D)) * 0.1).astype(np.float32)
    js = [jnp.asarray(t.numpy()).astype(dtype) for t in ts]
    return js + [jnp.asarray(s0)], ts + [torch.tensor(s0)]


@pytest.mark.parametrize("BH,T,D,chunk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_order_matches_jax(BH, T, D, chunk, dtype):
    js, ts = _inputs(BH, T, D, dtype, seed=T + D)
    tol = 3e-2 if dtype == "bfloat16" else 3e-5
    o, sT = emulate_k5(*ts)
    o_p, sT_p = wkv_pallas(*js, chunk=chunk, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_p, np.float32),
                               atol=tol)
    np.testing.assert_allclose(sT.numpy(), np.asarray(sT_p), atol=tol)
    for b in range(BH):
        o_j, sT_j = j_wkv_ref(*(x[b] for x in js))
        np.testing.assert_allclose(o[b].numpy(), np.asarray(o_j), atol=tol)
        np.testing.assert_allclose(sT[b].numpy(), np.asarray(sT_j), atol=tol)


def test_k5_order_at_model_scale_panel():
    """One panel of the rwkv6-7b prefill (T 1024, D 64) at the scale the
    reference's init gives r, k, v, within 3e-5 of the tensors' scale, as
    the card's check holds K5 (chip_smoke.py)."""
    js, ts = _inputs(1, 1024, 64, "float32", seed=5, model_scale=True)
    o, sT = emulate_k5(*ts)
    o_j, sT_j = (np.asarray(a) for a in j_wkv_ref(*(x[0] for x in js)))
    for got, want in ((o[0].numpy(), o_j), (sT[0].numpy(), sT_j)):
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= 3e-5 * scale
    # and the port's plain version, which the card holds K5 to
    o_r, sT_r = wref.wkv_batched_ref(*(x[:, :, None] for x in ts[:4]),
                                     ts[4][:, None], ts[5][:, None])
    for got, want in ((o, o_r[:, :, 0]), (sT, sT_r[:, 0])):
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 3e-5 * scale


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_k5_threads_hold_each_state_entry_once(D):
    """Thread tid of a block of R D / C threads is row group
    g = tid // (D / C) and holds columns j0 = C (tid % (D / C)) + c of rows
    4 (g + R m) + e: every entry of the (D, D) state once, and from D 64 on
    each warp is one row group (its r, k, w loads are broadcasts)."""
    threads = R * D // C
    assert threads % 32 == 0 and threads <= 1024
    seen = np.zeros((D, D), np.int64)
    for tid in range(threads):
        g, j0 = tid // (D // C), C * (tid % (D // C))
        for m in range(D // (4 * R)):
            for e in range(4):
                seen[4 * (g + R * m) + e, j0:j0 + C] += 1
    assert np.all(seen == 1)
    if D >= 64:
        for w0 in range(0, threads, 32):
            assert len({tid // (D // C) for tid in range(w0, w0 + 32)}) == 1


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k5_row_groups_read_distinct_banks(dtype):
    """In a step, the row groups that share a warp (4 at D 16, 2 at D 32,
    1 from D 64) read 4-element chunks g + 4m of r, k and w (16 bytes in
    f32, 8 in bf16): at every m they fall in distinct 32-bit banks, so one
    shared load serves the warp."""
    esize = torch.empty((), dtype=dtype).element_size()
    for D in HEAD_DIMS:
        per_warp = max(1, 32 // (D // C))
        for m in range(D // (4 * R)):
            banks = [set(range((4 * (g + R * m)) * esize // 4,
                               (4 * (g + R * m) + 4) * esize // 4))
                     for g in range(per_warp)]
            banks = [{b % 32 for b in bs} for bs in banks]
            assert sum(len(b) for b in banks) == len(set().union(*banks))
