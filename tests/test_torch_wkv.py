"""The port's WKV op on the CPU (the plain versions of K5) against the JAX
reference: its jnp oracle ``wkv_ref``, its Pallas kernel ``wkv_pallas`` run
in interpret mode and the RWKV6 model's chunked two-level scan
(``RWKV6._wkv``), on the same inputs (made with numpy from a seed; bf16
inputs carry the same bf16 values on both sides).

Tolerances are the reference's own (tests/test_kernels_wkv.py): the
single-panel recurrence f32 atol 3e-5, bf16 3e-2; the model's scan 2e-4.
The ops are held to the plain versions exactly, since on the CPU they run
them.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.kernels.wkv.kernel import wkv_pallas  # noqa: E402
from repro.kernels.wkv.ref import wkv_ref as j_wkv_ref  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.kernels.wkv import kernel as wkernel  # noqa: E402
from repro_torch.kernels.wkv import ops as wops  # noqa: E402
from repro_torch.kernels.wkv import ref as wref  # noqa: E402

torch.set_num_threads(2)

# BH, T, D, chunk: the reference's kernel test cases
CASES = [(1, 32, 16, 16), (2, 64, 32, 32), (3, 128, 64, 64), (2, 96, 32, 32)]


def _inputs(lead, D, dtype, seed):
    """numpy draws shaped as tests/test_kernels_wkv.py's: r, k, v at 0.3,
    w = sigmoid(normal), u at 0.1 of shape lead[:1] + (D,) (one per panel)
    and an f32 state at 0.1 -> (jax arrays, torch tensors) of equal
    values."""
    rng = np.random.default_rng(seed)
    shp = lead + (D,)
    xs = [rng.standard_normal(shp) * 0.3 for _ in range(3)]
    xs.append(1 / (1 + np.exp(-rng.standard_normal(shp))))
    xs.append(rng.standard_normal(lead[:1] + (D,)) * 0.1)
    ts = [torch.tensor(x.astype(np.float32)) for x in xs]
    if dtype == "bfloat16":
        ts = [t.to(torch.bfloat16) for t in ts]
    js = [jnp.asarray(t.float().numpy()).astype(dtype) for t in ts]
    s0 = (rng.standard_normal(lead[:1] + (D, D)) * 0.1).astype(np.float32)
    return js + [jnp.asarray(s0)], ts + [torch.tensor(s0)]


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("BH,T,D,chunk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_ref_matches_jax_oracle_and_pallas(BH, T, D, chunk, dtype):
    js, ts = _inputs((BH, T), D, dtype, seed=T + D)
    tol = 3e-2 if dtype == "bfloat16" else 3e-5
    o_p, sT_p = wkv_pallas(*js, chunk=chunk, interpret=True)
    for b in range(BH):
        o, sT = wref.wkv_ref(*(t[b] for t in ts))
        assert o.dtype == sT.dtype == torch.float32
        o_j, sT_j = j_wkv_ref(*(t[b] for t in js))
        _close(o, o_j, tol)
        _close(sT, sT_j, tol)
        _close(o, o_p[b], tol)
        _close(sT, sT_p[b], tol)
    # the same panels through the op in the model's layout: B = BH, H = 1,
    # one u per panel
    r, k, v, w, u, s0 = ts
    state = s0[:, None].clone()
    o, out_state = wops.wkv(r[:, :, None], k[:, :, None], v[:, :, None],
                            w[:, :, None], u[:, None], state)
    assert out_state is state and o.dtype == r.dtype
    _close(o[:, :, 0], o_p, tol)
    _close(state[:, 0], sT_p, tol)


@pytest.mark.parametrize("T", [1, 13, 24])
def test_batched_ref_matches_model_scan(T):
    """T = 1 (a decode step), 13 (not a multiple of the chunk: one plain
    scan) and 24 (a multiple: the checkpointed two-level scan)."""
    jm = jget_model(jreduced(jget_config("rwkv6-7b")))
    B, H, D = 2, jm.n_heads, 64
    js, ts = _inputs((B, T, H), D, "float32", seed=T)
    rng = np.random.default_rng(T + 1)
    u = (rng.standard_normal((H, D)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, D, D)) * 0.1).astype(np.float32)
    o_j, sT_j = jm._wkv(*js[:4], jnp.asarray(u), jnp.asarray(s0), chunk=8)
    o, sT = wref.wkv_batched_ref(*ts[:4], torch.tensor(u), torch.tensor(s0))
    r = ts[0]
    assert o.shape == r.shape and sT.shape == (B, H, D, D)
    _close(o, o_j, 2e-4)
    _close(sT, sT_j, 2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_updates_the_state_in_place(dtype):
    """ops.wkv on CPU tensors is the plain version, with the final state
    written over the state given."""
    _, (r, k, v, w, u, _) = _inputs((2, 9, 3), 32, dtype, seed=5)
    u = u[0]                                              # (H, D)
    s0 = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    want_o, want_s = wref.wkv_batched_ref(r, k, v, w, u, s0)
    state = s0.clone()
    o, out = wops.wkv(r, k, v, w, u, state)
    assert out is state and o.dtype == r.dtype
    assert torch.equal(o, want_o) and torch.equal(state, want_s)
    # two calls on halves of the sequence equal one call on the whole
    state = s0.clone()
    o1, _ = wops.wkv(r[:, :4], k[:, :4], v[:, :4], w[:, :4], u, state)
    o2, _ = wops.wkv(r[:, 4:], k[:, 4:], v[:, 4:], w[:, 4:], u, state)
    tol = 3e-2 if dtype == "bfloat16" else 3e-5
    _close(torch.cat([o1, o2], 1), want_o.float().numpy(), tol)
    _close(state, want_s.numpy(), 3e-5)


def test_per_panel_u_and_strided_views():
    """u per panel (B, H, D) and r/k/v/w as strided views of one fused
    (B, T, H, 4, D) tensor give each panel's single-panel recurrence."""
    g = torch.Generator().manual_seed(2)
    B, T, H, D = 2, 7, 3, 16
    fused = torch.randn(B, T, H, 4, D, generator=g) * 0.3
    r, k, v, w = fused.unbind(3)
    w = torch.sigmoid(w)
    u = torch.randn(B, H, D, generator=g) * 0.1
    s0 = torch.randn(B, H, D, D, generator=g) * 0.1
    state = s0.clone()
    o, _ = wops.wkv(r, k, v, w, u, state)
    for b in range(B):
        for h in range(H):
            o_p, s_p = wref.wkv_ref(r[b, :, h], k[b, :, h], v[b, :, h],
                                    w[b, :, h], u[b, h], s0[b, h])
            _close(o[b, :, h], o_p.numpy(), 3e-5)
            _close(state[b, h], s_p.numpy(), 3e-5)


def test_dispatch_and_wrapper_refuse_what_they_cannot_run():
    """ops send a CPU tensor to the plain version and refuse other devices;
    the kernel wrapper takes CUDA tensors only and counts no launch
    otherwise."""
    x = torch.zeros(1, 4, 2, 16)
    u = torch.zeros(2, 16)
    s = torch.zeros(1, 2, 16, 16)
    wkernel.reset_launches()
    wops.wkv(x, x, x, x, u, s)
    meta = [t.to("meta") for t in (x, u, s)]
    with pytest.raises(ValueError, match="unsupported device"):
        wops.wkv(meta[0], meta[0], meta[0], meta[0], meta[1], meta[2])
    with pytest.raises(ValueError, match="CUDA tensor"):
        wkernel.wkv(x, x, x, x, u, s)
    assert wkernel.LAUNCHES == {"wkv": 0}
