"""The port's attention ops on the CPU (the plain versions of K3
swa_attention and K4 decode_attention) against the JAX reference: its jnp
oracles, its blocked production paths in ``models/common.py`` and its
Pallas kernels run in interpret mode, on the same inputs (made with numpy
from a seed; bf16 inputs carry the same bf16 values on both sides).

Tolerances are the reference's own (tests/test_kernels_attention.py):
flash attention f32 atol 2e-5, bf16 2e-2; decode attention f32 1e-5, bf16
3e-2.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention.kernel import \
    decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as j_decode_ref  # noqa: E402
from repro.kernels.swa_attention.kernel import \
    flash_attention_pallas  # noqa: E402
from repro.kernels.swa_attention.ref import \
    attention_ref as j_attention_ref  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dkernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dref  # noqa: E402
from repro_torch.kernels.swa_attention import kernel as akernel  # noqa: E402
from repro_torch.kernels.swa_attention import ops as aops  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402

torch.set_num_threads(2)

CASES = [
    # B, S, Hq, Hkv, D, window (the reference's kernel test cases)
    (1, 64, 2, 2, 32, 0),
    (2, 128, 4, 2, 64, 0),
    (2, 128, 4, 1, 64, 32),      # MQA + SWA
    (1, 256, 6, 3, 32, 96),      # window not a multiple of the block
    (2, 64, 8, 8, 16, 16),
]
DECODE_CASES = [
    # B, C, Hq, Hkv, D, valid
    (2, 128, 4, 2, 64, "full"),
    (3, 256, 8, 1, 32, "ragged"),
    (1, 64, 2, 2, 128, "one"),
    (2, 100, 9, 3, 64, "ragged"),   # SmolLM's group of 3, a ragged C
]


def _inputs(shapes, dtype, seed):
    """numpy normals -> (jax arrays, torch tensors) holding equal values."""
    rng = np.random.default_rng(seed)
    xs = [torch.tensor(rng.standard_normal(s).astype(np.float32))
          for s in shapes]
    if dtype == "bfloat16":
        xs = [x.to(torch.bfloat16) for x in xs]
        js = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in xs]
    else:
        js = [jnp.asarray(x.numpy()) for x in xs]
    return js, xs


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax(B, S, Hq, Hkv, D, window, dtype):
    (qj, kj, vj), (q, k, v) = _inputs(
        [(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)], dtype, seed=S + D)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    got = aops.attention(q, k, v, causal=True, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, j_attention_ref(qj, kj, vj, causal=True, window=window), tol)
    _close(got, flash_attention_pallas(qj, kj, vj, causal=True, window=window,
                                       block_q=32, block_kv=32,
                                       interpret=True), tol)
    if dtype == "float32":
        _close(got, jcm.flash_attention(qj, kj, vj, causal=True,
                                        window=window, block_q=32,
                                        block_kv=32), tol)
    assert torch.equal(tcm.flash_attention(q, k, v, causal=True,
                                           window=window), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_causal_matches_jax(dtype):
    (qj, kj, vj), (q, k, v) = _inputs([(2, 64, 4, 32)] * 3, dtype, seed=2)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    got = aops.attention(q, k, v, causal=False)
    _close(got, j_attention_ref(qj, kj, vj, causal=False), tol)
    _close(got, flash_attention_pallas(qj, kj, vj, causal=False, block_q=32,
                                       block_kv=32, interpret=True), tol)
    if dtype == "float32":
        _close(got, jcm.flash_attention(qj, kj, vj, causal=False, block_q=32,
                                        block_kv=32), tol)


@pytest.mark.parametrize("S,window", [(100, 0), (100, 40), (37, 16)])
def test_ragged_length_matches_jax(S, window):
    """Any S: the Pallas kernel cannot take these (S % block != 0); the
    blocked jnp path halves its blocks until they divide S."""
    (qj, kj, vj), (q, k, v) = _inputs(
        [(2, S, 9, 64), (2, S, 3, 64), (2, S, 3, 64)], "float32", seed=S)
    got = aops.attention(q, k, v, causal=True, window=window)
    _close(got, j_attention_ref(qj, kj, vj, causal=True, window=window), 2e-5)
    _close(got, jcm.flash_attention(qj, kj, vj, causal=True, window=window,
                                    block_q=32, block_kv=32), 2e-5)


def _valid(kind, B, C):
    if kind == "full":
        return C
    if kind == "one":
        return 1
    return np.arange(B) * (C // 2) + 1


@pytest.mark.parametrize("B,C,Hq,Hkv,D,valid", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(B, C, Hq, Hkv, D, valid, dtype):
    (qj, kj, vj), (q, kc, vc) = _inputs(
        [(B, Hq, D), (B, C, Hkv, D), (B, C, Hkv, D)], dtype, seed=C + D)
    vl = _valid(valid, B, C)
    vl_t = vl if isinstance(vl, int) else torch.tensor(vl)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    got = dops.decode_attention(q, kc, vc, vl_t)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = j_decode_ref(qj, kj, vj, jnp.asarray(vl))
    _close(got, want, tol)
    _close(got, jcm.decode_attention(qj, kj, vj, jnp.asarray(vl)), tol)
    if C % 32 == 0:      # the Pallas kernel asserts C % block_c == 0
        _close(got, decode_attention_pallas(qj, kj, vj, jnp.asarray(vl),
                                            block_c=32, interpret=True), tol)
    # an int, a 0-d tensor and a (B,) tensor give the same answer
    if isinstance(vl, int):
        assert torch.equal(dops.decode_attention(q, kc, vc, torch.tensor(vl)),
                           got)
        assert torch.equal(dops.decode_attention(
            q, kc, vc, torch.full((B,), vl)), got)
    assert torch.equal(tcm.decode_attention(q, kc, vc, vl_t), got)


def test_decode_equals_last_row_of_prefill_attention():
    (_, _, _), (q, k, v) = _inputs([(2, 64, 4, 32), (2, 64, 2, 32),
                                    (2, 64, 2, 32)], "float32", seed=9)
    full = aops.attention(q, k, v, causal=True)
    dec = dops.decode_attention(q[:, -1], k, v, 64)
    _close(dec, full[:, -1].numpy(), 1e-5)


def test_dispatch_and_wrappers_refuse_what_they_cannot_run():
    """ops send a CPU tensor to the plain version and refuse other devices;
    the kernel wrappers take CUDA tensors only and count no launch
    otherwise."""
    q = torch.zeros(1, 8, 2, 16)
    akernel.reset_launches()
    dkernel.reset_launches()
    aops.attention(q, q, q)
    dops.decode_attention(q[:, 0], q, q, 8)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        aops.attention(meta, meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        dops.decode_attention(meta[:, 0], meta, meta, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        akernel.attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dkernel.decode_attention(q[:, 0], q, q, 8)
    with pytest.raises(ValueError, match="scalar or"):
        dref.decode_attention_ref(q[:, 0], q, q, torch.tensor([1, 2, 3]))
    assert akernel.LAUNCHES == {"swa_attention": 0, "swa_attention_lse": 0,
                                "swa_attention_bwd_dq": 0,
                                "swa_attention_bwd_dkdv": 0}
    assert dkernel.LAUNCHES == {"decode_attention": 0}

