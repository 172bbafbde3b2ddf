"""The port's int8 codec (plain PyTorch path) against the JAX reference's
jnp oracle and its Pallas kernel run in interpret mode.

Tolerances: q is held bit-equal to the jnp oracle, which is what the
reference learner runs (eagerly, so both sides divide in IEEE f32 and round
half to even); scales within rtol 1e-6, the reference's own kernel test
tolerance; dequant-accumulate within atol 1e-5, likewise.

The Pallas kernel is jitted, and XLA rewrites its ``amax / 127.0`` into a
product with the reciprocal, which can put its scale one ulp off the
oracle's. On a block where that happens, an element whose x / scale lies
within an ulp of .5 rounds the other way, so q is held bit-equal to the
Pallas kernel on every block whose scale is bit-equal, and within 1 on the
others. That is a fact of the reference (its oracle and kernel disagree
there), not a tolerance of the port.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.int8_quant import ops as jops  # noqa: E402
from repro.kernels.int8_quant import ref as jref  # noqa: E402
from repro.kernels.int8_quant.kernel import quantize_pallas  # noqa: E402
from repro_torch.kernels.int8_quant import kernel as tkernel  # noqa: E402
from repro_torch.kernels.int8_quant import ops as tops  # noqa: E402
from repro_torch.kernels.int8_quant import ref as tref  # noqa: E402

torch.set_num_threads(2)

SHAPES = [(64,), (1000,), (128, 128), (3, 7, 11), (2048, 33)]


def _inputs(shape, dtype, seed=7):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        xt = torch.tensor(x).to(torch.bfloat16)
        # the same bf16 values on both sides
        return jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16), xt
    return jnp.asarray(x), torch.tensor(x)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [128, 256])
def test_quantize_matches_jax(shape, dtype, block):
    xj, xt = _inputs(shape, dtype)
    q0, s0 = (np.asarray(a) for a in jref.quantize_ref(xj, block))
    q1, s1 = (np.asarray(a) for a in quantize_pallas(xj, block=block,
                                                      interpret=True))
    q, s = tops.quantize(xt, block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    nb = q0.shape[0]
    assert tuple(q.shape) == (nb, block)
    np.testing.assert_array_equal(q.numpy(), q0)
    same = s1[:nb] == s0
    np.testing.assert_array_equal(q.numpy()[same], q1[:nb][same])
    assert np.abs(q.numpy().astype(int) - q1[:nb]).max() <= 1
    np.testing.assert_allclose(s.numpy(), s0, rtol=1e-6)
    np.testing.assert_allclose(s.numpy(), s1[:nb], rtol=1e-6)
    # the round trip keeps the caller's dtype and shape
    y = tops.quant_dequant(xt, block)
    assert y.dtype == xt.dtype and y.shape == xt.shape
    np.testing.assert_array_equal(
        y.float().numpy(),
        np.asarray(jref.quant_dequant_ref(xj, block).astype(jnp.float32)))


def test_rounding_is_half_to_even():
    """x/scale landing exactly on .5 rounds to even (jnp.round), not away
    from zero; 127 * k / 127 keeps the amax element exact."""
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5] + [0.0] * 26)
    q, s = tref.quantize_ref(x, 32)
    assert float(s[0]) == 1.0
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("shape", [(512,), (64, 48)])
@pytest.mark.parametrize("weight", [0.25, 1.0])
def test_dequant_accumulate_matches_jax(shape, weight):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    acc = rng.standard_normal(shape).astype(np.float32)
    # the Pallas accumulate takes the Pallas quantizer's 8-row-padded layout
    qp, sp = quantize_pallas(jnp.asarray(x), block=128, interpret=True)
    want = jops.dequant_accumulate(jnp.asarray(acc), qp, sp, weight,
                                   block=128, use_pallas=True)
    nb = -(-x.size // 128)
    qj, sj = qp[:nb], sp[:nb]
    want_ref = jref.dequant_accumulate_ref(jnp.asarray(acc), qj, sj, weight,
                                           block=128)
    q, s = torch.tensor(np.asarray(qj)), torch.tensor(np.asarray(sj))
    got = tops.dequant_accumulate(torch.tensor(acc), q, s, weight, block=128)
    assert got.shape == acc.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=1e-5)
    deq = tops.dequantize(q, s, shape, block=128)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jref.dequantize_ref(qj, sj, shape, 128)))


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1_000_000])
def test_wire_bytes(n):
    assert tops.wire_bytes(n) == jops.wire_bytes(n) == n + 4 * -(-n // 256)


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_blocks():
    """No fallback: the kernel wrappers take CUDA tensors only, and a
    block the one-warp-per-block kernel cannot take is refused."""
    x = torch.zeros(64)
    with pytest.raises(ValueError, match="multiple of 32"):
        tkernel.quantize(x, 48)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.quantize(x, 64)
    q, s = tref.quantize_ref(x, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.dequant_accumulate(None, q, s, 1.0, 64, 32)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.quantize(x.to("meta"), 32)
    assert tkernel.LAUNCHES == {"int8_quantize": 0,
                                "int8_dequant_accumulate": 0}
