"""The port's int8 quantize over a table of leaves (K1's ``quantize_many``)
and the two-launch ``compress_roundtrip`` on the CPU (their plain
versions), against the JAX reference.

On the card K1 quantizes a whole client delta in one launch over a table of
leaves, each leaf in its own blocks, and ``compress_roundtrip`` dequantizes
the concatenated layout with one K2 launch. The plain versions define what
that must give: ``quantize_many`` equals each leaf's ``quantize_ref``
concatenated, and the round trip equals the reference's per-leaf
``compress_roundtrip``. Everything is held bit-equal (IEEE division and
round half to even on both sides), on stacked (N, ...) reduced paper-charlm
leaves, ragged leaves and bf16 leaves. ``plan_tables``, which cuts a list
longer than one launch's table, is held on lists of many shapes.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.federated import aggregation as jagg  # noqa: E402
from repro.kernels.int8_quant import ref as jref  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.federated import aggregation as tagg  # noqa: E402
from repro_torch.kernels.int8_quant import kernel as tkernel  # noqa: E402
from repro_torch.kernels.int8_quant import ops as tops  # noqa: E402
from repro_torch.kernels.int8_quant import ref as tref  # noqa: E402

torch.set_num_threads(2)


def _charlm_shapes():
    """The leaf shapes of the reduced paper-charlm (the CPU tests' model),
    from the reference's init without computing it."""
    jcfg = dataclasses.replace(
        jreduced(jget_config("paper-charlm"), layers=1, d_model=32, d_ff=32,
                 vocab=128), lstm_hidden=32, max_context=8)
    shapes = jax.eval_shape(lambda key: jget_model(jcfg).init(key)[0],
                            jax.random.PRNGKey(0))
    return {k: tuple(v.shape) for k, v in shapes.items()}


def _leaves(case, seed=11):
    """name -> f32 numpy array, then the torch tensors of the same values
    (bf16 where the case says so)."""
    rng = np.random.default_rng(seed)
    if case == "stacked charlm":
        # 3 clients, client i scaled by 10**i, so that a block spanning
        # clients in a small leaf shows
        arrays = {k: np.stack([rng.standard_normal(s) * 10.0 ** i
                               for i in range(3)])
                  for k, s in _charlm_shapes().items()}
    else:
        shapes = {"one": (1,), "short": (255,), "block": (256,),
                  "over": (257,), "empty": (0,), "k": (1000,),
                  "matrix": (7, 77), "cube": (3, 5, 7)}
        arrays = {k: rng.standard_normal(s) for k, s in shapes.items()}
    ts = {k: torch.tensor(a.astype(np.float32)) for k, a in arrays.items()}
    if case == "bf16":
        ts = {k: t.to(torch.bfloat16) for k, t in ts.items()}
    return ts


def _jax(t):
    """The same values as a jax array of the same dtype."""
    j = jnp.asarray(t.float().numpy())
    return j.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else j


CASES = ["stacked charlm", "ragged", "bf16"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("block", [128, 256])
def test_quantize_many_equals_per_leaf_quantize(case, block):
    leaves = list(_leaves(case).values())
    q, s, views = tops.quantize_many(leaves, block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert len(views) == len(leaves)
    row = 0
    for x, (qi, si) in zip(leaves, views):
        nb = -(-x.numel() // block)
        assert tuple(qi.shape) == (nb, block) and tuple(si.shape) == (nb,)
        # views of the one output, each leaf's rows after the last leaf's
        assert torch.equal(qi, q[row:row + nb]) and torch.equal(
            si, s[row:row + nb])
        row += nb
        q0, s0 = tref.quantize_ref(x, block)
        assert torch.equal(qi, q0) and torch.equal(si, s0)
        qj, sj = (np.asarray(a) for a in jref.quantize_ref(_jax(x), block))
        np.testing.assert_array_equal(qi.numpy(), qj)
        np.testing.assert_array_equal(si.numpy(), sj)
    assert row == q.shape[0] == s.shape[0]
    q1, s1, _ = tref.quantize_many_ref(leaves, block)
    assert torch.equal(q, q1) and torch.equal(s, s1)


@pytest.mark.parametrize("nbs,max_leaves,want", [
    ([], 64, []),
    ([0, 0], 64, []),
    ([5], 64, [(0, 1)]),
    ([1] * 64, 64, [(0, 64)]),
    ([1] * 65, 64, [(0, 64), (64, 65)]),
    ([1] * 64 + [0, 0], 64, [(0, 66)]),
    ([0, 0, 3] + [1] * 63 + [0, 2], 64, [(0, 67), (67, 68)]),
    ([2, 0, 3, 4, 0], 2, [(0, 3), (3, 5)]),
    ([1, 1, 1], 1, [(0, 1), (1, 2), (2, 3)]),
])
def test_plan_tables_cuts_long_lists(nbs, max_leaves, want):
    assert tkernel.plan_tables(nbs, max_leaves) == want


def test_plan_tables_covers_random_lists_in_order():
    rng = np.random.default_rng(3)
    for _ in range(50):
        nbs = [int(n) for n in rng.integers(0, 3, rng.integers(0, 300))]
        ranges = tkernel.plan_tables(nbs)
        # contiguous, in order, every leaf with a block in exactly one range
        flat = [i for a, b in ranges for i in range(a, b)]
        assert flat == sorted(set(flat))
        assert {i for i, n in enumerate(nbs) if n} <= set(flat)
        for a, b in ranges:
            assert 1 <= sum(1 for n in nbs[a:b] if n) <= tkernel.MAX_LEAVES
        # a later range starts at a leaf with a block
        assert all(nbs[a] for a, _ in ranges[1:])
        if any(nbs):
            assert len(ranges) == -(-sum(1 for n in nbs if n)
                                    // tkernel.MAX_LEAVES)
    with pytest.raises(ValueError):
        tkernel.plan_tables([1], 0)


@pytest.mark.parametrize("case", CASES)
def test_compress_roundtrip_matches_jax_leaf_by_leaf(case):
    delta = _leaves(case)
    got = tagg.compress_roundtrip(delta, block=256)
    want = jagg.compress_roundtrip({k: _jax(v) for k, v in delta.items()},
                                   block=256)
    assert list(got) == list(delta)
    for k, x in delta.items():
        assert got[k].dtype == x.dtype and got[k].shape == x.shape, k
        np.testing.assert_array_equal(
            got[k].float().numpy(), np.asarray(want[k]).astype(np.float32),
            err_msg=k)


def test_compress_roundtrip_is_one_quantize_and_one_dequantize(monkeypatch):
    """The round trip of a whole delta is one quantize_many over its leaves
    and one dequantize of the concatenated layout: on the card one K1 and
    one K2 launch (chip_smoke.py counts them on the train path)."""
    calls = {"quantize_many": 0, "dequantize": 0}
    for name in calls:
        fn = getattr(tops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tops, name, counted)
    delta = _leaves("stacked charlm")
    assert len(delta) > 1
    tagg.compress_roundtrip(delta, block=256)
    assert calls == {"quantize_many": 1, "dequantize": 1}
    assert tagg.compress_roundtrip({}, block=256) == {}
    assert calls == {"quantize_many": 1, "dequantize": 1}


def test_quantize_many_refusals():
    """No fallback: the kernel wrapper takes CUDA tensors only; an empty
    list and a block the one-warp-per-block kernel cannot take are
    refused everywhere."""
    x = torch.zeros(64)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.quantize_many([x, x], 64)
    with pytest.raises(ValueError, match="multiple of 32"):
        tkernel.quantize_many([x], 48)
    for fn in (tkernel.quantize_many, tops.quantize_many,
               tref.quantize_many_ref):
        with pytest.raises(ValueError, match="at least one leaf"):
            fn([], 64)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.quantize_many([x.to("meta")], 64)
    assert tkernel.LAUNCHES == {"int8_quantize": 0,
                                "int8_dequant_accumulate": 0}
