"""ctypes wrappers of the int8 codec's CUDA kernels (``csrc/int8_quant.cu``).

K1 ``quantize_many`` replaces the TPU kernel ``quantize_pallas`` and K2
``dequant_accumulate`` replaces ``dequant_accumulate_pallas`` (both in the
reference's ``kernels/int8_quant/kernel.py``). K1 quantizes a list of
tensors in one launch over a table of leaves (``plan_tables`` cuts a list
longer than the kernel's table into several launches); ``quantize`` is a
one-leaf table. Each wrapper takes CUDA tensors only, checks what the
kernel cannot take, allocates the outputs, launches on PyTorch's current
stream without synchronising, raises if the launch was refused, and adds
one to its entry of ``LAUNCHES`` for each launch.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_cuda, raise_if_failed, run_on

LAUNCHES = {"int8_quantize": 0, "int8_dequant_accumulate": 0}
MAX_LEAVES = 64           # leaves one K1 launch takes (kMaxLeaves)

_c = ctypes.c_void_p


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_quant")
    if not getattr(lib, "_typed", False):
        if lib.int8_max_leaves() != MAX_LEAVES:
            raise RuntimeError("int8_quant.cu's table size differs from "
                               "MAX_LEAVES")
        lib.int8_quantize_many.argtypes = [
            ctypes.POINTER(_c), ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, _c, _c,
            ctypes.c_int, _c]
        lib.int8_quantize_many.restype = ctypes.c_int
        lib.int8_dequant_accumulate.argtypes = [
            _c, _c, _c, ctypes.c_float, _c, ctypes.c_longlong, ctypes.c_int, _c]
        lib.int8_dequant_accumulate.restype = ctypes.c_int
        lib._typed = True
    return lib


def plan_tables(nbs: Sequence[int], max_leaves: int = MAX_LEAVES
                ) -> List[Tuple[int, int]]:
    """The K1 launches for leaves of nbs[i] blocks each: [start, stop)
    ranges of leaf indices, each holding at most ``max_leaves`` leaves with
    at least one block (leaves with none need no launch), together covering
    every leaf once and in order."""
    if max_leaves <= 0:
        raise ValueError(f"max_leaves must be positive, got {max_leaves}")
    out, start, held = [], 0, 0
    for i, nb in enumerate(nbs):
        if nb and held == max_leaves:
            out.append((start, i))
            start, held = i, 0
        held += bool(nb)
    if held:
        out.append((start, len(nbs)))
    return out


def _check_block(block: int) -> None:
    if block <= 0 or block % 32:
        raise ValueError(f"block must be a positive multiple of 32 (one warp "
                         f"per block), got {block}")


def quantize_many(leaves: Sequence[torch.Tensor], block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             List[Tuple[torch.Tensor, torch.Tensor]]]:
    """K1 over a table: leaves of any shapes (f32, or bf16 cast to f32
    first), all on one device -> (q int8 (total_nb, block), scales f32
    (total_nb,), [(q_i, s_i)] views of them per leaf). Leaf i owns
    nb_i = ceil(numel_i / block) rows, after those of the leaves before it;
    its ragged tail is zero-padded inside the kernel, and no block spans two
    leaves. One launch per ``plan_tables`` range."""
    _check_block(block)
    if not leaves:
        raise ValueError("quantize_many needs at least one leaf")
    flats = []
    for i, x in enumerate(leaves):
        check_cuda(f"leaves[{i}]", x)
        if x.device != leaves[0].device:
            raise ValueError(f"leaves[{i}] is on {x.device}, leaves[0] on "
                             f"{leaves[0].device}")
        flats.append(x.float().contiguous().reshape(-1))
    ns = [f.numel() for f in flats]
    nbs = [-(-n // block) for n in ns]
    firsts = [0]
    for nb in nbs:
        firsts.append(firsts[-1] + nb)
    dev = leaves[0].device
    q = torch.empty((firsts[-1], block), dtype=torch.int8, device=dev)
    s = torch.empty((firsts[-1],), dtype=torch.float32, device=dev)
    lib = _lib()
    for start, stop in plan_tables(nbs):
        idx = [i for i in range(start, stop) if nbs[i]]
        base = firsts[idx[0]]
        xs = (_c * len(idx))(*(flats[i].data_ptr() for i in idx))
        cn = (ctypes.c_longlong * len(idx))(*(ns[i] for i in idx))
        cf = (ctypes.c_longlong * (len(idx) + 1))(
            *(firsts[i] - base for i in idx), firsts[idx[-1] + 1] - base)
        err = run_on(dev, lambda stream: lib.int8_quantize_many(
            xs, cn, cf, len(idx), q.data_ptr() + base * block,
            s.data_ptr() + 4 * base, block, stream))
        raise_if_failed("int8_quantize", err)
        LAUNCHES["int8_quantize"] += 1
    views = [(q[a:b], s[a:b]) for a, b in zip(firsts, firsts[1:])]
    return q, s, views


def quantize(x: torch.Tensor, block: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on one tensor (a one-leaf table): x of any shape (f32, or bf16
    cast to f32 first) -> (q int8 (nb, block), scales f32 (nb,)),
    nb = ceil(numel / block); the ragged tail is zero-padded inside the
    kernel."""
    q, s, _ = quantize_many([x], block)
    return q, s


def dequant_accumulate(acc: Optional[torch.Tensor], q: torch.Tensor,
                       s: torch.Tensor, weight: float, n: int,
                       block: int = 256) -> torch.Tensor:
    """K2: flat f32 ``acc[:n] + weight * (q * s[:, None]).reshape(-1)[:n]``.
    ``acc=None`` reads as zeros, which with ``weight=1`` is the dequantize
    exactly (0 + 1 * v == v)."""
    _check_block(block)
    check_cuda("q", q)
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != block:
        raise ValueError(f"q must be int8 (nb, {block}), got {q.dtype} "
                         f"{tuple(q.shape)}")
    nb = q.shape[0]
    if s.dtype != torch.float32 or tuple(s.shape) != (nb,):
        raise ValueError(f"scales must be f32 ({nb},), got {s.dtype} "
                         f"{tuple(s.shape)}")
    if not 0 <= n <= nb * block:
        raise ValueError(f"n={n} outside the {nb}x{block} layout")
    if acc is not None:
        if acc.dtype != torch.float32 or acc.numel() != n:
            raise ValueError(f"acc must be f32 with {n} elements, got "
                             f"{acc.dtype} {acc.numel()}")
        acc = acc.contiguous()
    q, s = q.contiguous(), s.contiguous()
    for name, t in (("s", s), ("acc", acc)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    out = torch.empty((n,), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().int8_dequant_accumulate(
            None if acc is None else acc.data_ptr(), q.data_ptr(),
            s.data_ptr(), float(weight), out.data_ptr(), n, block, stream)
    raise_if_failed("int8_dequant_accumulate", err)
    LAUNCHES["int8_dequant_accumulate"] += 1
    return out
