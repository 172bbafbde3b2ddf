"""ctypes wrappers of the int8 codec's CUDA kernels (``csrc/int8_quant.cu``).

K1 ``quantize`` replaces the TPU kernel ``quantize_pallas`` and K2
``dequant_accumulate`` replaces ``dequant_accumulate_pallas`` (both in the
reference's ``kernels/int8_quant/kernel.py``). Each wrapper takes CUDA
tensors only, checks what the kernel cannot take, allocates the outputs,
launches on PyTorch's current stream without synchronising, raises if the
launch was refused, and adds one to its entry of ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_cuda, raise_if_failed

LAUNCHES = {"int8_quantize": 0, "int8_dequant_accumulate": 0}

_c = ctypes.c_void_p


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_quant")
    if not getattr(lib, "_typed", False):
        lib.int8_quantize.argtypes = [_c, _c, _c, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_longlong, _c]
        lib.int8_quantize.restype = ctypes.c_int
        lib.int8_dequant_accumulate.argtypes = [
            _c, _c, _c, ctypes.c_float, _c, ctypes.c_longlong, ctypes.c_int, _c]
        lib.int8_dequant_accumulate.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check_block(block: int) -> None:
    if block <= 0 or block % 32:
        raise ValueError(f"block must be a positive multiple of 32 (one warp "
                         f"per block), got {block}")


def quantize(x: torch.Tensor, block: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: x of any shape (f32, or bf16 cast to f32 first) -> (q int8
    (nb, block), scales f32 (nb,)), nb = ceil(numel / block); the ragged
    tail is zero-padded inside the kernel."""
    _check_block(block)
    check_cuda("x", x)
    flat = x.float().contiguous().reshape(-1)
    n = flat.numel()
    nb = -(-n // block)
    q = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    s = torch.empty((nb,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().int8_quantize(flat.data_ptr(), q.data_ptr(), s.data_ptr(),
                                   n, block, nb, stream)
    raise_if_failed("int8_quantize", err)
    LAUNCHES["int8_quantize"] += 1
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
