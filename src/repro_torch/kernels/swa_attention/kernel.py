"""ctypes wrapper of the flash-attention CUDA kernel
(``csrc/swa_attention.cu``).

K3 ``attention`` replaces the TPU kernel ``flash_attention_pallas`` (the
reference's ``kernels/swa_attention/kernel.py``): both products on the
tensor cores, 3xTF32 for f32 inputs and bf16 mma for bf16 (see the
source's note). It takes CUDA tensors only, checks what the kernel cannot
take, allocates the output, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and adds one to
``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import (DTYPES, HEAD_DIMS, aligned16,
                                        check_cuda, raise_if_failed, run_on)

LAUNCHES = {"swa_attention": 0}

_c = ctypes.c_void_p
_i = ctypes.c_int


def reset_launches() -> None:
    LAUNCHES["swa_attention"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("swa_attention")
    if not getattr(lib, "_typed", False):
        lib.swa_attention_fwd.argtypes = [
            _c, _c, _c, _c, _i, _i, _i, _i, _i, _i,
            ctypes.POINTER(ctypes.c_longlong), _i, _i, ctypes.c_float, _c]
        lib.swa_attention_fwd.restype = _i
        lib._typed = True
    return lib


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """K3: q (B,S,Hq,D), k/v (B,S,Hkv,D), f32 or bf16, any strides with a
    contiguous last dimension -> o (B,S,Hq,D) contiguous, in q's dtype."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda(name, t)
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, D), got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {q.dtype}")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if tuple(k.shape) != (B, S, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({B}, {S}, Hkv, {D})")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    o = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    lib = _lib()
    err = run_on(q.device, lambda stream: lib.swa_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, Hq,
        Hkv, D, DTYPES[q.dtype], strides, int(causal), int(window),
        1.0 / math.sqrt(D), stream))
    raise_if_failed("swa_attention", err)
    LAUNCHES["swa_attention"] += 1
    return o
