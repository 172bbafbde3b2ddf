"""ctypes wrapper of the WKV CUDA kernel (``csrc/wkv.cu``).

K5 ``wkv`` replaces the TPU kernel ``wkv_pallas`` (the reference's
``kernels/wkv/kernel.py``). It takes CUDA tensors only, checks what the
kernel cannot take, allocates the output, launches on PyTorch's current
stream without synchronising, raises if the launch was refused, and adds
one to ``LAUNCHES``. The final state is written IN PLACE over the state it
is given. Inputs whose pointer or outer strides are not multiples of 16
bytes (the kernel's cp.async copies) are copied first.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import (DTYPES, HEAD_DIMS, aligned16,
                                        check_cuda, raise_if_failed)

LAUNCHES = {"wkv": 0}

_c = ctypes.c_void_p
_i = ctypes.c_int


def reset_launches() -> None:
    LAUNCHES["wkv"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv")
    if not getattr(lib, "_typed", False):
        lib.wkv_fwd.argtypes = [_c, _c, _c, _c, _c, _c, _c, _i, _i, _i, _i,
                                _i, ctypes.POINTER(ctypes.c_longlong), _c]
        lib.wkv_fwd.restype = _i
        lib._typed = True
    return lib


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: r, k, v, w (B,T,H,D), one dtype, f32 or bf16, any strides with a
    contiguous last dimension; u (H,D), or (B,H,D) for one u per panel,
    read as f32; state (B,H,D,D) f32, contiguous. Returns (o (B,T,H,D)
    contiguous in r's dtype, state), the state UPDATED IN PLACE to S_T.
    A (BH, T, D) call is B = BH, H = 1."""
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        check_cuda(name, t)
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, T, H, D), got "
                             f"{tuple(t.shape)}")
        if t.dtype != r.dtype or t.device != r.device or t.shape != r.shape:
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, r is {tuple(r.shape)} {r.dtype} "
                             f"on {r.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    check_cuda("u", u)
    check_cuda("state", state)
    if r.dtype not in DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {r.dtype}")
    B, T, H, D = r.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if u.device != r.device or tuple(u.shape) not in ((H, D), (B, H, D)):
        raise ValueError(f"u must be ({H}, {D}) or ({B}, {H}, {D}) on "
                         f"{r.device}, got {tuple(u.shape)} on {u.device}")
    if (state.device != r.device or state.dtype != torch.float32
            or tuple(state.shape) != (B, H, D, D)
            or not state.is_contiguous()):
        raise ValueError(f"state must be a contiguous float32 ({B}, {H}, "
                         f"{D}, {D}) tensor on {r.device}, got "
                         f"{tuple(state.shape)} {state.dtype} on "
                         f"{state.device}")
    r, k, v, w = (aligned16(t) for t in (r, k, v, w))
    uf = u.to(torch.float32).contiguous()
    u_strides = (0, uf.stride(0)) if uf.dim() == 2 else uf.stride()[:2]
    o = torch.empty((B, T, H, D), dtype=r.dtype, device=r.device)
    if o.numel() == 0:
        return o, state
    strides = (ctypes.c_longlong * 19)(
        *(s for t in (r, k, v, w, o) for s in (t.stride(0), t.stride(1),
                                               t.stride(2))),
        *u_strides, state.stride(0), state.stride(1))
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().wkv_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            uf.data_ptr(), state.data_ptr(), o.data_ptr(), B, T, H, D,
            DTYPES[r.dtype], strides, stream)
    raise_if_failed("wkv", err)
    LAUNCHES["wkv"] += 1
    return o, state
