"""ctypes wrappers of the flash-attention CUDA kernels
(``csrc/swa_attention.cu``, ``csrc/swa_attention_bwd.cu``).

K3 ``attention`` replaces the TPU kernel ``flash_attention_pallas`` (the
reference's ``kernels/swa_attention/kernel.py``): both products on the
tensor cores, 3xTF32 for f32 inputs and bf16 mma for bf16 (see the
source's note). ``attention_fwd`` is the same kernel writing each row's
log-sum-exp as well, which training saves; ``attention_bwd_dq`` and
``attention_bwd_dkdv`` are the two backward kernels (f32, on the tensor
cores in 3xTF32), which the TPU kernel has no counterpart of, and
``attention_bwd`` launches both.

Each wrapper takes CUDA tensors only, checks what its kernel cannot take,
allocates its outputs, launches on PyTorch's current stream without
synchronising (so a CUDA graph can capture it, once a first call outside
the capture has configured the kernel's shared memory), raises if the
launch was refused, and adds one to its count in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import (DTYPES, HEAD_DIMS, aligned16,
                                        check_cuda, raise_if_failed, run_on)

LAUNCHES = {"swa_attention": 0, "swa_attention_lse": 0,
            "swa_attention_bwd_dq": 0, "swa_attention_bwd_dkdv": 0}

_c = ctypes.c_void_p
_i = ctypes.c_int
_strides = ctypes.POINTER(ctypes.c_longlong)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("swa_attention")
    if not getattr(lib, "_typed", False):
        lib.swa_attention_fwd.argtypes = [
            _c, _c, _c, _c, _c, _i, _i, _i, _i, _i, _i, _strides, _i, _i,
            ctypes.c_float, _c]
        lib.swa_attention_fwd.restype = _i
        lib._typed = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("swa_attention_bwd")
    if not getattr(lib, "_typed", False):
        for name in ("swa_attention_bwd_dq", "swa_attention_bwd_dkdv"):
            fn = getattr(lib, name)
            fn.argtypes = [_c] * 8 + [_i] * 5 + [_strides, _i, _i,
                                                   ctypes.c_float, _c]
            fn.restype = _i
        lib._typed = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           **more: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """What every K3 wrapper checks of q, k, v (and of `more`, which have
    q's shape); returns (B, S, Hq, Hkv, D)."""
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
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
    for name, t in more.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must be q's shape "
                             f"{tuple(q.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return B, S, Hq, Hkv, D


def _forward(q, k, v, causal, window, with_lse):
    B, S, Hq, Hkv, D = _check(q, k, v, window)
    o = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if o.numel() == 0:
        return o, lse
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    lib = _lib()
    err = run_on(q.device, lambda stream: lib.swa_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), B, S, Hq, Hkv, D,
        DTYPES[q.dtype], strides, int(causal), int(window),
        1.0 / math.sqrt(D), stream))
    raise_if_failed("swa_attention", err)
    LAUNCHES["swa_attention_lse" if with_lse else "swa_attention"] += 1
    return o, lse


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """K3: q (B,S,Hq,D), k/v (B,S,Hkv,D), f32 or bf16, any strides with a
    contiguous last dimension -> o (B,S,Hq,D) contiguous, in q's dtype."""
    return _forward(q, k, v, causal, window, with_lse=False)[0]


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 with each row's log-sum-exp: -> (o as ``attention`` gives it, lse
    (B,Hq,S) f32, -inf for a row with no key)."""
    return _forward(q, k, v, causal, window, with_lse=True)


def _bwd_inputs(q, k, v, lse, do, window, **more):
    if q.dtype != torch.float32:
        raise NotImplementedError(f"the attention backward in {q.dtype} is "
                                  "not ported yet (f32 only)")
    B, S, Hq, Hkv, D = _check(q, k, v, window, do=do, **more)
    check_cuda("lse", lse)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, Hq, S) or \
            lse.device != q.device:
        raise ValueError(f"lse must be f32 ({B}, {Hq}, {S}) on {q.device}, "
                         f"got {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}")
    return (B, S, Hq, Hkv, D), lse.contiguous()


def attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                     causal: bool = True, window: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dQ kernel: q, o, do (B,S,Hq,D), k/v (B,S,Hkv,D), f32, strided
    with a contiguous last dimension; lse (B,Hq,S) from ``attention_fwd``
    -> (dq (B,S,Hq,D), delta (B,Hq,S) = sum over D of do * o, which the
    dK/dV kernel reads)."""
    (B, S, Hq, Hkv, D), lse = _bwd_inputs(q, k, v, lse, do, window, o=o)
    dq = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, delta
    q, k, v, o, do = (aligned16(t) for t in (q, k, v, o, do))
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (q, k, v, o, do) for s in t.stride()[:3]))
    lib = _bwd_lib()
    err = run_on(q.device, lambda stream: lib.swa_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), delta.data_ptr(), B, S,
        Hq, Hkv, D, strides, int(causal), int(window), 1.0 / math.sqrt(D),
        stream))
    raise_if_failed("swa_attention_bwd_dq", err)
    LAUNCHES["swa_attention_bwd_dq"] += 1
    return dq, delta


def attention_bwd_dkdv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lse: torch.Tensor, do: torch.Tensor,
                       delta: torch.Tensor, *, causal: bool = True,
                       window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel: as ``attention_bwd_dq``, with the delta it gave ->
    (dk, dv) (B,S,Hkv,D), each summed over its group of query heads."""
    (B, S, Hq, Hkv, D), lse = _bwd_inputs(q, k, v, lse, do, window)
    check_cuda("delta", delta)
    if delta.dtype != torch.float32 or delta.shape != lse.shape:
        raise ValueError(f"delta must be f32 {tuple(lse.shape)}, got "
                         f"{delta.dtype} {tuple(delta.shape)}")
    delta = delta.contiguous()
    dk = torch.empty((B, S, Hkv, D), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk, dv
    q, k, v, do = (aligned16(t) for t in (q, k, v, do))
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, do) for s in t.stride()[:3]))
    lib = _bwd_lib()
    err = run_on(q.device, lambda stream: lib.swa_attention_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
        do.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S,
        Hq, Hkv, D, strides, int(causal), int(window), 1.0 / math.sqrt(D),
        stream))
    raise_if_failed("swa_attention_bwd_dkdv", err)
    LAUNCHES["swa_attention_bwd_dkdv"] += 1
    return dk, dv


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  causal: bool = True, window: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``attention`` from the forward's o and lse: the dQ
    kernel, then the dK/dV kernel on the same stream -> (dq, dk, dv)."""
    dq, delta = attention_bwd_dq(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    dk, dv = attention_bwd_dkdv(q, k, v, lse, do, delta, causal=causal,
                                window=window)
    return dq, dk, dv
