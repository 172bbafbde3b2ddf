"""ctypes wrapper of the decode-attention CUDA kernel
(``csrc/decode_attention.cu``).

K4 ``decode_attention`` replaces the TPU kernel ``decode_attention_pallas``
(the reference's ``kernels/decode_attention/kernel.py``). One call is one
launch: each block streams one split of one (batch, kv head)'s cache, and
the last block of each group combines the group's partials (see the
source's note). ``plan_splits`` picks the split length on the host. The
wrapper takes CUDA tensors only, checks what the kernel cannot take,
allocates the output and one scratch buffer (the partials), keeps
the kernel's arrival counters in one zeroed buffer per device, launches on
PyTorch's current stream without synchronising, raises if the launch was
refused, and adds one to ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import math
import numbers
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import (DTYPES, HEAD_DIMS, aligned16,
                                        check_cuda, raise_if_failed, run_on)

LAUNCHES = {"decode_attention": 0}
MAX_GROUP = 16            # query heads per kv head (kMaxG in the source)
TILE = 32                 # cache slots per tile (kTile in the source)
MAX_SPLITS = 32           # splits per (batch, kv head) (kMaxSplits)
H100_SMS = 132
WAVES = 4                 # blocks the grid aims at, in multiples of the SMs

_c = ctypes.c_void_p
_i = ctypes.c_int
_COUNTERS: Dict[torch.device, torch.Tensor] = {}
_SMS: Dict[torch.device, int] = {}


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0


def plan_splits(B: int, C: int, Hkv: int,
                sms: int = H100_SMS) -> Tuple[int, int]:
    """(split_len, n_split) for a cache of C slots: splits of a multiple of
    TILE slots, enough of them that the (split, B * Hkv) grid is about
    WAVES blocks an SM, and at most MAX_SPLITS. Split s covers slots
    [s * split_len, min((s + 1) * split_len, C)); together they cover
    [0, C) once, none of them empty."""
    if B <= 0 or C <= 0 or Hkv <= 0:
        raise ValueError(f"plan_splits needs B, C, Hkv > 0, got {B, C, Hkv}")
    want = min(MAX_SPLITS, -(-WAVES * sms // (B * Hkv)))
    split = -(-C // want)
    split = -(-split // TILE) * TILE
    return split, -(-C // split)


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    if not getattr(lib, "_typed", False):
        if lib.decode_attention_tile() != TILE:
            raise RuntimeError("decode_attention.cu's tile differs from TILE")
        lib.decode_attention_fwd.argtypes = [
            _c, _c, _c, _c, _i, _c, _c, _c, _c, _c, _i, _i, _i, _i, _i, _i,
            _i, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _c]
        lib.decode_attention_fwd.restype = _i
        lib._typed = True
    return lib


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """The device's arrival counters (int32 zeros, left zero by every
    launch), grown to at least n."""
    buf = _COUNTERS.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = buf
    return buf


def _sm_count(dev: torch.device) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len) -> torch.Tensor:
    """K4: q (B,Hq,D), caches (B,C,Hkv,D), f32 or bf16, any strides with a
    contiguous last dimension; valid_len an int, or a 0-d or (B,) integer
    tensor on q's device -> (B,Hq,D) contiguous, in q's dtype."""
    for name, t, nd in (("q", q, 3), ("k_cache", k_cache, 4),
                        ("v_cache", v_cache, 4)):
        check_cuda(name, t)
        if t.dim() != nd:
            raise ValueError(f"{name} must have {nd} dimensions, got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {q.dtype}")
    B, C, Hkv, D = k_cache.shape
    Hq = q.shape[1]
    if tuple(q.shape) != (B, Hq, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"q {tuple(q.shape)}, k_cache "
                         f"{tuple(k_cache.shape)} and v_cache "
                         f"{tuple(v_cache.shape)} do not agree")
    if Hkv == 0 or Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}, at most "
                         f"{MAX_GROUP} times it")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    dev = q.device
    if isinstance(valid_len, numbers.Integral):
        vl_t, vl_scalar = None, max(0, min(int(valid_len), C))
    else:
        check_cuda("valid_len", valid_len)
        if valid_len.dim() > 1 or (valid_len.dim() == 1
                                   and valid_len.shape[0] != B):
            raise ValueError(f"valid_len must be a scalar or ({B},), got "
                             f"{tuple(valid_len.shape)}")
        vl_t, vl_scalar = valid_len, 0
        if not (vl_t.dtype == torch.int32 and vl_t.dim() == 1
                and vl_t.device == dev and vl_t.is_contiguous()):
            vl_t = vl_t.to(device=dev, dtype=torch.int32).expand(B)
            vl_t = vl_t.contiguous()
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=dev)
    if out.numel() == 0 or C == 0:
        return out.zero_()
    k_cache, v_cache = aligned16(k_cache), aligned16(v_cache)
    lib = _lib()
    split, n_split = plan_splits(B, C, Hkv, _sm_count(dev))
    n = B * Hq * n_split
    part = torch.empty((n * (D + 2),), dtype=torch.float32, device=dev)
    pm = part.data_ptr()
    counters = _counters(dev, B * Hkv)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(1), *k_cache.stride()[:3],
        *v_cache.stride()[:3])
    err = run_on(dev, lambda stream: lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if vl_t is None else vl_t.data_ptr(), vl_scalar,
        out.data_ptr(), pm, pm + 4 * n, pm + 8 * n, counters.data_ptr(), B,
        C, Hq, Hkv, D,
        DTYPES[q.dtype], split, strides, 1.0 / math.sqrt(D), stream))
    raise_if_failed("decode_attention", err)
    LAUNCHES["decode_attention"] += 1
    return out
