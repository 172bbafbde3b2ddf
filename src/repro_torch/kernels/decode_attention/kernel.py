"""ctypes wrapper of the decode-attention CUDA kernels
(``csrc/decode_attention.cu``).

K4 ``decode_attention`` replaces the TPU kernel ``decode_attention_pallas``
(the reference's ``kernels/decode_attention/kernel.py``). One call launches
the split-K partial kernel and its combine kernel and counts as one launch
of K4 in ``LAUNCHES``. It takes CUDA tensors only, checks what the kernels
cannot take, allocates the output and the partials, launches on PyTorch's
current stream without synchronising and raises if a launch was refused.
"""
from __future__ import annotations

import ctypes
import math
import numbers

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_cuda, raise_if_failed
from repro_torch.kernels.swa_attention.kernel import DTYPES, HEAD_DIMS

LAUNCHES = {"decode_attention": 0}
MAX_GROUP = 16            # query heads per kv head (kMaxG in the source)

_c = ctypes.c_void_p
_i = ctypes.c_int


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    if not getattr(lib, "_typed", False):
        lib.decode_attention_chunk.argtypes = []
        lib.decode_attention_chunk.restype = _i
        lib.decode_attention_fwd.argtypes = [
            _c, _c, _c, _c, _i, _c, _c, _c, _c, _i, _i, _i, _i, _i, _i,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _c]
        lib.decode_attention_fwd.restype = _i
        lib._typed = True
    return lib


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
    if isinstance(valid_len, numbers.Integral):
        vl_t, vl_scalar = None, max(0, min(int(valid_len), C))
    else:
        check_cuda("valid_len", valid_len)
        if valid_len.dim() > 1 or (valid_len.dim() == 1
                                   and valid_len.shape[0] != B):
            raise ValueError(f"valid_len must be a scalar or ({B},), got "
                             f"{tuple(valid_len.shape)}")
        vl_t = valid_len.to(device=q.device, dtype=torch.int32)
        vl_t = vl_t.expand(B).contiguous()
        vl_scalar = 0
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or C == 0:
        return out.zero_()
    lib = _lib()
    n = B * Hq * -(-C // lib.decode_attention_chunk())
    part = torch.empty((n * (D + 2),), dtype=torch.float32, device=q.device)
    pm = part.data_ptr()
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(1), *k_cache.stride()[:3],
        *v_cache.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attention_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            None if vl_t is None else vl_t.data_ptr(), vl_scalar,
            out.data_ptr(), pm, pm + 4 * n, pm + 8 * n, B, C, Hq, Hkv, D,
            DTYPES[q.dtype], strides, 1.0 / math.sqrt(D), stream)
    raise_if_failed("decode_attention", err)
    LAUNCHES["decode_attention"] += 1
    return out
