"""Plain PyTorch version of single-token GQA decode attention.

The twin of the reference's ``kernels/decode_attention/ref.py::
decode_attention_ref``; the CUDA kernel in ``csrc/decode_attention.cu`` is
held to it, and the CPU path of ``ops`` runs it.
"""
from __future__ import annotations

import math

import torch


def valid_lengths(valid_len, B: int, device) -> torch.Tensor:
    """valid_len as an int or a 0-d or (B,) tensor -> (B,) int64."""
    vl = torch.as_tensor(valid_len, device=device).long()
    if vl.dim() == 0:
        vl = vl.expand(B)
    if tuple(vl.shape) != (B,):
        raise ValueError(f"valid_len must be a scalar or ({B},), got "
                         f"{tuple(vl.shape)}")
    return vl


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, valid_len) -> torch.Tensor:
    """q: (B,Hq,D); caches: (B,C,Hkv,D); valid_len: scalar or (B,) ->
    (B,Hq,D) in q's dtype. Cache slots at or beyond valid_len[b] are
    masked."""
    B, C, Hkv, D = k_cache.shape
    Hq = q.shape[1]
    g = Hq // Hkv
    qf = q.float().reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,bchd->bhgc", qf, k_cache.float()) / math.sqrt(D)
    vl = valid_lengths(valid_len, B, q.device)
    mask = torch.arange(C, device=q.device)[None, :] < vl[:, None]
    s = s.masked_fill(~mask[:, None, None, :], -math.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgc,bchd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, D).to(q.dtype)
