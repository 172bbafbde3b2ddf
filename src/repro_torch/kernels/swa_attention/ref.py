"""Plain PyTorch version of (sliding-window) causal GQA attention.

The twin of the reference's ``kernels/swa_attention/ref.py::attention_ref``:
it materialises the full (S, S) score matrix in f32, so it is for tests and
for holding the CUDA kernel in ``csrc/swa_attention.cu`` to its semantics;
the CPU path of ``ops`` runs it.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,S,Hq,D); k/v: (B,S,Hkv,D) -> (B,S,Hq,D) in q's dtype. Query
    head h reads kv head h // (Hq // Hkv); with a window, query i sees keys
    j with i - window < j (and j <= i when causal)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qf = q.float().reshape(B, S, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / math.sqrt(D)
    pos_q = torch.arange(S, device=q.device)[:, None]
    pos_k = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_k <= pos_q
    if window:
        mask &= pos_k > pos_q - window
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)         # rows with no key give 0
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, S, Hq, D).to(q.dtype)
