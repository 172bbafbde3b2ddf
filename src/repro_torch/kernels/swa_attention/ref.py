"""Plain PyTorch version of (sliding-window) causal GQA attention.

The twin of the reference's ``kernels/swa_attention/ref.py::attention_ref``:
it materialises the full (S, S) score matrix in f32, so it is for tests and
for holding the CUDA kernel in ``csrc/swa_attention.cu`` to its semantics;
the CPU path of ``ops`` runs it. ``attention_fwd_ref`` also gives each
row's log-sum-exp, and ``attention_bwd_ref`` the gradient from it: the
plain versions of the forward that training saves and of the backward
kernels (``csrc/swa_attention_bwd.cu``).
"""
from __future__ import annotations

import math
from typing import Tuple

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


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int):
    """The scaled f32 scores (B, Hkv, g, S, S), masked to -inf, and the
    mask; query head h reads kv head h // g."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / math.sqrt(D)
    pos_q = torch.arange(S, device=q.device)[:, None]
    pos_k = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_k <= pos_q
    if window:
        mask &= pos_k > pos_q - window
    return s.masked_fill(~mask, -math.inf), mask


def attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``attention_ref`` and the natural log-sum-exp of each row's scaled
    scores: -> (o (B,S,Hq,D) in q's dtype, lse (B,Hq,S) f32). A row with no
    key has lse -inf and o 0."""
    B, S, Hq, D = q.shape
    s, _ = _scores(q, k, causal, window)
    lse = torch.logsumexp(s, dim=-1)                         # (B,Hkv,g,S)
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)  # as attention_ref
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, S, Hq, D).to(q.dtype), lse.reshape(B, Hq, S)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True, window: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``attention_ref`` from the forward's o and lse,
    written out from the formulas (not by autograd), in f32:

        D_i = sum_d do_id o_id          P = exp(S scale - lse)
        dV = P^T dO                     dP = dO V^T
        dS = P (dP - D)                 dQ = dS K scale,  dK = dS^T Q scale

    with dK and dV summed over each kv head's group of query heads. ->
    (dq, dk, dv) in the inputs' shapes and dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    s, mask = _scores(q, k, causal, window)
    lse = lse.float().reshape(B, Hkv, g, S)
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
    dof = do.float().reshape(B, S, Hkv, g, D)
    delta = torch.einsum("bqhgd,bqhgd->bhgq", dof,
                         o.float().reshape(B, S, Hkv, g, D))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds,
                      q.float().reshape(B, S, Hkv, g, D)) * scale
    return (dq.reshape(B, S, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
