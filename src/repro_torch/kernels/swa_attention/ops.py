"""Public attention op. Dispatch follows the tensor's device: a CUDA tensor
launches the hand-written kernel (or raises), a CPU tensor takes the plain
PyTorch version in ``ref``. There is no other fallback."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import on_cuda
from repro_torch.kernels.swa_attention import kernel as K
from repro_torch.kernels.swa_attention import ref as R


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,S,Hq,D); k/v: (B,S,Hkv,D) -> (B,S,Hq,D)."""
    if on_cuda(q, "attention"):
        return K.attention(q, k, v, causal=causal, window=window)
    return R.attention_ref(q, k, v, causal=causal, window=window)
