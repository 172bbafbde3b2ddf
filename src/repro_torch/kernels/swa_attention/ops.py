"""Public attention ops. Dispatch follows the tensor's device: a CUDA tensor
launches the hand-written kernel (or raises), a CPU tensor takes the plain
PyTorch version in ``ref``. There is no other fallback."""
from __future__ import annotations

from typing import Tuple

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


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (o (B,S,Hq,D), lse (B,Hq,S) f32): the forward training saves."""
    if on_cuda(q, "attention_fwd"):
        return K.attention_fwd(q, k, v, causal=causal, window=window)
    return R.attention_fwd_ref(q, k, v, causal=causal, window=window)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  causal: bool = True, window: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``attention`` from the forward's o and lse ->
    (dq, dk, dv)."""
    if on_cuda(q, "attention_bwd"):
        return K.attention_bwd(q, k, v, o, lse, do, causal=causal,
                               window=window)
    return R.attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                               window=window)
