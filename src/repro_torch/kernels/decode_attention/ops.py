"""Public decode-attention op. Dispatch follows the tensor's device: a CUDA
tensor launches the hand-written kernels (or raises), a CPU tensor takes
the plain PyTorch version in ``ref``. There is no other fallback."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import on_cuda
from repro_torch.kernels.decode_attention import kernel as K
from repro_torch.kernels.decode_attention import ref as R


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len) -> torch.Tensor:
    """q: (B,Hq,D); caches: (B,C,Hkv,D); valid_len: int, 0-d or (B,) ->
    (B,Hq,D)."""
    if on_cuda(q, "decode_attention"):
        return K.decode_attention(q, k_cache, v_cache, valid_len)
    return R.decode_attention_ref(q, k_cache, v_cache, valid_len)
