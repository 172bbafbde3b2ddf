"""Public WKV op. Dispatch follows the tensor's device: a CUDA tensor
launches the hand-written kernel K5 (or raises), a CPU tensor takes the
plain PyTorch version in ``ref``. There is no other fallback."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels._build import on_cuda
from repro_torch.kernels.wkv import kernel as K
from repro_torch.kernels.wkv import ref as R


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (B,T,H,D); u: (H,D) or (B,H,D); state: (B,H,D,D) f32 ->
    (o (B,T,H,D) in r's dtype, state). The state is UPDATED IN PLACE to
    S_T on either device; the returned state is the tensor given."""
    if on_cuda(r, "wkv"):
        return K.wkv(r, k, v, w, u, state)
    o, s = R.wkv_batched_ref(r, k, v, w, u, state)
    state.copy_(s)
    return o, state
