"""Server-side aggregation + the int8 uplink.

Sync (FedAvg): example-weighted mean of client deltas.
Async (FedBuff): staleness-scaled mean over the buffer, weight
(1+staleness)^-alpha (Nguyen et al. 2022).

Wire compression (paper §6 lever): deltas optionally round-trip through the
blockwise-int8 codec (``kernels/int8_quant``) before entering the buffer,
like a production uplink, so its quality effect is part of training.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.kernels.int8_quant import ops as q8


def compress_roundtrip(delta: Dict[str, torch.Tensor], block: int = 256
                       ) -> Dict[str, torch.Tensor]:
    """Simulate the int8 uplink: quantize + dequantize each leaf (one K1 and
    one K2 launch per leaf on the card). Each leaf is quantized as one flat
    tensor, so for stacked (N, ...) cohort deltas a block may span the rows
    of several clients, as it does in the reference."""
    return {k: q8.quant_dequant(v, block=block) for k, v in delta.items()}


def weighted_mean_deltas(deltas: Dict[str, torch.Tensor],
                         weights: torch.Tensor) -> Dict[str, torch.Tensor]:
    """deltas: dict of (N, ...) stacked client deltas; weights: (N,)."""
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    return {k: torch.sum(v * w.reshape((-1,) + (1,) * (v.dim() - 1)), dim=0)
            for k, v in deltas.items()}


def fedbuff_weights(staleness: Sequence[int], alpha: float) -> np.ndarray:
    s = np.asarray(staleness, np.float64)
    return (1.0 + s) ** (-alpha)
