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
    """Simulate the int8 uplink: quantize + dequantize each leaf. On the
    card the whole delta is one K1 launch over its table of leaves and one
    K2 launch (the dequantize) over the concatenated layout. Each leaf is
    quantized in its own blocks as one flat tensor, so for stacked (N, ...)
    cohort deltas a block may span the rows of several clients, as it does
    in the reference, but never two leaves."""
    if not delta:
        return {}
    leaves = list(delta.values())
    q, s, views = q8.quantize_many(leaves, block=block)
    flat = q8.dequantize(q, s, (q.numel(),), block=block)
    out, a = {}, 0
    for k, x, (qk, _) in zip(delta, leaves, views):
        out[k] = flat[a:a + x.numel()].reshape(x.shape).to(x.dtype)
        a += qk.numel()
    return out


def weighted_mean_deltas(deltas: Dict[str, torch.Tensor],
                         weights: torch.Tensor) -> Dict[str, torch.Tensor]:
    """deltas: dict of (N, ...) stacked client deltas; weights: (N,)."""
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    return {k: torch.sum(v * w.reshape((-1,) + (1,) * (v.dim() - 1)), dim=0)
            for k, v in deltas.items()}


def fedbuff_weights(staleness: Sequence[int], alpha: float) -> np.ndarray:
    s = np.asarray(staleness, np.float64)
    return (1.0 + s) ** (-alpha)
