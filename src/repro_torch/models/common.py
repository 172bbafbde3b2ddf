"""Shared layer library of the port: the part of the reference's
``models/common.py`` that the char-CNN-LSTM needs.

Params are FLAT dicts ``{"path/to/weight": tensor}`` with the reference's
keys, plus a parallel dict of logical axes built at init time.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]
Axes = Dict[str, Tuple[Optional[str], ...]]


class ParamBuilder:
    """Collects params + their logical axes. Draws come from a CPU
    ``torch.Generator``, so an init is the same on every device; on the
    ``meta`` device nothing is drawn or allocated (shapes only)."""

    def __init__(self, generator: Optional[torch.Generator],
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cpu"):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)
        self.params: Params = {}
        self.axes: Axes = {}

    def param(self, path: str, shape: Sequence[int],
              axes: Sequence[Optional[str]], init: str = "normal",
              scale: Optional[float] = None) -> None:
        assert len(shape) == len(axes), (path, shape, axes)
        assert path not in self.params, path
        shape = tuple(int(s) for s in shape)
        if init not in ("normal", "zeros", "ones", "uniform"):
            raise ValueError(init)
        if self.device.type == "meta":
            w = torch.empty(shape, dtype=self.dtype, device="meta")
        elif init == "normal":
            if scale is None:
                scale = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
            w = torch.randn(shape, generator=self.generator,
                            dtype=self.dtype) * scale
        elif init == "zeros":
            w = torch.zeros(shape, dtype=self.dtype)
        elif init == "ones":
            w = torch.ones(shape, dtype=self.dtype)
        else:
            s = scale or 1.0
            w = (torch.rand(shape, generator=self.generator,
                            dtype=self.dtype) * 2.0 - 1.0) * s
        self.params[path] = w.to(self.device)
        self.axes[path] = tuple(axes)

    def build(self) -> Tuple[Params, Axes]:
        return self.params, self.axes


def _chunk_nll_sum(xc: torch.Tensor, w: torch.Tensor, yc: torch.Tensor,
                   mc: torch.Tensor) -> torch.Tensor:
    lg = xc.float() @ w.float()                                  # (B, c, V)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, yc[..., None]).squeeze(-1)
    return torch.sum((logz - gold) * mc)


def lm_loss(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None, chunk: int = 256
            ) -> torch.Tensor:
    """Next-token cross-entropy WITHOUT materializing (B, S, V) logits.

    x: (B, S, d) final hidden states; w: (d, V) unembedding; labels:
    (B, S) int. Mean nll of labels[:, 1:] given x[:, :-1] over the
    optional (B, S-1) mask. The sequence is cut into `chunk`-sized slices
    whose logits are recomputed in the backward pass (activation
    checkpointing), so peak logits memory is (B, chunk, V).
    """
    xs = x[:, :-1, :]
    ys = labels[:, 1:].long()
    n = xs.shape[1]
    m = (mask if mask is not None
         else torch.ones(ys.shape, device=x.device)).float()
    tot = torch.zeros((), device=x.device)
    for lo in range(0, n, chunk):
        args = (xs[:, lo:lo + chunk], w, ys[:, lo:lo + chunk],
                m[:, lo:lo + chunk])
        if torch.is_grad_enabled():
            tot = tot + checkpoint(_chunk_nll_sum, *args, use_reentrant=False)
        else:
            tot = tot + _chunk_nll_sum(*args)
    return tot / torch.clamp(torch.sum(m), min=1.0)
