"""Shared layer library of the port: the part of the reference's
``models/common.py`` that the char-CNN-LSTM, the dense transformer and
RWKV6 need. Attention goes through the hand-written kernels' ``ops`` (K3
for prefill and training, with its backward kernels for the gradient; K4
for decode), which take their plain versions on CPU tensors.

Params are FLAT dicts ``{"path/to/weight": tensor}`` with the reference's
keys, plus a parallel dict of logical axes built at init time.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attention import ops as _decode_ops
from repro_torch.kernels.swa_attention import autograd as _attn_grad
from repro_torch.kernels.swa_attention import ops as _attn_ops

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
            # scaled in place: one host copy of the largest weight, not two
            w = torch.randn(shape, generator=self.generator,
                            dtype=self.dtype).mul_(scale)
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


def layer_params(params: Params) -> List[Dict[str, torch.Tensor]]:
    """The stacked ``blocks/*`` params as one dict of views per layer."""
    blocks = {k.split("/", 1)[1]: v for k, v in params.items()
              if k.startswith("blocks/")}
    n = next(iter(blocks.values())).shape[0]
    return [{k: v[l] for k, v in blocks.items()} for l in range(n)]


def project_heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", h, w) as one matrix product."""
    d, H, hd = w.shape
    return (h @ w.reshape(d, H * hd)).view(*h.shape[:-1], H, hd)


def merge_heads(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") (or "bhk,hkd->bd") as one matrix product."""
    H, hd, d = w.shape
    return a.reshape(*a.shape[:-2], H * hd) @ w.reshape(H * hd, d)


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
    checkpointing), so peak logits memory is (B, chunk, V). A sequence of
    one chunk is not checkpointed: that would save nothing, and
    ``torch.func`` (the vmapped cohort step) cannot differentiate through a
    checkpoint.
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
        if n > chunk and torch.is_grad_enabled():
            tot = tot + checkpoint(_chunk_nll_sum, *args, use_reentrant=False)
        else:
            tot = tot + _chunk_nll_sum(*args)
    return tot / torch.clamp(torch.sum(m), min=1.0)


# ---------------------------------------------------------------------------
# Norms / activations / rope
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm computed in f32, returned in x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin of shape (..., head_dim // 2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate-half RoPE. x: (..., S, H, D); cos/sin: (..., S, D // 2),
    broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (swish(x @ w_gate) * (x @ w_up)) @ w_down


# ---------------------------------------------------------------------------
# Attention (K3 / K4)
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,S,Hq,D); k/v: (B,S,Hkv,D) -> (B,S,Hq,D). Online-softmax
    attention, causal or sliding-window (window > 0) or non-causal; the
    kernel picks its own tiles and takes any S. When a gradient is being
    taken (grad mode on and an input that requires it, as under
    ``torch.func.grad``), the forward also saves each row's log-sum-exp and
    the gradient comes from the backward kernels (``swa_attention/
    autograd.py``); otherwise (serving, eval under ``torch.no_grad()``) it
    is the forward alone."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _attn_grad.attention(q, k, v, causal=causal, window=window)
    return _attn_ops.attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len) -> torch.Tensor:
    """One query position per head against a (B,C,Hkv,D) cache; slots at or
    past valid_len (an int, or a (B,) tensor) are masked -> (B,Hq,D)."""
    return _decode_ops.decode_attention(q, k_cache, v_cache, valid_len)
