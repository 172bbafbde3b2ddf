"""Flash attention with a gradient, for training: ``attention`` runs the
forward that saves each row's log-sum-exp (``ops.attention_fwd``: K3 on a
CUDA tensor, the plain version on a CPU one) and differentiates through the
backward kernels (``ops.attention_bwd``).

Both steps are ``torch.autograd.Function``s with a separate
``setup_context`` and a ``vmap`` rule, which is what ``torch.func`` needs:
the learner's cohort step is ``vmap(grad_and_value(loss))``, so the forward
and the backward both run under ``vmap``. Each rule folds the vmapped
dimension into the batch, (N, B, ...) -> (N B, ...), and makes one call for
the whole cohort; an input that is not vmapped is expanded first. The
backward is a second Function, so that its launch too is folded when the
backward runs under ``vmap``. (``torch.library.custom_op`` with
``register_autograd`` does not run under ``torch.func``.)
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.swa_attention import ops


def _fold(info, in_dims: Sequence[Optional[int]], *xs: torch.Tensor):
    """Each x with its vmapped dimension moved to the front (expanded if it
    has none) and merged with its batch dimension."""
    n = info.batch_size
    out = []
    for x, d in zip(xs, in_dims):
        x = x.expand(n, *x.shape) if d is None else x.movedim(d, 0)
        out.append(x.reshape(n * x.shape[1], *x.shape[2:]))
    return out


def _unfold(n: int, *xs: torch.Tensor):
    return tuple(x.reshape(n, x.shape[0] // n, *x.shape[1:]) for x in xs)


class _AttentionBwd(torch.autograd.Function):
    """(q, k, v, o, lse, do) -> (dq, dk, dv); not differentiable again."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal, window):
        if do.stride(-1) != 1:
            do = do.contiguous()
        return ops.attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the second derivative of flash attention "
                                  "is not ported yet")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal, window):
        folded = _fold(info, in_dims[:6], q, k, v, o, lse, do)
        out = _AttentionBwd.apply(*folded, causal, window)
        return _unfold(info.batch_size, *out), (0, 0, 0)


class _Attention(torch.autograd.Function):
    """(q, k, v) -> (o, lse); lse is not differentiable."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return ops.attention_fwd(q, k, v, causal=causal, window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _AttentionBwd.apply(q, k, v, o, lse, do, ctx.causal,
                                         ctx.window)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        folded = _fold(info, in_dims[:3], q, k, v)
        out = _Attention.apply(*folded, causal, window)
        return _unfold(info.batch_size, *out), (0, 0)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,S,Hq,D); k/v: (B,S,Hkv,D) -> o (B,S,Hq,D), differentiable in
    q, k and v (under ``torch.autograd`` and ``torch.func``)."""
    return _Attention.apply(q, k, v, causal, window)[0]
