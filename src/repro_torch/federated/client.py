"""Client-side local training (paper §3.3): plain SGD, E local epochs.

``make_client_update`` builds a function running a fixed number of local
SGD steps over stacked batches with a per-step mask (so ragged client
datasets share one layout) and returning the model DELTA and the mean loss.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

Batch = Dict[str, torch.Tensor]


def to_device(batch: Dict[str, np.ndarray], device) -> Batch:
    """NumPy batch -> tensors on `device`: integer arrays become int64
    (index tensors), the rest float32."""
    return {k: torch.as_tensor(v, dtype=torch.int64 if v.dtype.kind in "iu"
                               else torch.float32).to(device)
            for k, v in batch.items()}


def make_client_update(loss_fn: Callable, client_lr: float,
                       max_grad_norm: float = 10.0) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics).

    Returns f(params, batches, step_mask) -> (delta, mean_loss) where
    batches is a dict of (n_steps, B, ...) stacked tensors and step_mask
    (n_steps,) zeroes out padding steps. A step with mask 0 is skipped: its
    update p - (lr * 0) * g is p exactly for a finite gradient.
    """

    def one_step(params, batch, m: float):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            loss = loss_fn(p, batch)[0]   # the pre-step loss
            g = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            gn = torch.sqrt(sum(torch.sum(torch.square(v.float())) for v in g))
            scale = torch.clamp(torch.full_like(gn, max_grad_norm)
                                / (gn + 1e-9), max=1.0) * m
            new = {k: params[k] - (client_lr * scale) * gk.to(params[k].dtype)
                   for k, gk in zip(p, g)}
        return new, loss.detach() * m

    def client_update(params, batches: Batch, step_mask):
        mask = [float(m) for m in torch.as_tensor(step_mask).tolist()]
        cur, total = params, 0.0
        for i, m in enumerate(mask):
            if m == 0.0:
                continue
            cur, loss = one_step(cur, {k: v[i] for k, v in batches.items()}, m)
            total = total + loss
        delta = {k: cur[k] - params[k] for k in params}
        return delta, total / max(sum(mask), 1.0)

    return client_update


def stack_batches(batches, n_steps: int):
    """Pad a list of batch dicts to n_steps and build the step mask."""
    assert batches, "client has no data"
    batches = batches[:n_steps]
    mask = np.zeros((n_steps,), np.float32)
    mask[: len(batches)] = 1.0
    out = {}
    for k in batches[0]:
        arrs = [b[k] for b in batches]
        while len(arrs) < n_steps:
            arrs.append(np.zeros_like(arrs[0]))
        out[k] = np.stack(arrs)
    return out, mask
