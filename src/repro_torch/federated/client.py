"""Client-side local training (paper §3.3): plain SGD, E local epochs.

``make_client_update`` builds a function running a fixed number of local
SGD steps over stacked batches with a per-step mask (so ragged client
datasets share one layout) and returning the model DELTA and the mean loss.
``make_cohort_update`` runs the same steps for a whole cohort at once, as
the reference's ``jax.vmap(client_update, in_axes=(None, 0, 0))`` does: one
batched local step over stacked per-client params, which a CUDA device
replays from a CUDA graph captured once per cohort size.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

Batch = Dict[str, torch.Tensor]

GRAPH_COUNTS = {"captures": 0, "replays": 0}   # cohort-step CUDA graphs


def reset_graph_counts() -> None:
    for k in GRAPH_COUNTS:
        GRAPH_COUNTS[k] = 0


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


class _Cohort:
    """The buffers of one cohort size: stacked params (N, ...), the running
    loss sum (N,), one local step's inputs (N, B, ...) and step mask (N,),
    and (on CUDA) the graph of a step that reads and updates them in
    place."""

    def __init__(self, params: Batch, batches: Batch, n_clients: int):
        def empty(shape, like):
            return torch.empty(shape, dtype=like.dtype, device=like.device)
        self.params = {k: empty((n_clients,) + tuple(v.shape), v)
                       for k, v in params.items()}
        self.batch = {k: empty((n_clients,) + tuple(v.shape[2:]), v)
                      for k, v in batches.items()}
        some = next(iter(params.values()))
        self.total = torch.zeros(n_clients, device=some.device)
        self.mask = torch.zeros(n_clients, device=some.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def start(self, params: Batch) -> None:
        for k, v in self.params.items():
            v.copy_(params[k].expand_as(v))
        self.total.zero_()

    def load(self, batches: Batch, masks: torch.Tensor, i: int) -> None:
        for k, v in self.batch.items():
            v.copy_(batches[k][:, i])
        self.mask.copy_(masks[:, i])

    def capture(self, step: Callable[["_Cohort"], None]) -> None:
        """Warm the step up on a side stream, then capture it on that
        stream into a graph with its own memory pool. Both change the
        buffers; the caller refills them."""
        dev = self.total.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(self)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side):
            step(self)
        GRAPH_COUNTS["captures"] += 1


def make_cohort_update(loss_fn: Callable, client_lr: float,
                       max_grad_norm: float = 10.0,
                       graph: bool = True) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics).

    Returns f(params, batches, step_mask) -> (deltas, mean_loss): params is
    one dict of base params shared by the cohort; batches a dict of
    (N, n_steps, B, ...) tensors on the params' device; step_mask an
    (N, n_steps) host array. deltas is a dict of stacked (N, ...) tensors,
    freshly allocated by each call, and mean_loss is (N,).

    One local step is ``make_client_update``'s step under ``torch.func.vmap``:
    each client clips by the norm of its own gradient, and a client whose
    mask is 0 keeps its params exactly (its padding batch is all zeros
    with a zero token mask, so its gradient is finite). Steps run up to the
    last step any client uses. On a CUDA device (unless ``graph`` is False)
    each step is one replay of a CUDA graph, captured at the first call for
    each cohort size and step shape; ``GRAPH_COUNTS`` counts captures and
    replays. Elsewhere the same step runs eagerly.
    """
    grad_and_loss = torch.func.grad_and_value(lambda p, b: loss_fn(p, b)[0])

    def one_step(params, batch, m):
        g, loss = grad_and_loss(params, batch)      # the pre-step loss
        gn = torch.sqrt(sum(torch.sum(torch.square(v.float()))
                            for v in g.values()))
        scale = torch.clamp(torch.full_like(gn, max_grad_norm)
                            / (gn + 1e-9), max=1.0) * m
        new = {k: params[k] - (client_lr * scale) * g[k].to(params[k].dtype)
               for k in params}
        return new, loss * m

    batched_step = torch.func.vmap(one_step)

    def step(c: _Cohort) -> None:
        new, loss = batched_step(c.params, c.batch, c.mask)
        for k, v in c.params.items():
            v.copy_(new[k])
        c.total.add_(loss)

    cohorts: Dict[tuple, _Cohort] = {}

    def cohort_update(params: Batch, batches: Batch, step_mask):
        mask = np.asarray(step_mask, np.float32)
        n_clients = mask.shape[0]
        used = np.flatnonzero(mask.any(axis=0))
        n_steps = int(used[-1]) + 1 if used.size else 0
        some = next(iter(params.values()))
        masks = torch.as_tensor(mask).to(some.device)
        key = (n_clients,) + tuple((k, tuple(v.shape[2:]), v.dtype)
                                   for k, v in batches.items())
        c = cohorts.get(key)
        if c is None:
            c = cohorts[key] = _Cohort(params, batches, n_clients)
        replay = graph and some.device.type == "cuda"
        if replay and c.graph is None and n_steps:
            c.start(params)
            c.load(batches, masks, 0)
            c.capture(step)
        c.start(params)
        for i in range(n_steps):
            c.load(batches, masks, i)
            if replay:
                c.graph.replay()
                GRAPH_COUNTS["replays"] += 1
            else:
                step(c)
        deltas = {k: c.params[k] - params[k] for k in params}
        return deltas, c.total / torch.clamp(masks.sum(dim=1), min=1.0)

    return cohort_update


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
