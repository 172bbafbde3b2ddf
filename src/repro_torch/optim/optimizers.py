"""Client SGD and the FedAdam server optimizer over flat param dicts.

The paper (§3.3): clients run plain SGD (no momentum, no extra on-device
state); the server runs Adam on the aggregated model delta ("FedAdam",
Reddi et al. 2021). Updates are functional, like the reference's: they
return new dicts and never write into the tensors they are given.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]
State = Dict[str, object]


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], State]
    update: Callable[[Params, State, Params], Tuple[Params, State]]
    # update(grads, state, params) -> (new_params, new_state)


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return {"step": _step0()}

    def update(grads, state, params):
        new = {k: params[k] - lr * grads[k].to(params[k].dtype) for k in params}
        return new, {"step": state["step"] + 1}

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"step": _step0(),
                "m": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(grads, state, params):
        m = {k: beta * state["m"][k] + grads[k].to(state["m"][k].dtype)
             for k in params}
        new = {k: params[k] - lr * m[k].to(params[k].dtype) for k in params}
        return new, {"step": state["step"] + 1, "m": m}

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam with f32 moments regardless of param dtype; the bias
    corrections are f32 powers, and eps sits outside the sqrt."""

    def init(params):
        return {
            "step": _step0(),
            "m": {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                  for k, v in params.items()},
            "v": {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                  for k, v in params.items()},
        }

    def update(grads, state, params):
        t = state["step"] + 1
        tf = t.to(torch.float32)
        c1 = 1.0 - b1 ** tf
        c2 = 1.0 - b2 ** tf
        m, v, new = {}, {}, {}
        for k in params:
            p = params[k]
            # 0-dim device tensors: true division on the card, not a product
            # with a host scalar's reciprocal
            d1, d2 = c1.to(p.device), c2.to(p.device)
            g = grads[k].to(torch.float32)
            m[k] = b1 * state["m"][k] + (1 - b1) * g
            v[k] = b2 * state["v"][k] + (1 - b2) * torch.square(g)
            upd = (m[k] / d1) / (torch.sqrt(v[k] / d2) + eps)
            new[k] = (p.to(torch.float32) - lr * upd).to(p.dtype)
        return new, {"step": t, "m": m, "v": v}

    return Optimizer(init, update)


def server_optimizer(name: str, lr: float, *, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    if name == "adam":
        return adam(lr, b1, b2, eps)
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr, b1)
    raise ValueError(name)
