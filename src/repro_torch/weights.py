"""Parameter transfer between the JAX reference package and the port.

Both packages keep flat ``{"path": array}`` dicts with the same keys and
shapes, so a transfer is key by key; the JAX side hands over NumPy arrays
(``jax.device_get``), so nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model


def params_from_jax(arrays: Dict[str, np.ndarray], device,
                    cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """NumPy params (from the JAX model's init or a JAX learner) -> the
    port's params on `device`. Raises unless the keys and shapes are
    exactly those of the port's model for `cfg`."""
    want, _ = get_model(cfg).init(device="meta")
    if set(arrays) != set(want):
        raise ValueError(f"param keys differ: missing "
                         f"{sorted(set(want) - set(arrays))}, unexpected "
                         f"{sorted(set(arrays) - set(want))}")
    out = {}
    for k, w in want.items():
        a = np.asarray(arrays[k])
        if a.shape != tuple(w.shape):
            raise ValueError(f"{k}: shape {a.shape} != {tuple(w.shape)}")
        out[k] = torch.tensor(a, dtype=torch.float32, device=device)
    return out


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
