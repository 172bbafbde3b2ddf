"""PyTorch/CUDA port of the Green Federated Learning system.

It mirrors the module paths of the JAX reference package ``repro`` and
imports nothing from it. Entry points run on the GPU unless the caller asks
for the CPU, where the hand-written kernels are replaced by their plain
PyTorch versions.
"""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """The device an entry point runs on. Asking for CUDA without a card
    raises; nothing falls back to the CPU unless ``device="cpu"`` is given."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU with the plain versions of the "
                           "kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
