"""Model construction + parameter accounting for the families the port
builds (only ``charlm`` so far)."""
from __future__ import annotations

from repro_torch.configs.base import CHARLM, ModelConfig


def get_model(cfg: ModelConfig):
    from repro_torch.models.charlm import CharLM
    if cfg.family == CHARLM:
        return CharLM(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} ({cfg.name}) is not ported yet")


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count from the model's shapes, with no allocation
    (the init runs on the ``meta`` device)."""
    params, _ = get_model(cfg).init(device="meta")
    return sum(p.numel() for p in params.values())
