"""Model construction + parameter accounting for the families the port
builds (``charlm``, ``dense`` and ``ssm`` so far)."""
from __future__ import annotations

from repro_torch.configs.base import CHARLM, DENSE, SSM, ModelConfig


def get_model(cfg: ModelConfig, *, decode_window: int = 0):
    from repro_torch.models.charlm import CharLM
    from repro_torch.models.rwkv import RWKV6
    from repro_torch.models.transformer import DecoderLM
    if cfg.family == DENSE:
        return DecoderLM(cfg, decode_window=decode_window)
    if cfg.family == SSM:
        return RWKV6(cfg)
    if cfg.family == CHARLM:
        return CharLM(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} ({cfg.name}) is not ported yet")


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from the model's shapes, with no allocation
    (the init runs on the ``meta`` device). ``active_only`` counts the
    ``experts`` leaves at ``top_k / num_experts`` of their size, as the
    reference does."""
    params, axes = get_model(cfg).init(device="meta")
    total = 0.0
    for k, p in params.items():
        n = p.numel()
        if active_only and cfg.moe is not None and "experts" in axes[k]:
            n *= cfg.moe.top_k / cfg.moe.num_experts
        total += n
    return int(total)
