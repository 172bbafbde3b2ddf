"""--arch resolution for the port. Only architectures the port can build
are listed; the rest of the reference's model zoo is not ported yet."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_charlm import CONFIG as _PAPER_CHARLM
from repro_torch.configs.rwkv6_7b import CONFIG as _RWKV6_7B
from repro_torch.configs.smollm_135m import CONFIG as _SMOLLM_135M

_CONFIGS = {"smollm-135m": _SMOLLM_135M, "paper-charlm": _PAPER_CHARLM,
            "rwkv6-7b": _RWKV6_7B}

ALL_ARCHS = tuple(_CONFIGS)


def get_config(name: str) -> ModelConfig:
    try:
        return _CONFIGS[name]
    except KeyError:
        raise KeyError(f"arch {name!r} is not ported yet; the port builds "
                       f"{sorted(_CONFIGS)}") from None
