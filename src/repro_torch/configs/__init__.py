from repro_torch.configs.base import (
    FederatedConfig, ModelConfig, MoEConfig, RunConfig,
    model_config_from_dict, normalize_model_kwargs, reduced,
)
from repro_torch.configs.registry import ALL_ARCHS, get_config
