from repro_torch.models.registry import get_model, param_count
