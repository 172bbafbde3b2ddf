"""Config system of the port: the same dataclasses, field names, defaults
and validation as the reference package's ``configs/base.py``, so that a
reference config's ``dataclasses.asdict()`` builds the port's config
unchanged (``model_config_from_dict``)."""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

DENSE = "dense"
MOE = "moe"
SSM = "ssm"          # RWKV6
HYBRID = "hybrid"    # RecurrentGemma (RG-LRU + local attention)
VLM = "vlm"          # vision frontend stub + dense LM
AUDIO = "audio"      # audio frontend stub + encoder-decoder
CHARLM = "charlm"    # the paper's char-aware CNN-LSTM LM

FAMILIES = (DENSE, MOE, SSM, HYBRID, VLM, AUDIO, CHARLM)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description; every field of the reference is kept so
    configs convert both ways, though the port builds only the ``charlm``,
    ``dense`` and ``ssm`` families."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    citation: str = ""
    head_dim: int = 0
    max_context: int = 131072
    moe: Optional[MoEConfig] = None
    sliding_window: int = 0
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    encoder_layers: int = 0
    num_frontend_tokens: int = 0
    char_vocab: int = 0
    char_emb: int = 0
    cnn_filters: Tuple[Tuple[int, int], ...] = ()   # (kernel_width, n_filters)
    lstm_hidden: int = 0
    max_word_len: int = 0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    rope_theta: float = 10000.0

    def __post_init__(self):
        assert self.family in FAMILIES, self.family

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    def param_count(self) -> int:
        """Counted from the port model's own parameter shapes."""
        from repro_torch.models import registry as _m  # lazy, avoids cycle
        return _m.param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models import registry as _m
        return _m.param_count(self, active_only=True)

    def train_flops_per_token(self) -> float:
        """~6*N(active) per token (fwd+bwd)."""
        return 6.0 * self.active_param_count()


@dataclass(frozen=True)
class FederatedConfig:
    mode: str = "sync"
    concurrency: int = 100
    aggregation_goal: int = 80
    local_epochs: int = 1
    client_batch_size: int = 16
    client_lr: float = 0.1
    server_lr: float = 0.01
    server_optimizer: str = "adam"
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    staleness_cap: int = 16
    staleness_exponent: float = 0.5
    client_timeout_s: float = 240.0
    dropout_rate: float = 0.05
    over_selection: float = 1.0
    seed: int = 0
    compression: str = "none"           # "none" | "int8"
    quant_block: int = 256
    carbon_topk: int = 6
    carbon_explore: float = 0.1
    retry_limit: int = 0
    retry_backoff_s: float = 30.0
    min_report_fraction: float = 0.0
    starvation_patience: int = 0
    checkpoint_period_s: float = 0.0
    over_select_fraction: float = 0.0

    def __post_init__(self):
        if self.mode not in ("sync", "async", "carbon-aware"):
            raise ValueError(f"unknown federated mode {self.mode!r}; "
                             "known: 'sync', 'async', 'carbon-aware'")
        if self.concurrency < 1:
            raise ValueError(
                f"concurrency must be >= 1, got {self.concurrency!r}")
        if self.aggregation_goal < 1:
            raise ValueError(f"aggregation_goal must be >= 1, got "
                             f"{self.aggregation_goal!r}")
        if self.aggregation_goal > self.concurrency:
            raise ValueError(
                f"aggregation_goal ({self.aggregation_goal}) cannot exceed "
                f"concurrency ({self.concurrency})")
        if not 0.0 <= self.dropout_rate <= 1.0:
            raise ValueError("dropout_rate must be a probability in "
                             f"[0, 1], got {self.dropout_rate!r}")
        if self.client_timeout_s <= 0:
            raise ValueError(f"client_timeout_s must be > 0, got "
                             f"{self.client_timeout_s!r}")
        if self.carbon_topk < 1:
            raise ValueError(
                f"carbon_topk must be >= 1, got {self.carbon_topk!r}")
        if not 0.0 <= self.carbon_explore <= 1.0:
            raise ValueError("carbon_explore must be a probability in "
                             f"[0, 1], got {self.carbon_explore!r}")
        if self.retry_limit < 0:
            raise ValueError(
                f"retry_limit must be >= 0, got {self.retry_limit!r}")
        if self.retry_backoff_s < 0:
            raise ValueError(f"retry_backoff_s must be >= 0, got "
                             f"{self.retry_backoff_s!r}")
        if not 0.0 <= self.min_report_fraction <= 1.0:
            raise ValueError("min_report_fraction must be in [0, 1], got "
                             f"{self.min_report_fraction!r}")
        if self.starvation_patience < 0:
            raise ValueError(f"starvation_patience must be >= 0, got "
                             f"{self.starvation_patience!r}")
        if not (math.isfinite(self.checkpoint_period_s)
                and self.checkpoint_period_s >= 0):
            raise ValueError(f"checkpoint_period_s must be finite and >= 0, "
                             f"got {self.checkpoint_period_s!r}")
        if not (math.isfinite(self.over_select_fraction)
                and self.over_select_fraction >= 0):
            raise ValueError(f"over_select_fraction must be finite and >= 0, "
                             f"got {self.over_select_fraction!r}")


@dataclass(frozen=True)
class RunConfig:
    target_perplexity: float = 175.0
    patience_rounds: int = 5
    max_hours: float = 48.0
    max_rounds: int = 10_000
    eval_every: int = 1
    eval_clients: int = 20              # paper: 20 held-out clients
    ema_alpha: float = 0.3
    telemetry: str = "full"             # "full" | "streaming"
    telemetry_sample: int = 4096

    def __post_init__(self):
        assert self.telemetry in ("full", "streaming")
        assert self.telemetry_sample > 0


def normalize_model_kwargs(d: dict) -> dict:
    """JSON round-trips turn tuples into lists and MoEConfig into a dict;
    convert the affected ModelConfig fields back (no-op when absent)."""
    d = dict(d)
    if isinstance(d.get("moe"), dict):
        d["moe"] = MoEConfig(**d["moe"])
    if "block_pattern" in d:
        d["block_pattern"] = tuple(d["block_pattern"])
    if "cnn_filters" in d:
        d["cnn_filters"] = tuple(tuple(f) for f in d["cnn_filters"])
    return d


def model_config_to_dict(cfg: ModelConfig) -> dict:
    return dataclasses.asdict(cfg)


def model_config_from_dict(d: dict) -> ModelConfig:
    return ModelConfig(**normalize_model_kwargs(d))


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
            heads: int = 4, kv_heads: int = 0, d_ff: int = 512,
            vocab: int = 512, experts: int = 4) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests (<=4 experts, d<=512)."""
    kv = kv_heads or max(1, heads // 2)
    changes = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=0 if cfg.family == SSM else heads,
        num_kv_heads=0 if cfg.family == SSM else kv,
        d_ff=d_ff,
        vocab_size=vocab,
        max_context=2048,
    )
    if cfg.moe is not None:
        changes["moe"] = MoEConfig(num_experts=min(experts, cfg.moe.num_experts),
                                   top_k=min(2, cfg.moe.top_k))
    if cfg.sliding_window:
        changes["sliding_window"] = 64
    if cfg.block_pattern:
        changes["block_pattern"] = cfg.block_pattern
    if cfg.lru_width:
        changes["lru_width"] = d_model
    if cfg.encoder_layers:
        changes["encoder_layers"] = 2
    if cfg.num_frontend_tokens:
        changes["num_frontend_tokens"] = 16
    if cfg.family == CHARLM:
        changes.update(num_heads=0, num_kv_heads=0, char_vocab=64, char_emb=16,
                       cnn_filters=((2, 16), (3, 16)), lstm_hidden=d_model,
                       max_word_len=12)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **changes)
