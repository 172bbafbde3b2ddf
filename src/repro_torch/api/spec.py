"""Declarative experiment descriptions: `ModelRef` + `ExperimentSpec`.

A spec is a frozen, JSON-round-trippable value: model reference (registry
arch id or inline config, plus reduced/override knobs), the federated and
run configs, the `Environment` bundle (including the time-varying
`intensity_schedule` / `intensity_phase_h` grid curves), and the learner
choice. Specs are shareable artifacts — serialize one, hand it to a
colleague (or a CI smoke job), and re-running it with the same seed
reproduces the same `Result.summary()`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

from repro_torch.configs.base import (FederatedConfig, ModelConfig, RunConfig,
                                model_config_from_dict, model_config_to_dict,
                                normalize_model_kwargs)
from repro_torch.configs.base import reduced as _reduced
from repro_torch.api.environment import Environment

LEARNERS = ("surrogate", "real")


def _json_canon(d: Optional[Mapping]) -> Optional[dict]:
    """Canonicalize a mapping to its JSON form (tuples -> lists) so that a
    spec built in-process compares equal to itself after a JSON hop."""
    return None if d is None else json.loads(json.dumps(dict(d)))


@dataclass(frozen=True)
class ModelRef:
    """A model-zoo reference (``arch``) or an inline ``config`` dict, plus
    optional `reduced()` shrinking and field overrides, resolved lazily to a
    concrete ModelConfig."""

    arch: str = ""
    config: Optional[Mapping[str, Any]] = None   # inline ModelConfig dict
    reduced: bool = False
    reduced_kw: Mapping[str, int] = field(default_factory=dict)
    overrides: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        assert self.arch or self.config, "ModelRef needs arch or config"
        object.__setattr__(self, "config", _json_canon(self.config))
        object.__setattr__(self, "reduced_kw", _json_canon(self.reduced_kw))
        object.__setattr__(self, "overrides", _json_canon(self.overrides))

    @classmethod
    def from_config(cls, cfg: ModelConfig, **kw) -> "ModelRef":
        return cls(config=model_config_to_dict(cfg), **kw)

    def resolve(self) -> ModelConfig:
        if self.config is not None:
            base = model_config_from_dict(dict(self.config))
        else:
            from repro_torch.configs.registry import get_config  # lazy: heavy dep
            base = get_config(self.arch)
        if self.reduced:
            base = _reduced(base, **dict(self.reduced_kw))
        if self.overrides:
            base = dataclasses.replace(
                base, **normalize_model_kwargs(dict(self.overrides)))
        return base

    def to_dict(self) -> dict:
        out: dict = {}
        if self.arch:
            out["arch"] = self.arch
        if self.config is not None:
            out["config"] = dict(self.config)
        if self.reduced:
            out["reduced"] = True
        if self.reduced_kw:
            out["reduced_kw"] = dict(self.reduced_kw)
        if self.overrides:
            out["overrides"] = dict(self.overrides)
        return out

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ModelRef":
        return cls(**dict(d))


@dataclass(frozen=True)
class ExperimentSpec:
    model: ModelRef = field(default_factory=lambda: ModelRef("paper-charlm"))
    federated: FederatedConfig = field(default_factory=FederatedConfig)
    run: RunConfig = field(default_factory=RunConfig)
    environment: Environment = field(default_factory=Environment)
    learner: str = "surrogate"          # "surrogate" | "real"
    seq_len: int = 64
    max_client_steps: int = 8           # real learner scan length

    def __post_init__(self):
        assert self.learner in LEARNERS, self.learner

    # ----------------------------------------------------------- plumbing
    def replace(self, **kw) -> "ExperimentSpec":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return {
            "model": self.model.to_dict(),
            "federated": dataclasses.asdict(self.federated),
            "run": dataclasses.asdict(self.run),
            "environment": self.environment.to_dict(),
            "learner": self.learner,
            "seq_len": self.seq_len,
            "max_client_steps": self.max_client_steps,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        d = dict(d)
        return cls(
            model=ModelRef.from_dict(d.get("model", {"arch": "paper-charlm"})),
            federated=FederatedConfig(**d.get("federated", {})),
            run=RunConfig(**d.get("run", {})),
            environment=Environment.from_dict(d.get("environment")),
            learner=d.get("learner", "surrogate"),
            seq_len=int(d.get("seq_len", 64)),
            max_client_steps=int(d.get("max_client_steps", 8)),
        )

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def content_hash(self) -> str:
        """Short sha256 of the canonical JSON form — what checkpoint
        headers record, so a resume against a *different* spec (other
        seed, other environment, other budgets) fails loudly instead of
        silently continuing the wrong run."""
        canon = json.dumps(self.to_dict(), sort_keys=True,
                           separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()[:16]

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_json(f.read())
