"""Surrogate convergence model for large hyperparameter sweeps.

The paper measures *hundreds* of production runs. Re-training for every
sweep point is wasteful on CPU, so benchmarks can swap the real JAX learner
for this calibrated response-surface: perplexity decays exponentially in
log-space with server updates, at a rate set by hyperparameter quality
(learning rates / betas / batch size), local-epoch gain with non-IID drift
penalty (paper §5.2: E>3 hurts), cohort-size diminishing returns (Charles
et al. 2021, paper Fig. 7), and FedBuff staleness penalty. The surrogate
reproduces the paper's *relationships*; the real learner (federated.real)
validates the trainer end-to-end at small scale.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import FederatedConfig, ModelConfig, RunConfig

TAU0 = 120.0           # updates to e-fold log-ppl at reference quality
REF_COHORT = 800.0     # cohort size where diminishing returns kick in (Fig.7)
PPL_FLOOR = 90.0       # model-capacity floor for the charlm task


def _log_bell(x: float, opt: float, width_decades: float) -> float:
    return math.exp(-((math.log10(x) - math.log10(opt)) / width_decades) ** 2)


@dataclass
class SurrogateLearner:
    real = False

    model_cfg: ModelConfig
    fed: FederatedConfig
    run: RunConfig

    def __post_init__(self):
        f = self.fed
        q = _log_bell(f.client_lr, 0.1, 0.8)
        q *= _log_bell(f.server_lr, 0.01, 1.0) if f.server_optimizer == "adam" \
            else _log_bell(f.server_lr, 0.3, 0.8)
        if f.server_optimizer == "adam":
            q *= math.exp(-((f.adam_beta1 - 0.9) / 0.45) ** 2)
            q *= math.exp(-((f.adam_beta2 - 0.995) / 0.05) ** 2)
        q *= _log_bell(f.client_batch_size, 16.0, 1.5)
        # local epochs: sublinear gain, non-IID drift beyond ~3 (paper §5.2)
        e = f.local_epochs
        gain = min(e, 3) ** 0.25
        if e > 3:
            gain *= max(0.7, 1.0 - 0.04 * (e - 3))
        q *= gain
        self._base_quality = q
        self._ppl0 = float(self.model_cfg.vocab_size)
        self.updates = 0
        self._staleness_ema = 0.0

    def quality(self, cohort_examples_clients: int, mean_staleness: float
                ) -> float:
        g = (max(cohort_examples_clients, 1) / REF_COHORT) ** 0.3
        s = 1.0 / (1.0 + 0.2 * mean_staleness ** 0.8) if mean_staleness > 0 else 1.0
        return self._base_quality * g * s

    # ------------------------------------------------------- learner api
    def client_delta(self, client_id: int, version: int):
        return None, 1.0     # no actual compute in surrogate mode

    def apply(self, deltas, weights, *, n_contributors: int,
              mean_staleness: float = 0.0) -> None:
        q = self.quality(n_contributors, mean_staleness)
        # one update advances log-ppl toward the floor by 1/tau e-fold
        self._staleness_ema = 0.8 * self._staleness_ema + 0.2 * mean_staleness
        tau = TAU0 / max(q, 1e-4)
        self.updates += 1
        self._progress = getattr(self, "_progress", 0.0) + 1.0 / tau

    def eval_perplexity(self) -> float:
        lo, hi = math.log(PPL_FLOOR), math.log(self._ppl0)
        prog = getattr(self, "_progress", 0.0)
        return math.exp(lo + (hi - lo) * math.exp(-prog))

    # ------------------------------------------------------- snapshot state
    def state(self) -> dict:
        """The mutable training state (everything ``apply`` touches); the
        quality surface itself is a pure function of the configs and is
        rebuilt from the spec on resume."""
        return {"updates": self.updates,
                "staleness_ema": self._staleness_ema,
                "progress": getattr(self, "_progress", 0.0)}

    def load_state(self, state) -> None:
        self.updates = int(state["updates"])
        self._staleness_ema = float(state["staleness_ema"])
        self._progress = float(state["progress"])
