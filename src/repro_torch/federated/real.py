"""The port's real learner: federated training of any model the port can
train in PyTorch (``model.loss``): the paper's CharLM and the dense
transformers (smollm-135m, its attention gradient from K3's backward
kernels); RWKV6's loss is not ported yet and raises.

It speaks the reference engine's learner protocol (``real``, ``version``,
``client_deltas``, ``client_delta``, ``apply(..., staleness=)``,
``eval_perplexity``), so it can stand in for the reference ``RealLearner``
inside the reference ``Experiment``. It holds server params + FedAdam state
on its device and, for FedBuff, a ring of recent param versions so stale
clients train against the model they were sent. Clients train as one
batched local step over the cohort (``make_cohort_update``; on the card a
CUDA graph replay a step). Deltas optionally round-trip the int8 wire
codec (the CUDA kernels on the card).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import FederatedConfig, ModelConfig, RunConfig
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.federated import aggregation
from repro_torch.federated.client import (make_cohort_update, stack_batches,
                                          to_device)
from repro_torch.models import get_model
from repro_torch.optim import server_optimizer
from repro_torch.weights import params_from_jax

Params = Dict[str, torch.Tensor]


class RealLearner:
    real = True

    def __init__(self, model_cfg: ModelConfig, fed: FederatedConfig,
                 run: RunConfig, dataset: FederatedDataset,
                 max_client_steps: int = 8, seed: int = 0,
                 device: torch.device | str = "cuda",
                 init_params: Optional[Dict[str, np.ndarray]] = None):
        """`init_params`: a flat NumPy dict (e.g. a JAX learner's params) to
        start from instead of the port's own seeded init."""
        self.cfg = model_cfg
        self.fed = fed
        self.run = run
        self.dataset = dataset
        self.max_steps = max_client_steps
        self.device = resolve_device(device)
        self.model = get_model(model_cfg)
        if init_params is None:
            gen = torch.Generator().manual_seed(seed)
            self.params, _ = self.model.init(gen, device=self.device)
        else:
            self.params = params_from_jax(init_params, self.device, model_cfg)
        self.opt = server_optimizer(fed.server_optimizer, fed.server_lr,
                                    b1=fed.adam_beta1, b2=fed.adam_beta2,
                                    eps=fed.adam_eps)
        self.opt_state = self.opt.init(self.params)
        self._cohort_update = make_cohort_update(self.model.loss,
                                                 fed.client_lr)
        self.version = 0
        # updates are functional (new tensors each step), so the ring holds
        # references, not copies
        self._history: List[Tuple[int, Params]] = []
        self._push_history()
        self._eval_batch = None

    # -------------------------------------------------------------- history
    def _push_history(self):
        self._history.append((self.version, self.params))
        if len(self._history) > max(2, self.fed.staleness_cap):
            self._history.pop(0)

    def params_at(self, version: int) -> Params:
        for v, p in reversed(self._history):
            if v <= version:
                return p
        return self._history[0][1]

    def _base(self, version: Optional[int]) -> Params:
        return self.params if version is None or version == self.version \
            else self.params_at(version)

    def _train(self, base: Params, client_ids) -> Tuple[Params, List[float]]:
        """The cohort's stacked (N, ...) deltas, trained from `base` in one
        batched local step a step, and each client's example weight."""
        stacked, masks, n_ex = [], [], []
        for cid in client_ids:
            batches = self.dataset.client_batches(
                cid, self.fed.client_batch_size, self.fed.local_epochs)
            st, m = stack_batches(batches, self.max_steps)
            stacked.append(st)
            masks.append(m)
            n_ex.append(float(min(len(batches), self.max_steps)
                              * self.fed.client_batch_size))
        cohort = {k: np.stack([s[k] for s in stacked]) for k in stacked[0]}
        deltas, _ = self._cohort_update(base, to_device(cohort, self.device),
                                        np.stack(masks))
        return deltas, n_ex

    # -------------------------------------------------------------- learner
    def client_deltas(self, client_ids, version: Optional[int] = None):
        """Vmapped cohort update: all clients train together from the same
        server params, then the STACKED (N, ...) deltas go through the codec
        as one tensor per leaf, as the reference's vmapped path does."""
        stacked, n_ex = self._train(self._base(version), client_ids)
        if self.fed.compression == "int8":
            stacked = aggregation.compress_roundtrip(
                stacked, block=self.fed.quant_block)
        return ([{k: v[i] for k, v in stacked.items()}
                 for i in range(len(client_ids))], n_ex)

    def client_delta(self, client_id: int, version: Optional[int] = None):
        """Run real local training (the cohort step at N = 1); returns
        (delta dict, example weight)."""
        stacked, n_ex = self._train(self._base(version), [client_id])
        delta = {k: v[0] for k, v in stacked.items()}
        if self.fed.compression == "int8":
            delta = aggregation.compress_roundtrip(delta,
                                                   block=self.fed.quant_block)
        return delta, n_ex[0]

    def apply(self, deltas: List[Params], weights: List[float], *,
              n_contributors: int = 0, mean_staleness: float = 0.0,
              staleness: Optional[List[int]] = None) -> None:
        assert deltas, "apply() with empty buffer"
        w = np.asarray(weights, np.float32)
        if staleness is not None:  # FedBuff staleness scaling
            w = w * aggregation.fedbuff_weights(staleness,
                                                self.fed.staleness_exponent)
        stacked = {k: torch.stack([d[k] for d in deltas]) for k in deltas[0]}
        mean_delta = aggregation.weighted_mean_deltas(
            stacked, torch.tensor(w, dtype=torch.float32, device=self.device))
        # FedAdam: the server "gradient" is the negative aggregated delta
        grads = {k: -v for k, v in mean_delta.items()}
        with torch.no_grad():
            self.params, self.opt_state = self.opt.update(
                grads, self.opt_state, self.params)
        self.version += 1
        self._push_history()

    def eval_perplexity(self) -> float:
        if self._eval_batch is None:
            self._eval_batch = to_device(self.dataset.eval_batch(
                self.run.eval_clients, batch_size=32), self.device)
        with torch.no_grad():
            loss = self.model.loss(self.params, self._eval_batch)[0]
        return float(np.exp(np.clip(np.float32(loss.item()), 0, 20)))
