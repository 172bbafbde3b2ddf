"""Green-FL advisor (paper C4): pre-deployment configuration search.

Given constraints (deadline, target quality), simulate candidate configs
through `repro_torch.api.Experiment` (surrogate learner + the advisor's
`Environment`), return the Pareto frontier and the greenest feasible
config. Encodes the paper's recipe as the default candidate grid: LOW
concurrency, local epochs 1-3, tuned FedAdam — and exposes WHY each config
wins (predicted rounds x concurrency). When nothing in the grid satisfies
the constraints, `search()` still returns the carbon-sorted candidates but
marks every one `feasible=False` instead of silently passing them off.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.api import Environment, Experiment, ExperimentSpec, ModelRef
from repro_torch.configs.base import FederatedConfig, ModelConfig, RunConfig


@dataclass(frozen=True)
class Recommendation:
    fed: FederatedConfig
    carbon_kg: float
    duration_h: float
    reached_target: bool
    rounds: int
    feasible: bool = True    # satisfied the search() constraints it came from

    def why(self) -> str:
        flag = "" if self.feasible else " [INFEASIBLE]"
        return (f"concurrency={self.fed.concurrency} x rounds={self.rounds} "
                f"-> {self.carbon_kg:.2f} kgCO2e in {self.duration_h:.1f} h "
                f"(E={self.fed.local_epochs}, lr_c={self.fed.client_lr}, "
                f"lr_s={self.fed.server_lr}, {self.fed.mode}){flag}")


DEFAULT_GRID = dict(
    mode=("sync", "async"),
    concurrency=(50, 100, 200, 400, 800),
    local_epochs=(1, 3),
    client_lr=(0.05, 0.1, 0.2),
    compression=("none", "int8"),
)


class GreenAdvisor:
    def __init__(self, model_cfg: ModelConfig, run: Optional[RunConfig] = None,
                 seq_len: int = 64,
                 environment: Optional[Environment] = None):
        self.cfg = model_cfg
        self.run = run or RunConfig()
        self.seq_len = seq_len
        self.environment = environment or Environment()
        self._model_ref = ModelRef.from_config(model_cfg)
        self._cache: Dict[Tuple, Recommendation] = {}

    @staticmethod
    def _cache_key(fed: FederatedConfig) -> Tuple:
        """A canonical value key — field-order tuple of the frozen config —
        rather than trusting the config object itself to hash stably."""
        return dataclasses.astuple(fed)

    def evaluate(self, fed: FederatedConfig) -> Recommendation:
        key = self._cache_key(fed)
        if key in self._cache:
            return self._cache[key]
        spec = ExperimentSpec(model=self._model_ref, federated=fed,
                              run=self.run, environment=self.environment,
                              learner="surrogate", seq_len=self.seq_len)
        res = Experiment(spec).run()
        rec = Recommendation(fed, res.carbon.total_kg, res.duration_h,
                             res.reached_target, res.rounds)
        self._cache[key] = rec
        return rec

    def search(self, grid: Optional[Dict[str, Sequence]] = None,
               max_hours: Optional[float] = None) -> List[Recommendation]:
        grid = grid or DEFAULT_GRID
        recs = []
        keys = list(grid)
        for vals in itertools.product(*grid.values()):
            kw = dict(zip(keys, vals))
            kw.setdefault("aggregation_goal",
                          max(1, int(kw.get("concurrency", 100) * 0.8)))
            fed = FederatedConfig(**kw)
            recs.append(self.evaluate(fed))
        feasible = [r for r in recs if r.reached_target and
                    (max_hours is None or r.duration_h <= max_hours)]
        if feasible:
            feasible.sort(key=lambda r: r.carbon_kg)
            return feasible
        # nothing meets the constraints: return the least-bad candidates but
        # say so explicitly rather than passing them off as recommendations
        return [replace(r, feasible=False)
                for r in sorted(recs, key=lambda r: r.carbon_kg)]

    def recommend(self, **kw) -> Recommendation:
        return self.search(**kw)[0]

    @staticmethod
    def pareto(recs: List[Recommendation]) -> List[Recommendation]:
        """(duration, carbon) Pareto frontier among target-reaching configs."""
        pts = sorted((r for r in recs if r.reached_target),
                     key=lambda r: (r.duration_h, r.carbon_kg))
        front, best = [], float("inf")
        for r in pts:
            if r.carbon_kg < best:
                front.append(r)
                best = r.carbon_kg
        return front
