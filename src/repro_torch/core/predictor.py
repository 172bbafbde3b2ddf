"""Pre-deployment carbon predictor (paper §5.3, Figures 8–9).

Empirical law: carbon ≈ a * (concurrency x rounds) + b for synchronous FL
and a * (concurrency x duration) + b for asynchronous FL. The coefficient a
depends on the task (model size, data, fleet, infrastructure); practitioners
fit it from a handful of measured runs, then forecast new configurations
before launch using simulated rounds-to-target.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class LinearFit:
    slope: float
    intercept: float
    r2: float

    def predict(self, x: float) -> float:
        return self.slope * x + self.intercept


def fit_linear(x: Sequence[float], y: Sequence[float]) -> LinearFit:
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    assert x.shape == y.shape and x.size >= 2
    A = np.stack([x, np.ones_like(x)], axis=1)
    (slope, intercept), *_ = np.linalg.lstsq(A, y, rcond=None)
    pred = slope * x + intercept
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return LinearFit(float(slope), float(intercept), r2)


@dataclass(frozen=True)
class CarbonPredictor:
    """carbon_kg ≈ slope * (concurrency x rounds_or_hours) + intercept."""

    fit: LinearFit
    mode: str                      # "sync" (x = concurrency*rounds)
    #                                "async" (x = concurrency*hours)

    @classmethod
    def from_measurements(cls, mode: str,
                          concurrency: Sequence[float],
                          rounds_or_hours: Sequence[float],
                          carbon_kg: Sequence[float]) -> "CarbonPredictor":
        x = np.asarray(concurrency, np.float64) * \
            np.asarray(rounds_or_hours, np.float64)
        return cls(fit=fit_linear(x, carbon_kg), mode=mode)

    def predict_kg(self, concurrency: float, rounds_or_hours: float) -> float:
        return self.fit.predict(concurrency * rounds_or_hours)
