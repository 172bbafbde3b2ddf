"""Fault injection: time-varying failure hazards + correlated burst events.

The paper's production setting is millions of flaky phones: a device is
only eligible while idle, charging and on unmetered wifi, so sessions die
in *correlated* waves (morning unplug ramps, regional outages) rather
than i.i.d. — and every failed attempt still burned energy that the
estimator must charge. ``FaultModel`` describes that failure process for
an ``Environment``:

* **hazard** — per-country probability that a session fails mid-flight,
  optionally time-varying: ``hazard_schedule`` maps countries to
  piecewise-constant 24 h curves with ``hazard_phase_h`` UTC offsets,
  reusing the intensity-schedule machinery from ``repro_torch.core.carbon``
  verbatim (same segment lookup, same constant-schedule collapse), so
  failure waves can anti-correlate with low-carbon hours.
* **bursts** — a deterministic jittered sequence of outage windows
  (``burst_rate_per_day`` per day, each ``burst_duration_s`` long) drawn
  from the model's own splitmix64 counter stream; any session whose span
  overlaps a window fails with ``burst_fail_prob`` at the moment the
  burst hits it.

Everything is a pure function of the model's fields — burst windows of
``seed``, per-session failure draws of the engine's ``(seed, client_id,
round)`` counters in ``federated.events`` — so the seed-for-seed oracle,
lane packing and streaming telemetry all survive bit-for-bit, and an
all-zero model is exactly today's fault-free engine.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

from repro_torch.core.carbon import SECONDS_PER_DAY, IntensityModel, _VocabSchedule

_M64 = (1 << 64) - 1
_U64 = np.uint64
# burst-window lane spacing — distinct from every stream constant in
# federated.events, so burst times never alias session/probe/retry draws
_BURST_MIX = 0x9FB21C651E98DF25

# Canonical morning-unplug hazard shape: multiplier on the base hazard per
# 3-hour segment starting at local midnight. Overnight (charging, idle)
# is quiet; the 06:00-12:00 unplug wave peaks; evening recovers.
HAZARD_SHAPE: Tuple[float, ...] = (0.3, 0.2, 1.6, 2.4, 1.4, 0.8, 0.6, 0.7)


def _splitmix64_arr(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 (bit-identical to ``federated.events``; kept
    local so core never imports the federated layer)."""
    x = x + _U64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
    return x ^ (x >> _U64(31))


def wave_hazard_schedule(countries: Sequence[str], base: float = 0.05,
                         shape: Sequence[float] = HAZARD_SHAPE
                         ) -> Dict[str, Tuple[float, ...]]:
    """Default diurnal hazard curves: ``base`` swung through ``shape``
    per country (pair with ``carbon.UTC_OFFSET_H`` phases so the unplug
    wave lands at local morning)."""
    return {c: tuple(base * s for s in shape) for c in countries}


def _check_prob(name: str, v: float) -> None:
    if not 0.0 <= float(v) <= 1.0:
        raise ValueError(f"FaultModel.{name} must be a probability in "
                         f"[0, 1], got {v!r}")


@dataclass(frozen=True)
class FaultModel:
    """Per-country failure hazard (static table + optional diurnal
    schedules) plus correlated burst outages. All-zero (the default) is
    bit-for-bit the fault-free engine."""

    hazard: Mapping[str, float] = field(default_factory=dict)
    hazard_schedule: Mapping[str, Sequence[float]] = field(
        default_factory=dict)
    hazard_phase_h: Mapping[str, float] = field(default_factory=dict)
    burst_rate_per_day: float = 0.0
    burst_duration_s: float = 3600.0
    burst_fail_prob: float = 0.0
    seed: int = 0
    horizon_days: float = 60.0       # burst windows are materialized up to
    #                                  this task-clock horizon
    # private caches (hazard lookup tables, burst windows) — excluded from
    # equality so two equal models compare equal regardless of use
    _cache: Dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    def __post_init__(self):
        for c, v in self.hazard.items():
            _check_prob(f"hazard[{c!r}]", v)
        for c, vals in self.hazard_schedule.items():
            if not len(vals):
                raise ValueError(
                    f"FaultModel.hazard_schedule[{c!r}] is empty")
            for v in vals:
                _check_prob(f"hazard_schedule[{c!r}]", v)
        _check_prob("burst_fail_prob", self.burst_fail_prob)
        if self.burst_rate_per_day < 0:
            raise ValueError("FaultModel.burst_rate_per_day must be >= 0, "
                             f"got {self.burst_rate_per_day!r}")
        if self.burst_duration_s < 0:
            raise ValueError("FaultModel.burst_duration_s must be >= 0, "
                             f"got {self.burst_duration_s!r}")
        if self.horizon_days <= 0:
            raise ValueError("FaultModel.horizon_days must be > 0, "
                             f"got {self.horizon_days!r}")

    # ----------------------------------------------------------- predicates
    @property
    def enabled(self) -> bool:
        """True iff the model can actually fail a session; disabled models
        take the engines' fault-free fast path untouched."""
        return (any(v > 0 for v in self.hazard.values())
                or any(any(x > 0 for x in vals)
                       for vals in self.hazard_schedule.values())
                or (self.burst_rate_per_day > 0
                    and self.burst_fail_prob > 0
                    and self.burst_duration_s > 0))

    # -------------------------------------------------------- hazard lookup
    def _hazard_model(self) -> IntensityModel:
        model = self._cache.get("model")
        if model is None:
            table = {str(k): float(v) for k, v in self.hazard.items()}
            table.setdefault("WORLD", 0.0)   # unlisted countries: no hazard
            model = IntensityModel(
                table=table, datacenter_locations={},
                schedule=dict(self.hazard_schedule),
                phase_h=dict(self.hazard_phase_h))
            self._cache["model"] = model
        return model

    def hazard_table(self, names: Sequence[str]) -> _VocabSchedule:
        """Compiled per-vocabulary hazard lookup — the same piecewise
        schedule machinery the intensity model uses (point lookups via
        ``at``, constant schedules collapsed to statics), cached per
        country vocabulary."""
        return self._hazard_model().vocab_schedule(tuple(names))

    # -------------------------------------------------------- burst windows
    def burst_windows(self) -> Tuple[np.ndarray, np.ndarray]:
        """(starts, ends) of every outage window up to ``horizon_days``:
        window k opens at ``(k + u_k) * mean_spacing`` with ``u_k`` the
        k-th draw of the model-seed splitmix stream — starts are strictly
        increasing, so a searchsorted finds the first overlap."""
        bw = self._cache.get("bursts")
        if bw is None:
            if (self.burst_rate_per_day <= 0 or self.burst_fail_prob <= 0
                    or self.burst_duration_s <= 0):
                z = np.zeros(0, np.float64)
                bw = (z, z)
            else:
                n = int(math.ceil(self.horizon_days
                                  * self.burst_rate_per_day))
                base = _U64(((self.seed & 0xFFFFFFFF) * 0x9E3779B9
                             + 0x7F4A7C15) & _M64)
                with np.errstate(over="ignore"):
                    h = _splitmix64_arr(
                        base + np.arange(n, dtype=np.uint64)
                        * _U64(_BURST_MIX))
                u = (h >> _U64(11)).astype(np.float64) / float(1 << 53)
                spacing = SECONDS_PER_DAY / self.burst_rate_per_day
                starts = (np.arange(n, dtype=np.float64) + u) * spacing
                bw = (starts, starts + self.burst_duration_s)
            self._cache["bursts"] = bw
        return bw

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        out: dict = {}
        if self.hazard:
            out["hazard"] = {k: float(v) for k, v in self.hazard.items()}
        if self.hazard_schedule:
            out["hazard_schedule"] = {
                k: [float(x) for x in v]
                for k, v in self.hazard_schedule.items()}
        if self.hazard_phase_h:
            out["hazard_phase_h"] = {k: float(v) for k, v
                                     in self.hazard_phase_h.items()}
        for f, default in (("burst_rate_per_day", 0.0),
                           ("burst_duration_s", 3600.0),
                           ("burst_fail_prob", 0.0),
                           ("seed", 0), ("horizon_days", 60.0)):
            v = getattr(self, f)
            if v != default:
                out[f] = v
        return out

    @classmethod
    def from_dict(cls, d) -> "FaultModel":
        if not d:
            return cls()
        d = dict(d)
        if "hazard_schedule" in d:
            d["hazard_schedule"] = {k: tuple(v) for k, v
                                    in d["hazard_schedule"].items()}
        return cls(**d)
