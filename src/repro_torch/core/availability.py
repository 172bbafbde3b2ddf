"""Device availability: diurnal eligibility curves + mid-session churn.

The paper's production constraint is that a phone only trains while idle,
charging and on unmetered wifi — so the *eligible* fleet is itself a
per-country 24 h curve (evening/overnight charging peak, midday dip),
anti-correlated with the solar-driven low-intensity hours that
carbon-aware scheduling wants to exploit — and a device routinely exits
eligibility mid-session (unplugged, off wifi), interrupting work the
fault model cannot express. ``AvailabilityModel`` describes both effects
for an ``Environment``:

* **admission** — per-country probability that a candidate device is
  eligible at dispatch time: a static table plus optional
  ``eligibility_schedule`` piecewise-constant 24 h curves with
  ``eligibility_phase_h`` UTC offsets, reusing the intensity-schedule
  machinery from ``repro_torch.core.carbon`` verbatim (same segment lookup,
  same constant-schedule collapse). The engine draws one admission
  uniform per session on a dedicated counter stream; an inadmissible
  device is logged ``interrupted`` at zero cost and its slot retried.
* **churn** — the *same* uniform, read against the eligibility curve
  over the session's span: the device stays eligible exactly while
  ``u < eligibility(t)``, so an admitted session is interrupted at the
  first schedule-segment boundary where the curve falls to or below its
  draw (``exit_times``). Static curves never cross an admitted draw, so
  a schedule-free model degrades to admission-only gating.

Everything is a pure function of the engine's ``(seed, client_id,
round)`` counters, so the seed-for-seed oracle, lane packing and
streaming telemetry all survive bit-for-bit — and an all-available model
(the default) is exactly today's availability-blind engine.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

from repro_torch.core.carbon import (SECONDS_PER_DAY, UTC_OFFSET_H, IntensityModel,
                               _VocabSchedule)

# Canonical eligibility shape: absolute per-country eligibility probability
# per 3-hour segment starting at local midnight. Overnight/evening (on the
# charger, idle, home wifi) is the peak; the working-day midday trough is
# exactly where DIURNAL_SHAPE's solar belly sits — the anti-correlation the
# paper's availability analysis turns on.
AVAIL_SHAPE: Tuple[float, ...] = (0.95, 0.90, 0.55, 0.35, 0.30, 0.45,
                                  0.75, 0.90)


def diurnal_availability(countries: Sequence[str],
                         shape: Sequence[float] = AVAIL_SHAPE,
                         phase_h: Mapping[str, float] = UTC_OFFSET_H
                         ) -> "AvailabilityModel":
    """Default diurnal availability: every country rides ``shape`` with
    its UTC offset as phase, so the charging peak lands at local evening
    (pairs with ``carbon.UTC_OFFSET_H`` the same way the intensity
    schedules do)."""
    return AvailabilityModel(
        eligibility_schedule={c: tuple(float(x) for x in shape)
                              for c in countries},
        eligibility_phase_h={c: float(phase_h.get(c, 0.0))
                             for c in countries})


def exit_times(tab: _VocabSchedule, idx, u, start) -> np.ndarray:
    """First task-clock time ``> start`` at which each row's eligibility
    curve falls to or below its admission draw ``u`` — the moment the
    device exits eligibility. Crossings only happen at schedule segment
    boundaries (curves are piecewise constant), so the search space is
    one cycle of boundaries ahead of ``start``; rows whose curve never
    dips to ``u`` (static rows with an admitted draw, or periodic curves
    that stay above it) return ``+inf``. The scan is a binary-lifting
    descent over the table's compiled doubled-cycle min structure
    (``exit_table``): from the current segment, greedily jump the widest
    power-of-two span whose minimum stays above ``u`` — O(log nseg)
    vectorized gathers instead of a Python loop over every segment. The
    crossing *comparison* reads the stored segment values themselves, so
    which boundary is hit is exactly the sequential scan's answer; each
    row's result depends only on its own ``(idx, u, start)``, and the
    scalar oracle calls this batch-of-1, so serial, lane and oracle
    share the exact float sequence."""
    idx = np.asarray(idx, np.intp)
    u = np.asarray(u, np.float64)
    start = np.asarray(start, np.float64)
    n = idx.shape[0]
    out = np.full(n, np.inf)
    if not tab.any_dynamic:
        return out
    r = np.mod(start + tab.phase_s[idx], SECONDS_PER_DAY)
    j0 = tab._segment(idx, r)
    seg = tab.seg_s[idx]
    nseg = tab.nseg[idx]
    dv, st, m_levels = tab.exit_table()
    w = dv.shape[1]
    # pos = last boundary offset known crossing-free; search range is
    # (j0, j0 + nseg] in doubled-cycle coordinates (k = nseg re-checks
    # the starting segment one full day later)
    end_pos = j0 + nseg
    pos = j0.copy()
    for m in range(m_levels - 1, -1, -1):
        step = 1 << m
        fits = pos + step <= end_pos
        wmin = st[m][idx, np.minimum(pos + 1, w - 1)]
        pos += np.where(fits & (wmin > u), step, 0)
    k = pos + 1 - j0
    hit = (k <= nseg) & (dv[idx, np.minimum(pos + 1, w - 1)] <= u)
    out[hit] = (start + ((j0 + k) * seg - r))[hit]
    return out


def _check_frac(name: str, v: float) -> None:
    if not 0.0 <= float(v) <= 1.0:
        raise ValueError(f"AvailabilityModel.{name} must be an eligibility "
                         f"probability in [0, 1], got {v!r}")


@dataclass(frozen=True)
class AvailabilityModel:
    """Per-country device eligibility (static table + optional diurnal
    schedules). All-available (the default) is bit-for-bit the
    availability-blind engine."""

    eligibility: Mapping[str, float] = field(default_factory=dict)
    eligibility_schedule: Mapping[str, Sequence[float]] = field(
        default_factory=dict)
    eligibility_phase_h: Mapping[str, float] = field(default_factory=dict)
    # private caches (eligibility lookup tables) — excluded from equality
    # so two equal models compare equal regardless of use
    _cache: Dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    def __post_init__(self):
        for c, v in self.eligibility.items():
            _check_frac(f"eligibility[{c!r}]", v)
        for c, vals in self.eligibility_schedule.items():
            if not len(vals):
                raise ValueError(
                    f"AvailabilityModel.eligibility_schedule[{c!r}] is "
                    f"empty")
            for v in vals:
                _check_frac(f"eligibility_schedule[{c!r}]", v)
        for c, v in self.eligibility_phase_h.items():
            if not math.isfinite(float(v)):
                raise ValueError(
                    f"AvailabilityModel.eligibility_phase_h[{c!r}] must be "
                    f"finite, got {v!r}")

    # ----------------------------------------------------------- predicates
    @property
    def enabled(self) -> bool:
        """True iff the model can actually exclude a device; disabled
        models take the engines' availability-free fast path untouched."""
        return (any(float(v) < 1.0 for v in self.eligibility.values())
                or any(any(float(x) < 1.0 for x in vals)
                       for vals in self.eligibility_schedule.values()))

    # --------------------------------------------------- eligibility lookup
    def _eligibility_model(self) -> IntensityModel:
        model = self._cache.get("model")
        if model is None:
            table = {str(k): float(v) for k, v in self.eligibility.items()}
            table.setdefault("WORLD", 1.0)  # unlisted: always eligible
            model = IntensityModel(
                table=table, datacenter_locations={},
                schedule=dict(self.eligibility_schedule),
                phase_h=dict(self.eligibility_phase_h))
            self._cache["model"] = model
        return model

    def eligibility_table(self, names: Sequence[str]) -> _VocabSchedule:
        """Compiled per-vocabulary eligibility lookup — the same piecewise
        schedule machinery the intensity model uses (point lookups via
        ``at``, constant schedules collapsed to statics), cached per
        country vocabulary."""
        return self._eligibility_model().vocab_schedule(tuple(names))

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        out: dict = {}
        if self.eligibility:
            out["eligibility"] = {k: float(v)
                                  for k, v in self.eligibility.items()}
        if self.eligibility_schedule:
            out["eligibility_schedule"] = {
                k: [float(x) for x in v]
                for k, v in self.eligibility_schedule.items()}
        if self.eligibility_phase_h:
            out["eligibility_phase_h"] = {
                k: float(v) for k, v in self.eligibility_phase_h.items()}
        return out

    @classmethod
    def from_dict(cls, d) -> "AvailabilityModel":
        if not d:
            return cls()
        d = dict(d)
        if "eligibility_schedule" in d:
            d["eligibility_schedule"] = {
                k: tuple(v) for k, v in d["eligibility_schedule"].items()}
        return cls(**d)
