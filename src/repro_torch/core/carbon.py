"""Carbon intensity model (paper §4.1 "Accounting for geography" + §4.2).

Country-level carbon intensities (gCO2e/kWh, Our World in Data, 2020-2021
reported years) map session energy to CO2e by the client's connecting
country. Server energy uses the weighted average intensity of datacenter
locations (weights = number of datacenters per country), times PUE 1.09.

Grid intensity is also a function of *when* a session runs — the paper's
core thesis is that cross-device FL cannot "reliably tap into renewables",
so time/geo shifting is the headline Green-FL lever (CAFE-style carbon-aware
scheduling). ``IntensityModel`` therefore carries optional per-country
**diurnal schedules**: piecewise-constant gCO2e/kWh over a repeating 24 h
cycle (equal-length segments) plus a per-country phase offset in hours
(the country's UTC offset, so "midday" lands at local midday on the shared
task clock). A static table entry is exactly the degenerate one-segment
schedule; a schedule whose segments are all equal collapses back to a
static value at lookup-table build time, which keeps flat-schedule runs
bit-for-bit identical to the static model. ``intensity_at`` is the
vectorized point lookup; ``_VocabSchedule.mean`` integrates over a time
span (what the estimator charges a session phase with).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Sequence, Tuple, Union

import numpy as np

# gCO2e per kWh (OWID "carbon intensity of electricity", most recent year)
CARBON_INTENSITY: Dict[str, float] = {
    "WORLD": 475.0,
    "US": 379.0, "IN": 708.0, "BR": 102.0, "ID": 717.0, "MX": 431.0,
    "DE": 385.0, "GB": 257.0, "FR": 68.0, "JP": 479.0, "PH": 610.0,
    "VN": 542.0, "TR": 464.0, "TH": 501.0, "EG": 469.0, "PK": 344.0,
    "NG": 404.0, "BD": 574.0, "IT": 372.0, "ES": 193.0, "PL": 751.0,
    "CA": 125.0, "AU": 531.0, "SE": 45.0, "NO": 26.0, "IE": 348.0,
    "DK": 181.0, "SG": 489.0, "OTHER": 475.0,
}

PUE = 1.09  # paper §4.2 (Meta datacenters)

# datacenter fleet: country -> number of datacenters (weights for the
# weighted-average intensity model of §4.2)
DATACENTER_LOCATIONS: Dict[str, int] = {
    "US": 14, "IE": 1, "DK": 1, "SE": 1, "SG": 1,
}

SECONDS_PER_DAY = 86400.0

# Canonical diurnal shape: fractional deviation from the daily mean per
# 3-hour segment starting at local midnight — overnight fossil baseload
# sits above the mean, the midday solar belly well below, and the evening
# ramp peaks as solar falls off while demand holds. Deviations sum to 0,
# so the cycle average equals the static table value.
DIURNAL_SHAPE: Tuple[float, ...] = (0.10, 0.16, 0.00, -0.20, -0.26, -0.10,
                                    0.12, 0.18)

# Approximate UTC offsets (hours) of the participation-mix countries: the
# per-country phase that aligns the shared task clock with local solar
# time. Half-hour offsets (IN) are kept; multi-zone countries use their
# population-weighted zone.
UTC_OFFSET_H: Dict[str, float] = {
    "US": -6.0, "IN": 5.5, "BR": -3.0, "ID": 7.0, "MX": -6.0, "DE": 1.0,
    "GB": 0.0, "FR": 1.0, "JP": 9.0, "PH": 8.0, "VN": 7.0, "TR": 3.0,
    "TH": 7.0, "EG": 2.0, "PK": 5.0, "NG": 1.0, "BD": 6.0, "IT": 1.0,
    "ES": 1.0, "PL": 1.0, "CA": -5.0, "AU": 10.0, "SE": 1.0, "NO": 1.0,
    "IE": 0.0, "DK": 1.0, "SG": 8.0, "WORLD": 0.0, "OTHER": 0.0,
}


def diurnal_schedule(table: Mapping[str, float] = CARBON_INTENSITY,
                     amplitude: float = 1.0,
                     shape: Sequence[float] = DIURNAL_SHAPE
                     ) -> Dict[str, Tuple[float, ...]]:
    """Default diurnal schedules: every country's static intensity swung
    through ``shape`` (scaled by ``amplitude``), cycle mean preserved."""
    return {c: tuple(ci * (1.0 + amplitude * s) for s in shape)
            for c, ci in table.items()}


class _VocabSchedule:
    """Per-vocabulary compiled intensity lookup: for a fixed tuple of
    country names, static values, dynamic-schedule masks and the padded
    segment/prefix tables that make ``at`` (point lookup) and ``mean``
    (time-span integral) a few array ops. Built once per vocabulary and
    cached on the ``IntensityModel``."""

    def __init__(self, model: "IntensityModel", names: Sequence[str]):
        self.names = tuple(names)
        scheds = [model._dynamic_schedule(n) for n in self.names]
        self.static = np.asarray([model.intensity(n) for n in self.names],
                                 np.float64)
        self.dynamic = np.asarray([s is not None for s in scheds], bool)
        self.any_dynamic = bool(self.dynamic.any())
        v = len(self.names)
        kmax = max((len(s) for s in scheds if s), default=1)
        # static rows degrade to a one-segment schedule of their own value,
        # so every formula below is total (np.where still picks `static`)
        self.vals = np.tile(self.static[:, None], (1, kmax))
        self.nseg = np.ones(v, np.int64)
        self.phase_s = np.zeros(v, np.float64)
        for i, s in enumerate(scheds):
            if s is None:
                continue
            self.vals[i, :len(s)] = s
            self.nseg[i] = len(s)
            self.phase_s[i] = (model.phase_h.get(self.names[i], 0.0)
                               % 24.0) * 3600.0
        self.seg_s = SECONDS_PER_DAY / self.nseg
        self.prefix = np.concatenate(
            [np.zeros((v, 1)), np.cumsum(self.vals, axis=1)],
            axis=1) * self.seg_s[:, None]
        self.cycle = self.prefix[np.arange(v), self.nseg]
        # compiled screening tables, built lazily on first use:
        #   _seg_cache  -> (breaks, vals_seg) global segment grid
        #   _mask_cache -> k -> (S, V) "value <= k-th smallest" bool masks
        #   _exit_cache -> binary-lifting min table for exit_times
        self._seg_cache = None
        self._mask_cache: Dict[int, np.ndarray] = {}
        self._exit_cache = None

    def _segment(self, idx: np.ndarray, r: np.ndarray) -> np.ndarray:
        """Segment index for cycle-local seconds r in [0, 86400)."""
        return np.minimum((r / self.seg_s[idx]).astype(np.int64),
                          self.nseg[idx] - 1)

    def at(self, idx, t) -> np.ndarray:
        """Point intensity for vocab rows ``idx`` at task-clock ``t``
        seconds (broadcasts; static rows return their static value)."""
        idx = np.asarray(idx, np.intp)
        t = np.asarray(t, np.float64)
        r = np.mod(t + self.phase_s[idx], SECONDS_PER_DAY)
        j = self._segment(idx, r)
        return np.where(self.dynamic[idx],
                        self.vals[idx, j], self.static[idx])

    # ------------------------------------------------ compiled segment grid
    def segment_table(self) -> Tuple[np.ndarray, np.ndarray]:
        """Global breakpoint grid over the 24 h cycle: ``(breaks,
        vals_seg)`` where ``breaks`` is the sorted (S,) array of
        cycle-local task-clock seconds at which ANY row's schedule
        changes value (all rows' segment boundaries with their phase
        offsets folded in, always including 0.0) and ``vals_seg`` is the
        (S, V) matrix of every row's value on ``[breaks[s],
        breaks[s+1])``. ``vals_seg`` is evaluated with ``at`` itself at
        the breakpoints, so the table agrees with the per-row lookup by
        construction; within a segment no row changes value, which is
        what makes a single searchsorted a faithful stand-in for the
        per-row mod/floor attribution."""
        tab = self._seg_cache
        if tab is None:
            if self.any_dynamic:
                pts = [np.mod(np.arange(int(self.nseg[i])) * self.seg_s[i]
                              - self.phase_s[i], SECONDS_PER_DAY)
                       for i in np.nonzero(self.dynamic)[0]]
                breaks = np.unique(np.concatenate([[0.0], *pts]))
            else:
                breaks = np.zeros(1)
            idx = np.arange(len(self.names), dtype=np.intp)
            vals_seg = self.at(idx[None, :], breaks[:, None])
            tab = self._seg_cache = (breaks, vals_seg)
        return tab

    def segment_at(self, t) -> np.ndarray:
        """Global segment index for task-clock times ``t`` — one
        searchsorted into the compiled breakpoint grid (O(log S) per
        row) instead of per-row-per-country mod/floor work."""
        breaks, _ = self.segment_table()
        tl = np.mod(np.asarray(t, np.float64), SECONDS_PER_DAY)
        # breaks[0] == 0.0 and tl >= 0, so the result is always >= 0
        return np.searchsorted(breaks, tl, side="right") - 1

    def allowed_masks(self, k: int) -> np.ndarray:
        """(S, V) bool table: per global segment, which rows sit at or
        below the segment's k-th smallest value. The threshold is the
        VALUE ``partition(vals_seg[s], k-1)[k-1]`` — not an argpartition
        rank — so tied values are all allowed, exactly like the direct
        per-row ``intensity_at`` + partition screen; gathering a
        precomputed row therefore reproduces the recomputed mask
        bit-for-bit. Cached per k (the vocabulary is fixed per table,
        and tables are cached per names tuple on the model)."""
        m = self._mask_cache.get(k)
        if m is None:
            _, vals_seg = self.segment_table()
            tau = np.partition(vals_seg, k - 1, axis=1)[:, k - 1:k]
            m = self._mask_cache[k] = vals_seg <= tau
        return m

    def exit_table(self):
        """Binary-lifting minimum table over the doubled per-row segment
        values: ``(dv, st, M)`` where ``dv`` is (V, 2*kmax) with each
        row's cycle written twice (pad +inf), ``st[m][i, p]`` is the min
        of ``dv[i, p:p+2**m]`` and ``M = bit_length(max nseg)``. Lets
        ``exit_times`` find each row's first boundary whose value dips
        to its draw in O(log nseg) vectorized gathers instead of a
        Python loop over every segment of the cycle."""
        lut = self._exit_cache
        if lut is None:
            w = 2 * int(self.nseg.max())
            v = len(self.names)
            dv = np.full((v, w), np.inf)
            for i in range(v):
                ns = int(self.nseg[i])
                dv[i, :ns] = self.vals[i, :ns]
                dv[i, ns:2 * ns] = self.vals[i, :ns]
            m_levels = int(self.nseg.max()).bit_length()
            st = [dv]
            h = 1
            for _ in range(1, m_levels):
                prev = st[-1]
                cur = prev.copy()
                cur[:, :w - h] = np.minimum(prev[:, :w - h], prev[:, h:])
                st.append(cur)
                h *= 2
            lut = self._exit_cache = (dv, st, m_levels)
        return lut

    def _cumulative(self, idx: np.ndarray, t: np.ndarray) -> np.ndarray:
        """∫_0^t intensity dt' for vocab rows idx (t in task-clock s)."""
        ts = t + self.phase_s[idx]
        cycles = np.floor(ts / SECONDS_PER_DAY)
        r = ts - cycles * SECONDS_PER_DAY
        j = self._segment(idx, r)
        within = np.maximum(r - j * self.seg_s[idx], 0.0)
        return (cycles * self.cycle[idx] + self.prefix[idx, j]
                + self.vals[idx, j] * within)

    def mean(self, idx, a, b) -> np.ndarray:
        """Mean intensity over [a, b] per row; zero-length spans (and
        static rows) fall back to the point value at ``a``."""
        idx = np.asarray(idx, np.intp)
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        point = self.at(idx, a)
        dur = b - a
        live = self.dynamic[idx] & (dur > 0)
        if not live.any():
            return point
        integral = self._cumulative(idx, b) - self._cumulative(idx, a)
        return np.where(live,
                        np.divide(integral, dur, out=np.zeros_like(point),
                                  where=dur > 0),
                        point)


@dataclass(frozen=True)
class IntensityModel:
    """A swappable grid-carbon model: country intensity table, datacenter
    fleet weights, PUE, and optional per-country diurnal ``schedule``s
    (piecewise-constant gCO2e/kWh over a 24 h cycle, equal segments, with
    ``phase_h`` UTC offsets — see the module docstring). Instances are what
    `repro_torch.api.Environment` threads through the estimator; the module-level
    functions below keep delegating to `DEFAULT_INTENSITY` for legacy
    callers."""

    table: Mapping[str, float] = field(
        default_factory=lambda: dict(CARBON_INTENSITY))
    datacenter_locations: Mapping[str, int] = field(
        default_factory=lambda: dict(DATACENTER_LOCATIONS))
    pue: float = PUE
    fallback: str = "WORLD"
    schedule: Mapping[str, Sequence[float]] = field(default_factory=dict)
    phase_h: Mapping[str, float] = field(default_factory=dict)
    # per-vocabulary compiled lookup tables (built lazily, keyed by the
    # country-name tuple); excluded from equality so the cache is invisible
    _vocab_cache: Dict[Tuple[str, ...], _VocabSchedule] = field(
        default_factory=dict, init=False, repr=False, compare=False)

    def _dynamic_schedule(self, country: str) -> Union[Tuple[float, ...],
                                                       None]:
        """The country's schedule as a tuple IF it is genuinely
        time-varying; constant schedules (incl. the one-segment case)
        collapse to a static override so flat-schedule runs stay
        bit-for-bit identical to the static model."""
        vals = self.schedule.get(country)
        if not vals:
            return None
        vals = tuple(float(x) for x in vals)
        if all(x == vals[0] for x in vals):
            return None
        return vals

    def intensity(self, country: str) -> float:
        """Static / time-averaged intensity. Constant schedules override
        the table exactly; a time-varying schedule contributes its cycle
        mean (segments are equal-length, so the plain average)."""
        vals = self.schedule.get(country)
        if vals:
            vals = tuple(float(x) for x in vals)
            if all(x == vals[0] for x in vals):
                return vals[0]
            return sum(vals) / len(vals)
        # partial custom tables (Environment overrides) fall back to their
        # own fallback entry, then to the global world average
        return self.table.get(
            country,
            self.table.get(self.fallback, CARBON_INTENSITY["WORLD"]))

    # ------------------------------------------------------ time-resolved
    def vocab_schedule(self, names: Sequence[str]) -> _VocabSchedule:
        """Compiled lookup tables for a country vocabulary (cached)."""
        key = tuple(names)
        tab = self._vocab_cache.get(key)
        if tab is None:
            tab = self._vocab_cache[key] = _VocabSchedule(self, key)
        return tab

    def is_dynamic(self, names: Union[Sequence[str], None] = None) -> bool:
        """True iff any (given) country has a time-varying schedule."""
        if names is None:
            names = self.schedule.keys()
        return any(self._dynamic_schedule(n) is not None for n in names)

    def intensity_at(self, countries: Sequence[str], t) -> np.ndarray:
        """Vectorized point lookup: intensity of each named country at
        task-clock ``t`` seconds. ``t`` broadcasts against the country
        axis — a scalar gives shape (V,), an (n, 1) column gives (n, V)
        (every country's intensity at each row's clock)."""
        tab = self.vocab_schedule(countries)
        return tab.at(np.arange(len(tab.names), dtype=np.intp), t)

    def mean_intensity(self, country: str, a: float, b: float) -> float:
        """Scalar mean intensity of one country over task-clock [a, b]."""
        return float(self.vocab_schedule((country,)).mean([0], [a], [b])[0])

    def datacenter_intensity(self) -> float:
        total = sum(self.datacenter_locations.values())
        if total <= 0:
            # no (or zero-weighted) datacenter fleet: fall back to the
            # model's fallback intensity instead of dividing by zero
            return self.intensity(self.fallback)
        return sum(self.intensity(c) * n
                   for c, n in self.datacenter_locations.items()) / total

    def co2e_kg(self, energy_j: float, intensity_g_per_kwh: float) -> float:
        """Joules -> kg CO2e at the given intensity."""
        kwh = energy_j / 3.6e6
        return kwh * intensity_g_per_kwh / 1000.0

    def mix_intensity(self, country_mix: Mapping[str, float]) -> float:
        return sum(self.intensity(c) * w for c, w in country_mix.items()) / \
            max(sum(country_mix.values()), 1e-12)


DEFAULT_INTENSITY = IntensityModel()


def intensity(country: str) -> float:
    return DEFAULT_INTENSITY.intensity(country)


def datacenter_intensity() -> float:
    return DEFAULT_INTENSITY.datacenter_intensity()


def co2e_kg(energy_j: float, intensity_g_per_kwh: float) -> float:
    """Joules -> kg CO2e at the given intensity."""
    return DEFAULT_INTENSITY.co2e_kg(energy_j, intensity_g_per_kwh)


def mix_intensity(country_mix: Mapping[str, float]) -> float:
    return DEFAULT_INTENSITY.mix_intensity(country_mix)
