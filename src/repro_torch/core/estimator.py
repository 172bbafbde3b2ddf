"""TaskLog -> carbon footprint, per component (the paper's Figure 5 bars).

Components:
  client_compute  — CPU energy on phones, at the client country's intensity
  upload          — device Wi-Fi tx + uplink network-infrastructure path
  download        — device Wi-Fi rx + downlink network-infrastructure path
  server          — Aggregator+Selector x PUE, at the DC-weighted intensity

Network-infrastructure energy is attributed at the client country intensity
(the access/metro portion dominates the per-bit energy and sits near the
client). Dropped / timed-out sessions are charged for whatever they burned.

When the grid model carries diurnal schedules (time-varying intensity,
``IntensityModel.schedule``), every reduction path — vectorized
``batch_carbon``/``estimate``, the scalar ``session_carbon`` loop, and the
lane-pack ``lane_carbon`` — integrates energy x intensity(t) over each
session phase's time span instead of multiplying by one static value; flat
schedules keep the static fast path bit-for-bit. Server energy stays at
the (static) datacenter-weighted intensity — datacenters buy around-the-
clock supply, the paper's point being that *client* fleets cannot.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.carbon import IntensityModel
from repro_torch.core.energy import SERVER_TASK_POWER_W, server_energy_j
from repro_torch.core.network import DEFAULT_NETWORK, NetworkEnergyModel
from repro_torch.core.profiles import FLEET, DeviceProfile
from repro_torch.core.telemetry import (OUTCOME_CODE, ClientSession, SessionBatch,
                                  TaskLog)

_EXACT_CHUNK = 1 << 25


class ExactSum:
    """Error-free streaming float64 accumulator.

    Every float64 is an integer mantissa times a power of two, so a sum of
    floats is representable exactly as one (arbitrary-precision mantissa,
    binary exponent) pair. ``add`` folds an array in vectorized NumPy:
    ``frexp`` splits each value into a 53-bit integer mantissa and an
    exponent, the mantissa is split into 27-bit-high / 26-bit-low halves
    (so per-exponent-bin partial sums of <= 2^25 rows stay below 2^53 and
    ``np.bincount``'s float64 accumulation is exact), and the binned
    partials collapse into one big-int contribution. The running state is
    exact, so accumulation is associative and commutative: any chunking,
    lane segmentation, or merge order produces the **bit-identical**
    correctly-rounded ``value()``. This is what lets the streaming
    telemetry path reproduce the materialized reduction bit-for-bit.
    """

    __slots__ = ("_m", "_e")

    def __init__(self) -> None:
        self._m = 0  # arbitrary-precision mantissa; value = _m * 2**_e
        self._e = 0

    def add(self, x) -> "ExactSum":
        x = np.ascontiguousarray(x, dtype=np.float64).ravel()
        for lo in range(0, x.size, _EXACT_CHUNK):
            self._add_chunk(x[lo:lo + _EXACT_CHUNK])
        return self

    def _add_chunk(self, x: np.ndarray) -> None:
        x = x[x != 0.0]
        if not x.size:
            return
        if not np.isfinite(x).all():
            raise ValueError("ExactSum requires finite inputs")
        m, e = np.frexp(x)
        M = np.ldexp(m, 53).astype(np.int64)   # exact: |M| <= 2^53
        E = e.astype(np.int64) - 53
        hi = M >> 26                           # floor division (sign-safe)
        lo = M - (hi << 26)                    # in [0, 2^26)
        e0 = int(E.min())
        ebin = E - e0
        nb = int(ebin.max()) + 1
        sh = np.bincount(ebin, weights=hi.astype(np.float64), minlength=nb)
        sl = np.bincount(ebin, weights=lo.astype(np.float64), minlength=nb)
        tot = 0
        for b in np.flatnonzero((sh != 0.0) | (sl != 0.0)):
            tot += ((int(sh[b]) << 26) + int(sl[b])) << int(b)
        self._merge(tot, e0)

    def _merge(self, m2: int, e2: int) -> None:
        if m2 == 0:
            return
        if self._m == 0:
            self._m, self._e = m2, e2
        elif self._e <= e2:
            self._m += m2 << (e2 - self._e)
        else:
            self._m = (self._m << (self._e - e2)) + m2
            self._e = e2

    def merge(self, other: "ExactSum") -> "ExactSum":
        self._merge(other._m, other._e)
        return self

    def value(self) -> float:
        """Correctly-rounded float64 of the exact running sum."""
        if self._m == 0:
            return 0.0
        if self._e >= 0:
            return float(self._m << self._e)
        # CPython int/int true division is correctly rounded
        return self._m / (1 << -self._e)

    # ------------------------------------------------------------ snapshots
    _STATE_VERSION = 1

    def state(self) -> dict:
        """Version-tagged JSON-safe state. The mantissa is arbitrary
        precision, so it travels as a hex string; the round-trip through
        ``from_state`` is exact (same ``_m``/``_e``, hence the same
        correctly-rounded ``value()`` and the same future merges)."""
        return {"version": self._STATE_VERSION,
                "m": format(self._m, "x") if self._m >= 0
                else "-" + format(-self._m, "x"),
                "e": self._e}

    @classmethod
    def from_state(cls, state: Mapping) -> "ExactSum":
        v = state.get("version")
        if v != cls._STATE_VERSION:
            raise ValueError(
                f"unsupported ExactSum state version {v!r}; this build "
                f"reads version {cls._STATE_VERSION}")
        s = cls()
        s._m = int(state["m"], 16)
        s._e = int(state["e"])
        return s


def exact_sum(x) -> float:
    """One-shot correctly-rounded sum of a float64 array (see ExactSum)."""
    return ExactSum().add(x).value()


@dataclass(frozen=True)
class CarbonBreakdown:
    client_compute_kg: float
    upload_kg: float
    download_kg: float
    server_kg: float
    # contributed vs wasted split (the paper's over-commitment price):
    # contributed = completed sessions' client-side carbon + the server;
    # wasted = every non-completed session (dropped, timed out, cancelled,
    # failed, retried, interrupted) — work that burned carbon but never
    # aggregated. When populated, total_kg == contributed_kg + wasted_kg
    # by definition.
    contributed_kg: float = 0.0
    wasted_kg: float = 0.0
    # checkpoint/resume refinement of the waste: an interrupted session's
    # compute up to its last checkpoint is *salvaged* (a retry resumed
    # from it instead of redoing the work); everything else non-completed
    # is *lost*. wasted_kg == salvaged_kg + lost_kg exactly whenever a
    # checkpoint period was live (both are 0/waste otherwise).
    salvaged_kg: float = 0.0
    lost_kg: float = 0.0

    @property
    def total_kg(self) -> float:
        if self.contributed_kg or self.wasted_kg:
            return self.contributed_kg + self.wasted_kg
        return (self.client_compute_kg + self.upload_kg + self.download_kg
                + self.server_kg)

    def shares(self) -> Dict[str, float]:
        t = max(self.total_kg, 1e-18)
        return {
            "client_compute": self.client_compute_kg / t,
            "upload": self.upload_kg / t,
            "download": self.download_kg / t,
            "server": self.server_kg / t,
        }

    def as_dict(self) -> Dict[str, float]:
        return {
            "client_compute_kg": self.client_compute_kg,
            "upload_kg": self.upload_kg,
            "download_kg": self.download_kg,
            "server_kg": self.server_kg,
            "contributed_kg": self.contributed_kg,
            "wasted_kg": self.wasted_kg,
            "salvaged_kg": self.salvaged_kg,
            "lost_kg": self.lost_kg,
            "total_kg": self.total_kg,
        }


@dataclass
class CarbonEstimator:
    """TaskLog -> CarbonBreakdown under a fully explicit environment: the
    network energy model, device-profile registry, grid-intensity model and
    server power are all instance state — nothing on the estimation path
    reads module-level defaults (construct via ``repro_torch.api.Environment`` to
    swap any of them)."""

    network: NetworkEnergyModel = field(default_factory=lambda: DEFAULT_NETWORK)
    profiles: Dict[str, DeviceProfile] = field(
        default_factory=lambda: {p.name: p for p in FLEET})
    intensity: IntensityModel = field(default_factory=IntensityModel)
    server_power_w: float = SERVER_TASK_POWER_W

    def session_carbon(self, s: ClientSession) -> Dict[str, float]:
        """Per-session component kg — ``_kg_rows`` batch-of-1, so the scalar
        path shares the per-phase span-mean intensity logic (download ->
        compute -> upload back to back from ``start_t``) with every
        vectorized reduction instead of re-implementing it."""
        b = SessionBatch.from_sessions([s])
        kg = _kg_rows(self, b.device_names, b.device_idx, b.country_names,
                      b.country_idx, b.compute_s, b.upload_s, b.download_s,
                      b.bytes_up, b.bytes_down, b.start_t)
        return {"client_compute_kg": float(kg[0, 0]),
                "upload_kg": float(kg[1, 0]),
                "download_kg": float(kg[2, 0])}

    def batch_carbon(self, b: SessionBatch,
                     checkpoint_period_s: float = 0.0) -> Dict[str, float]:
        """Fig. 5 component sums for a whole SessionBatch via group-by-
        device/country array reductions (no per-session loop). The three
        component energies land in one (3, n) matrix so the grid-intensity
        conversion is a single fused pass instead of three, and dropped/
        timed-out/cancelled rows need no masks — their truncated durations
        and prorated bytes already carry the burned-energy accounting.

        With ``checkpoint_period_s`` > 0 (availability churn + resume
        live), interrupted rows' compute waste splits at the last
        checkpoint into salvaged vs lost (``_salvage_kg``); otherwise
        salvaged is 0 and lost == waste bit-for-bit."""
        if not len(b):
            return {"client_compute_kg": 0.0, "upload_kg": 0.0,
                    "download_kg": 0.0, "ok_kg": 0.0, "waste_kg": 0.0,
                    "salvaged_kg": 0.0, "lost_kg": 0.0}
        kg = _kg_rows(self, b.device_names, b.device_idx, b.country_names,
                      b.country_idx, b.compute_s, b.upload_s, b.download_s,
                      b.bytes_up, b.bytes_down, b.start_t)
        # error-free sums: the result is the correctly-rounded true sum,
        # independent of row order or chunking — which is exactly what lets
        # the streaming telemetry fold reproduce this path bit-for-bit.
        # ok/waste split the same rows by completion (wasted work: dropped,
        # timed out, cancelled, failed, retried, interrupted) — same
        # exactness contract.
        okm = b.completed_mask
        out = {"client_compute_kg": exact_sum(kg[0]),
               "upload_kg": exact_sum(kg[1]),
               "download_kg": exact_sum(kg[2]),
               "ok_kg": exact_sum(kg[:, okm])}
        P = float(checkpoint_period_s)
        im = (b.outcome == OUTCOME_CODE["interrupted"]) if P > 0 else None
        if im is None or not im.any():
            w = exact_sum(kg[:, ~okm])
            out.update(waste_kg=w, salvaged_kg=0.0, lost_kg=w)
            return out
        iw = np.flatnonzero(im)
        salv_kg, tail_kg = _salvage_kg(
            self, b.device_names, b.device_idx[iw], b.country_names,
            b.country_idx[iw], b.compute_s[iw], b.download_s[iw],
            b.start_t[iw], P)
        ow = ~okm & ~im
        salv = exact_sum(salv_kg)
        lost = ExactSum().add(tail_kg).add(kg[1, iw]).add(kg[2, iw]) \
            .add(kg[:, ow]).value()
        # waste == salvaged + lost exactly (one well-defined float add)
        out.update(waste_kg=salv + lost, salvaged_kg=salv, lost_kg=lost)
        return out

    def _server_kg_s(self, duration_s: float) -> float:
        srv_j = server_energy_j(duration_s, pue=self.intensity.pue,
                                power_w=self.server_power_w)
        return self.intensity.co2e_kg(srv_j,
                                      self.intensity.datacenter_intensity())

    def _server_kg(self, log: TaskLog) -> float:
        return self._server_kg_s(log.duration_s)

    def estimate(self, log: TaskLog) -> CarbonBreakdown:
        # streaming logs carry exact running component sums — consult them
        # FIRST: their columns() view is a reservoir *sample*, so reducing
        # it here would silently undercount
        comp = getattr(log, "carbon_components", None)
        if comp is not None:
            d = comp(self)
        else:
            d = self.batch_carbon(
                log.columns() if hasattr(log, "columns")
                else SessionBatch.from_sessions(log.sessions),
                checkpoint_period_s=getattr(log, "checkpoint_period_s",
                                            0.0))
        srv = self._server_kg(log)
        return CarbonBreakdown(d["client_compute_kg"], d["upload_kg"],
                               d["download_kg"], srv,
                               contributed_kg=d.get("ok_kg", 0.0) + srv,
                               wasted_kg=d.get("waste_kg", 0.0),
                               salvaged_kg=d.get("salvaged_kg", 0.0),
                               lost_kg=d.get("lost_kg",
                                             d.get("waste_kg", 0.0)))

    def estimate_scalar(self, log: TaskLog) -> CarbonBreakdown:
        """Per-session reference loop — equivalence-test and benchmark twin
        of the vectorized ``estimate`` (including the checkpoint salvage
        split, via ``_salvage_kg`` batch-of-1)."""
        P = float(getattr(log, "checkpoint_period_s", 0.0))
        cc = up = dn = okk = salv = lost = 0.0
        for s in log.sessions:
            d = self.session_carbon(s)
            cc += d["client_compute_kg"]
            up += d["upload_kg"]
            dn += d["download_kg"]
            row = d["client_compute_kg"] + d["upload_kg"] + d["download_kg"]
            if s.completed:
                okk += row
            elif P > 0 and s.outcome == "interrupted":
                b = SessionBatch.from_sessions([s])
                sk, tk = _salvage_kg(self, b.device_names, b.device_idx,
                                     b.country_names, b.country_idx,
                                     b.compute_s, b.download_s, b.start_t,
                                     P)
                salv += float(sk[0])
                lost += float(tk[0]) + d["upload_kg"] + d["download_kg"]
            else:
                lost += row
        srv = self._server_kg(log)
        return CarbonBreakdown(cc, up, dn, srv, contributed_kg=okk + srv,
                               wasted_kg=salv + lost, salvaged_kg=salv,
                               lost_kg=lost)


def _kg_rows(est: CarbonEstimator, device_names, device_idx, country_names,
             country_idx, compute_s, upload_s, download_s, bytes_up,
             bytes_down, start_t, with_energy: bool = False) -> np.ndarray:
    """Per-row (3, n) kg matrix — rows: client_compute / upload / download.
    With ``with_energy=True`` also returns the (3, n) joules matrix (the
    streaming telemetry fold reuses it for grouped energy sums — one
    implementation of the per-phase span-mean logic, per the bit-for-bit
    contract).
    ``co2e_kg`` is plain arithmetic, so it broadcasts over the per-row
    energy/intensity columns — IntensityModel overrides stay honored.
    (Lane packs with differing network/intensity models are handled by
    calling this once per lane with that lane's estimator.)

    With a time-varying intensity schedule, each energy row is charged the
    mean intensity over its own phase span (sessions run download ->
    compute -> upload back to back from ``start_t``); the static path is
    untouched, so flat-schedule models stay bit-for-bit identical."""
    profs = [est.profiles[n] for n in device_names]
    cpu_w = np.asarray([p.cpu_power_w for p in profs])[device_idx]
    tx_w = np.asarray([p.wifi_tx_power_w for p in profs])[device_idx]
    rx_w = np.asarray([p.wifi_rx_power_w for p in profs])[device_idx]
    epb = est.network.energy_per_bit_j
    n = len(device_idx)
    e = np.empty((3, n))
    e[0] = cpu_w * compute_s
    e[1] = tx_w * upload_s + 8.0 * bytes_up * epb
    e[2] = rx_w * download_s + 8.0 * bytes_down * epb
    tab = est.intensity.vocab_schedule(tuple(country_names))
    if not tab.any_dynamic:
        ci = tab.static[country_idx]
        kg = est.intensity.co2e_kg(e, ci)
        return (kg, e) if with_energy else kg
    a1 = start_t + download_s
    a2 = a1 + compute_s
    ci3 = np.empty((3, n))
    ci3[0] = tab.mean(country_idx, a1, a2)
    ci3[1] = tab.mean(country_idx, a2, a2 + upload_s)
    ci3[2] = tab.mean(country_idx, start_t, a1)
    kg = est.intensity.co2e_kg(e, ci3)
    return (kg, e) if with_energy else kg


def _salvage_kg(est: CarbonEstimator, device_names, device_idx,
                country_names, country_idx, compute_s, download_s, start_t,
                period_s: float) -> Tuple[np.ndarray, np.ndarray]:
    """Checkpoint split of interrupted rows' burned compute carbon:
    ``floor(burned / P) * P`` seconds of compute survived to the last
    checkpoint (salvaged — a resume reused it), the remainder is lost.
    Under a diurnal grid each part is charged the mean intensity over its
    own sub-span of the compute phase, mirroring ``_kg_rows``'s phase
    integration — a row with zero salvage reproduces its ``_kg_rows``
    compute entry bit-for-bit (``c - 0.0 == c``, same span mean). Returns
    per-row ``(salvaged_kg, lost_kg)`` arrays; row-pure, so any blocking
    (streaming folds, lane segments, batch-of-1 scalar) agrees exactly."""
    profs = [est.profiles[n] for n in device_names]
    cpu_w = np.asarray([p.cpu_power_w for p in profs])[device_idx]
    salv_s = np.floor(compute_s / period_s) * period_s
    e_salv = cpu_w * salv_s
    e_tail = cpu_w * (compute_s - salv_s)
    tab = est.intensity.vocab_schedule(tuple(country_names))
    if not tab.any_dynamic:
        ci = tab.static[country_idx]
        return (est.intensity.co2e_kg(e_salv, ci),
                est.intensity.co2e_kg(e_tail, ci))
    a1 = start_t + download_s
    am = a1 + salv_s
    a2 = a1 + compute_s
    return (est.intensity.co2e_kg(e_salv, tab.mean(country_idx, a1, am)),
            est.intensity.co2e_kg(e_tail, tab.mean(country_idx, am, a2)))


def lane_carbon(cols: Dict[str, np.ndarray], lane: np.ndarray,
                estimators: Sequence[CarbonEstimator],
                device_names: Sequence[Tuple[str, ...]],
                country_names: Sequence[Tuple[str, ...]],
                durations_s: Sequence[float],
                checkpoint_period_s: Optional[Sequence[float]] = None
                ) -> List[CarbonBreakdown]:
    """Per-lane CarbonBreakdowns from one shared lane-columnar session
    store (the lane-batched sweep engine's ``LaneAccumulator``), as
    segment reductions over the lane-sorted columns instead of S
    independent estimator passes.

    One stable argsort groups the rows by lane; each lane's contiguous
    segment then goes through its own estimator's ``_kg_rows`` +
    ``exact_sum``. Exact summation is order-independent, so each lane's
    segment reduction matches the per-lane ``batch_carbon`` result
    bit-for-bit by construction — the lane-equivalence invariant
    (lane-batched == serial, seed for seed) needs no summation-order
    gymnastics. Per-lane estimators may differ in any Environment knob —
    profiles, intensity tables, network model, PUE, server power.
    ``checkpoint_period_s`` carries each lane's effective salvage period
    (0 disables the split — lost == waste, like ``batch_carbon``)."""
    order = np.argsort(lane, kind="stable")
    bounds = np.searchsorted(lane[order], np.arange(len(estimators) + 1))
    dev_s = cols["device_idx"][order]
    ctry_s = cols["country_idx"][order]
    comp_s = cols["compute_s"][order]
    up_s = cols["upload_s"][order]
    down_s = cols["download_s"][order]
    bu_s = cols["bytes_up"][order]
    bd_s = cols["bytes_down"][order]
    st_s = cols["start_t"][order]
    out_s = cols["outcome"][order]
    out: List[CarbonBreakdown] = []
    for i, est in enumerate(estimators):
        sl = slice(int(bounds[i]), int(bounds[i + 1]))
        srv = est._server_kg_s(durations_s[i])
        P = float(checkpoint_period_s[i]) if checkpoint_period_s else 0.0
        if sl.start == sl.stop:
            out.append(CarbonBreakdown(0.0, 0.0, 0.0, srv,
                                       contributed_kg=srv, wasted_kg=0.0))
            continue
        kg = _kg_rows(est, device_names[i], dev_s[sl], country_names[i],
                      ctry_s[sl], comp_s[sl], up_s[sl], down_s[sl],
                      bu_s[sl], bd_s[sl], st_s[sl])
        okm = out_s[sl] == 0  # OUTCOME_CODE["completed"]
        im = (out_s[sl] == OUTCOME_CODE["interrupted"]) if P > 0 else None
        if im is None or not im.any():
            w = exact_sum(kg[:, ~okm])
            out.append(CarbonBreakdown(
                exact_sum(kg[0]), exact_sum(kg[1]), exact_sum(kg[2]), srv,
                contributed_kg=exact_sum(kg[:, okm]) + srv,
                wasted_kg=w, lost_kg=w))
            continue
        iw = np.flatnonzero(im)
        salv_kg, tail_kg = _salvage_kg(
            est, device_names[i], dev_s[sl][iw], country_names[i],
            ctry_s[sl][iw], comp_s[sl][iw], down_s[sl][iw], st_s[sl][iw],
            P)
        ow = ~okm & ~im
        salv = exact_sum(salv_kg)
        lost = ExactSum().add(tail_kg).add(kg[1, iw]).add(kg[2, iw]) \
            .add(kg[:, ow]).value()
        out.append(CarbonBreakdown(
            exact_sum(kg[0]), exact_sum(kg[1]), exact_sum(kg[2]), srv,
            contributed_kg=exact_sum(kg[:, okm]) + srv,
            wasted_kg=salv + lost, salvaged_kg=salv, lost_kg=lost))
    return out
