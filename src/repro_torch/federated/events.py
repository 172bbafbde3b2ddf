"""Session event sampling: device heterogeneity -> durations -> outcomes.

This is the simulator twin of the paper's production logger: for every
selected client we draw a device (fleet popularity weights) and a country
(participation mix), derive download/compute/upload durations from model
bytes, client data volume and device throughput, then resolve the outcome
(completed / dropped mid-session / 4-minute timeout). All durations carry a
lognormal jitter (thermal throttling, background load, link variance).

The engine is columnar: ``plan_batch``/``resolve_batch`` plan and resolve a
whole cohort in a handful of NumPy ops (array-vectorized splitmix64 counter
randomness, Box–Muller lognormal jitter, inverse-CDF Lomax sampling) and
return a ``PlanBatch``/``SessionBatch`` of columns. The scalar ``plan``/
``resolve`` are thin wrappers over batch size 1; ``plan_scalar``/
``resolve_scalar`` keep the original pure-Python path as the reference
implementation for equivalence tests and the runtime benchmark baseline.

``LaneSampler`` lifts the same columnar pass across the *spec* axis: L
compatible samplers (one per sweep lane, each with its own seed and
environment constants) plan/resolve as one ``(lane, batch)``-shaped batch,
bit-identical per row to each lane's own sampler — the substrate of the
lane-batched sweep engine in ``repro_torch.federated.runtime``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import FederatedConfig, ModelConfig
from repro_torch.core.availability import AvailabilityModel, exit_times
from repro_torch.core.faults import FaultModel
from repro_torch.core.profiles import (COUNTRY_MIX, DOWNLOAD_BPS, FLEET, UPLOAD_BPS,
                                 DeviceProfile)
from repro_torch.core.telemetry import OUTCOME_CODE, SessionBatch
from repro_torch.data.synthetic import client_num_samples
from repro_torch.kernels.int8_quant.ops import wire_bytes

_JITTER_SIGMA = 0.35
_M64 = (1 << 64) - 1
_U64 = np.uint64
_GOLDEN = 0x9E3779B97F4A7C15


def _splitmix64(x: int) -> int:
    """splitmix64 on python ints — cheap deterministic per-session
    randomness (np.random.default_rng construction is ~50us; this is <1us)."""
    x = (x + _GOLDEN) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


_INV53 = 1.0 / float(1 << 53)


def _uniforms(seed: int, client_id: int, round_idx: int, n: int):
    base = (((seed * 1_000_003 + round_idx) & 0xFFFFFFFF) * 2_654_435_761
            + (client_id & _M64) * 97) & _M64
    return [(_splitmix64((base + i * _GOLDEN) & _M64) >> 11)
            * _INV53 for i in range(n)]


def _splitmix64_arr(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 on uint64 arrays (wrapping semantics match the
    masked python-int version bit for bit)."""
    x = x + _U64(_GOLDEN)
    x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
    return x ^ (x >> _U64(31))


_LANES: dict = {}


def _lane_offsets(n: int) -> np.ndarray:
    try:
        return _LANES[n]
    except KeyError:
        _LANES[n] = np.arange(n, dtype=np.uint64) * _U64(_GOLDEN)
        return _LANES[n]


def _uniforms_batch(seed: int, client_ids: np.ndarray, round_idx: int,
                    n: int) -> np.ndarray:
    """(B, n) uniforms in [0,1); column i equals the scalar ``_uniforms``
    draw i for that (seed, client_id, round_idx) exactly."""
    cid = np.asarray(client_ids).astype(np.uint64)
    base0 = _U64((seed * 1_000_003 + round_idx) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        base = base0 * _U64(2_654_435_761) + cid * _U64(97)
        lanes = _lane_offsets(n)
        vals = _splitmix64_arr(base[:, None] + lanes[None, :])
    return (vals >> _U64(11)).astype(np.float64) * _INV53


def _plan_uniforms(seed: int, cid: np.ndarray, round_idx: int) -> np.ndarray:
    """The planner's 9 uniforms in one splitmix pass: columns 0..7 are the
    (seed, cid, round_idx) draws 0..7, column 8 is the (seed, cid, 0)
    draw 0 (the round-independent data-volume draw). Bit-identical to the
    two separate ``_uniforms_batch`` calls it replaces — one array pass
    instead of two matters because the async window merge issues many
    small dispatch batches."""
    with np.errstate(over="ignore"):
        base_r = _U64((seed * 1_000_003 + round_idx) & 0xFFFFFFFF) \
            * _U64(2_654_435_761) + cid * _U64(97)
        base_0 = _U64((seed * 1_000_003) & 0xFFFFFFFF) \
            * _U64(2_654_435_761) + cid * _U64(97)
        keys = np.empty((len(cid), 9), np.uint64)
        keys[:, :8] = base_r[:, None] + _lane_offsets(8)[None, :]
        keys[:, 8] = base_0
        vals = _splitmix64_arr(keys)
    return (vals >> _U64(11)).astype(np.float64) * _INV53


def _plan_uniforms_rows(seeds: np.ndarray, cid: np.ndarray,
                        round_idx: int) -> np.ndarray:
    """``_plan_uniforms`` with a per-row seed (uint64): the lane-batched
    engine keys every row's randomness on its lane's seed, so one splitmix
    pass plans a whole lane pack. Bit-identical per row to the scalar-seed
    version — uint64 wraparound is mod 2**64 and ``& 0xFFFFFFFF`` of a
    Python int picks the same low 32 bits."""
    with np.errstate(over="ignore"):
        base_r = ((seeds * _U64(1_000_003) + _U64(round_idx))
                  & _U64(0xFFFFFFFF)) * _U64(2_654_435_761) + cid * _U64(97)
        base_0 = ((seeds * _U64(1_000_003))
                  & _U64(0xFFFFFFFF)) * _U64(2_654_435_761) + cid * _U64(97)
        keys = np.empty((len(cid), 9), np.uint64)
        keys[:, :8] = base_r[:, None] + _lane_offsets(8)[None, :]
        keys[:, 8] = base_0
        vals = _splitmix64_arr(keys)
    return (vals >> _U64(11)).astype(np.float64) * _INV53


def _uniforms_batch_rows(seeds: np.ndarray, client_ids: np.ndarray,
                         round_idx: int, n: int) -> np.ndarray:
    """``_uniforms_batch`` with a per-row seed (see _plan_uniforms_rows)."""
    cid = np.asarray(client_ids).astype(np.uint64)
    with np.errstate(over="ignore"):
        base = ((seeds * _U64(1_000_003) + _U64(round_idx))
                & _U64(0xFFFFFFFF)) * _U64(2_654_435_761) + cid * _U64(97)
        vals = _splitmix64_arr(base[:, None] + _lane_offsets(n)[None, :])
    return (vals >> _U64(11)).astype(np.float64) * _INV53


def _fused_uniforms_rows(seeds: np.ndarray, cid: np.ndarray,
                         round_idx: int) -> np.ndarray:
    """Plan + resolve uniforms in ONE splitmix pass: columns 0..8 are the
    planner draws (see ``_plan_uniforms``), columns 9..10 the outcome
    draws (key base ``round_idx + 1_000_000``). Bit-identical per column
    to the two separate passes — every lane-loop dispatch plans and
    resolves back-to-back, so fusing halves the per-call fixed cost."""
    with np.errstate(over="ignore"):
        base_r = ((seeds * _U64(1_000_003) + _U64(round_idx))
                  & _U64(0xFFFFFFFF)) * _U64(2_654_435_761) + cid * _U64(97)
        base_0 = ((seeds * _U64(1_000_003))
                  & _U64(0xFFFFFFFF)) * _U64(2_654_435_761) + cid * _U64(97)
        base_v = ((seeds * _U64(1_000_003) + _U64(round_idx + 1_000_000))
                  & _U64(0xFFFFFFFF)) * _U64(2_654_435_761) + cid * _U64(97)
        keys = np.empty((len(cid), 11), np.uint64)
        keys[:, :8] = base_r[:, None] + _lane_offsets(8)[None, :]
        keys[:, 8] = base_0
        keys[:, 9:11] = base_v[:, None] + _lane_offsets(2)[None, :]
        vals = _splitmix64_arr(keys)
    return (vals >> _U64(11)).astype(np.float64) * _INV53


_SLOT_MIX = 0xD1342543DE82EF95   # per-slot lane spacing (distinct from _GOLDEN)


def slot_stream_ids(seed: int, slots: Union[np.ndarray, Sequence[int]],
                    generations: Union[np.ndarray, Sequence[int]],
                    population: int) -> np.ndarray:
    """Counter-based replacement-id streams for the async engine: the g-th
    replacement dispatched into in-flight slot s draws client id
    ``splitmix64((seed, s, g))`` — a deterministic function of the slot and
    its replacement count alone. Identity never depends on global arrival
    order, which is what lets ``AsyncStrategy`` resolve whole windows of
    chained replacements columnar-ly instead of popping a heap."""
    s = np.asarray(slots, dtype=np.uint64)
    g = np.asarray(generations, dtype=np.uint64)
    base0 = _U64(((seed & 0xFFFFFFFF) * 0x9E3779B9 + 0x7F4A7C15) & _M64)
    with np.errstate(over="ignore"):
        h = _splitmix64_arr(base0 + s * _U64(_SLOT_MIX) + g * _U64(_GOLDEN))
    u = (h >> _U64(11)).astype(np.float64) * _INV53
    return (u * population).astype(np.int64)


def slot_stream_id(seed: int, slot: int, generation: int,
                   population: int) -> int:
    """Scalar twin of ``slot_stream_ids`` (used by the reference oracle);
    pure python-int splitmix so the scalar engine stays numpy-free on its
    per-pop path — bit-identical to the batch version."""
    base = ((seed & 0xFFFFFFFF) * 0x9E3779B9 + 0x7F4A7C15) & _M64
    h = _splitmix64((base + slot * _SLOT_MIX + generation * _GOLDEN) & _M64)
    return int((h >> 11) * _INV53 * population)


_RESERVOIR_MIX = 0x2545F4914F6CDD1D   # reservoir-key lane for streaming logs


def reservoir_keys(seed: int,
                   indices: Union[np.ndarray, Sequence[int]]) -> np.ndarray:
    """Raw uint64 splitmix keys for the streaming-telemetry reservoir:
    session ``i`` (its global, engine-order index within the task) hashes
    to ``splitmix64((seed, i))`` along a dedicated ``_RESERVOIR_MIX`` lane
    so reservoir keys never alias the planner / outcome / slot / probe
    streams. The retained sample is the bottom-k of these keys — a pure
    function of ``(seed, global session index)``, so it is identical
    regardless of chunk size, lane packing, or worker count."""
    idx = np.asarray(indices, dtype=np.uint64)
    base0 = _U64(((seed & 0xFFFFFFFF) * 0x9E3779B9 + 0x7F4A7C15) & _M64)
    with np.errstate(over="ignore"):
        return _splitmix64_arr(base0 + idx * _U64(_RESERVOIR_MIX))


_RETRY_MIX = 0xE7037ED1A0B428DB   # retry-id lane spacing (recovery policy)


def retry_stream_ids(seed: int, units: Union[np.ndarray, Sequence[int]],
                     attempts: Union[np.ndarray, Sequence[int]],
                     population: int) -> np.ndarray:
    """Counter-based retry-id streams for the recovery policy: the a-th
    retry re-dispatched for recovery unit u draws client id
    ``splitmix64((seed, u, a))`` along a dedicated ``_RETRY_MIX`` lane, so
    retry identities never alias the plain replacement streams (async:
    u = in-flight slot, a = generation; sync: u = cohort position,
    a = round * (retry_limit + 1) + attempt). Pure counter functions keep
    serial, lane-batched and oracle retry chains seed-for-seed identical."""
    s = np.asarray(units, dtype=np.uint64)
    g = np.asarray(attempts, dtype=np.uint64)
    base0 = _U64(((seed & 0xFFFFFFFF) * 0x9E3779B9 + 0x7F4A7C15) & _M64)
    with np.errstate(over="ignore"):
        h = _splitmix64_arr(base0 + s * _U64(_RETRY_MIX) + g * _U64(_GOLDEN))
    u = (h >> _U64(11)).astype(np.float64) * _INV53
    return (u * population).astype(np.int64)


def retry_stream_id(seed: int, unit: int, attempt: int,
                    population: int) -> int:
    """Scalar twin of ``retry_stream_ids`` (the reference oracle's path) —
    bit-identical to the batch version."""
    base = ((seed & 0xFFFFFFFF) * 0x9E3779B9 + 0x7F4A7C15) & _M64
    h = _splitmix64((base + unit * _RETRY_MIX + attempt * _GOLDEN) & _M64)
    return int((h >> 11) * _INV53 * population)


_PROBE_MIX = 0xA0761D6478BD642F   # probe-lane spacing for carbon-aware picks


def probe_uniforms(seed: int, slots: Union[np.ndarray, Sequence[int]],
                   generations: Union[np.ndarray, Sequence[int]],
                   n: int) -> np.ndarray:
    """(B, n) per-(slot, generation) selection-probe uniform streams for
    the carbon-aware coordinator: column 0 is the exploration draw,
    columns 1.. are candidate-id draws. Keyed like ``slot_stream_ids`` but
    spread along a distinct probe lane (``_PROBE_MIX``), so carbon-aware
    probing never aliases the plain async replacement streams. Identity
    stays a pure counter function of (seed, slot, generation, probe) —
    independent of global arrival order, which is what lets the async
    window merge, the lane engine and the scalar oracle all replay the
    same picks."""
    s = np.asarray(slots, dtype=np.uint64)
    g = np.asarray(generations, dtype=np.uint64)
    base0 = _U64(((seed & 0xFFFFFFFF) * 0x9E3779B9 + 0x7F4A7C15) & _M64)
    lanes = (np.arange(1, n + 1, dtype=np.uint64)) * _U64(_PROBE_MIX)
    with np.errstate(over="ignore"):
        base = base0 + s * _U64(_SLOT_MIX) + g * _U64(_GOLDEN)
        h = _splitmix64_arr(base[:, None] + lanes[None, :])
    return (h >> _U64(11)).astype(np.float64) * _INV53


def _lognormal(u1: float, u2: float, sigma: float) -> float:
    # Box-Muller
    r = math.sqrt(-2.0 * math.log(max(u1, 1e-12)))
    return math.exp(sigma * r * math.cos(2.0 * math.pi * u2))


def _lognormal_arr(u1: np.ndarray, u2: np.ndarray,
                   sigma: float) -> np.ndarray:
    r = np.sqrt(-2.0 * np.log(np.maximum(u1, 1e-12)))
    return np.exp(sigma * r * np.cos(2.0 * np.pi * u2))


def _pareto_samples(u: float, mean: float = 34.0, shape: float = 1.8) -> int:
    # inverse-CDF Lomax with E = scale/(shape-1)
    scale = mean * (shape - 1.0)
    n = int(scale * ((max(1.0 - u, 1e-12)) ** (-1.0 / shape) - 1.0)) + 1
    return max(2, min(n, 4096))


def _pareto_samples_arr(u: np.ndarray, mean: float = 34.0,
                        shape: float = 1.8) -> np.ndarray:
    scale = mean * (shape - 1.0)
    x = scale * (np.maximum(1.0 - u, 1e-12) ** (-1.0 / shape) - 1.0)
    return np.clip(x.astype(np.int64) + 1, 2, 4096)


@dataclass(frozen=True)
class SessionPlan:
    """Durations + bytes for one client session, before outcome resolution."""
    client_id: int
    device: DeviceProfile
    country: str
    download_s: float
    compute_s: float
    upload_s: float
    bytes_down: float
    bytes_up: float
    n_examples: int


@dataclass(frozen=True)
class PlanBatch:
    """A planned cohort as columns (`device_idx` indexes the sampler's
    fleet, `country_idx` its country list)."""
    client_ids: np.ndarray       # int64
    device_idx: np.ndarray       # int32
    country_idx: np.ndarray      # int32
    download_s: np.ndarray       # float64
    compute_s: np.ndarray
    upload_s: np.ndarray
    bytes_down: np.ndarray
    bytes_up: np.ndarray
    n_examples: np.ndarray       # int64

    def __len__(self) -> int:
        return int(self.client_ids.shape[0])


class SessionSampler:
    def __init__(self, model_cfg: ModelConfig, fed: FederatedConfig,
                 seq_len: int, param_bytes: Optional[float] = None,
                 fleet: Optional[Sequence[DeviceProfile]] = None,
                 country_mix: Optional[Mapping[str, float]] = None,
                 download_bps: Optional[float] = None,
                 upload_bps: Optional[float] = None,
                 fault: Optional[FaultModel] = None,
                 availability: Optional[AvailabilityModel] = None):
        self.cfg = model_cfg
        self.fed = fed
        self.seq_len = seq_len
        fleet = tuple(fleet) if fleet is not None else FLEET
        country_mix = dict(country_mix) if country_mix is not None \
            else COUNTRY_MIX
        self.fleet = fleet
        self.download_bps = download_bps or DOWNLOAD_BPS
        self.upload_bps = upload_bps or UPLOAD_BPS
        n_params = model_cfg.param_count()
        self.n_params = n_params
        full = 4.0 * n_params  # f32 on the wire
        if fed.compression == "int8":
            self.bytes_down = float(wire_bytes(n_params, fed.quant_block))
            self.bytes_up = float(wire_bytes(n_params, fed.quant_block))
            self.compute_overhead = 1.05   # on-device (de)quant cost
        else:
            self.bytes_down = param_bytes or full
            self.bytes_up = param_bytes or full
            self.compute_overhead = 1.0
        self.flops_per_token = model_cfg.train_flops_per_token()
        self._countries = list(country_mix)
        cw = np.asarray(list(country_mix.values()), np.float64)
        self._ccum = np.cumsum(cw / cw.sum())
        dw = np.asarray([p.weight for p in fleet], np.float64)
        self._dcum = np.cumsum(dw / dw.sum())
        self._gflops = np.asarray([p.train_gflops for p in fleet], np.float64)
        self.device_names: Tuple[str, ...] = tuple(p.name for p in fleet)
        self.country_names: Tuple[str, ...] = tuple(self._countries)
        if fed.mode == "carbon-aware" and fed.carbon_topk > len(
                self._countries):
            raise ValueError(
                f"carbon_topk ({fed.carbon_topk}) exceeds the country "
                f"vocabulary ({len(self._countries)} countries in the "
                "participation mix)")
        # fault injection: a disabled (all-zero) model keeps has_faults
        # False and every resolve path runs the fault-free code verbatim
        self.fault = fault
        self.has_faults = fault is not None and fault.enabled
        if self.has_faults:
            self._hazard_tab = fault.hazard_table(self.country_names)
            self._burst_start, self._burst_end = fault.burst_windows()
            self._burst_p = fault.burst_fail_prob
        # availability: a disabled (all-available) model keeps has_avail
        # False and every resolve path runs the availability-free code
        # verbatim — the admission/churn uniform is never even drawn
        self.availability = availability
        self.has_avail = availability is not None and availability.enabled
        if self.has_avail:
            self._avail_tab = availability.eligibility_table(
                self.country_names)

    def country_draw(self, client_ids: Union[np.ndarray, Sequence[int]],
                     round_idx: int) -> np.ndarray:
        """Just the country column of ``plan_batch`` (uniform draw 1 of
        the planner's splitmix pass) — what the carbon-aware coordinator
        uses to screen candidate ids without planning full sessions.
        Bit-identical to the ``country_idx`` a subsequent ``plan_batch``
        of the same ids would produce."""
        cid = np.asarray(client_ids, np.int64).astype(np.uint64)
        with np.errstate(over="ignore"):
            base_r = _U64((self.fed.seed * 1_000_003 + round_idx)
                          & 0xFFFFFFFF) * _U64(2_654_435_761) \
                + cid * _U64(97)
            vals = _splitmix64_arr(base_r + _U64(_GOLDEN))
        u1 = (vals >> _U64(11)).astype(np.float64) * _INV53
        return np.searchsorted(self._ccum, u1).astype(np.int32)

    # ------------------------------------------------------- availability
    def admission_uniforms(self, client_ids: Union[np.ndarray,
                                                   Sequence[int]],
                           round_idx: int) -> np.ndarray:
        """The availability-model admission/churn uniform for each
        ``(seed, client_id, round_idx)`` — a dedicated counter stream
        (key base ``round_idx + 3_000_000``) so it never aliases the
        planner, outcome or fault draws. The carbon-aware coordinator
        re-derives these to screen candidates; bit-identical to the draw
        a subsequent ``resolve_batch`` of the same ids consumes."""
        return _uniforms_batch(self.fed.seed, client_ids,
                               round_idx + 3_000_000, 1)[:, 0]

    def _avail_masks(self, country_idx: np.ndarray, start: np.ndarray,
                     ua: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Availability overlay for one cohort: ``(not_admitted,
        exit_t)``. A device is eligible exactly while ``ua <
        eligibility(t)`` — one uniform couples admission (at ``start``)
        and mid-flight churn (the first segment boundary where the curve
        falls to or below the draw). Element-wise, so any per-lane subset
        of a pack reproduces this bit for bit."""
        e0 = self._avail_tab.at(country_idx, start)
        return ua >= e0, exit_times(self._avail_tab, country_idx, ua, start)

    # ----------------------------------------------------------- faults
    def _fault_masks(self, country_idx: np.ndarray, start: np.ndarray,
                     end_full: np.ndarray, full: np.ndarray,
                     uf: np.ndarray, pre: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Fault overlay for one cohort: ``(failed, fault_burn)``.

        ``uf`` is the 3-column fault-uniform block (hazard draw, burst
        draw, hazard burn point); ``pre`` masks rows already resolved by a
        higher-precedence outcome (dropout, timeout). A hazard failure
        dies at a random point of its span; a burst failure dies the
        moment the first overlapping outage window opens (sessions born
        inside a window die instantly). Everything is element-wise, so
        any per-lane subset of a pack reproduces this bit for bit."""
        hz = self._hazard_tab.at(country_idx, start)
        fh = ~pre & (uf[:, 0] < hz)
        nb = len(self._burst_start)
        if nb:
            # first window whose end is past our start; overlaps iff it
            # also opens before our end (starts are strictly increasing)
            i = np.searchsorted(self._burst_end, start, side="right")
            valid = i < nb
            bs = self._burst_start[np.minimum(i, nb - 1)]
            fb = ~pre & ~fh & valid & (bs < end_full) \
                & (uf[:, 1] < self._burst_p)
            t_hit = np.maximum(start, bs)
        else:
            fb = np.zeros(len(start), bool)
            t_hit = start
        fburn = np.where(fh, uf[:, 2] * full,
                         np.clip(t_hit - start, 0.0, full))
        return fh | fb, fburn

    # ------------------------------------------------------------ columnar
    def plan_batch(self, client_ids: Union[np.ndarray, Sequence[int]],
                   round_idx: int) -> PlanBatch:
        """Plan a whole cohort in a handful of NumPy ops. Column i of the
        uniform block matches scalar draw i, so this reproduces
        ``plan_scalar`` per client bit-for-bit (modulo libm ulps)."""
        ids = np.asarray(client_ids, np.int64)
        u = _plan_uniforms(self.fed.seed, ids.astype(np.uint64), round_idx)
        dev = np.searchsorted(self._dcum, u[:, 0]).astype(np.int32)
        ctry = np.searchsorted(self._ccum, u[:, 1]).astype(np.int32)
        n_ex = _pareto_samples_arr(u[:, 8])
        tokens = n_ex * (self.seq_len * self.fed.local_epochs)
        # one Box-Muller pass over the three (u1, u2) jitter pairs —
        # columns (2,3) compute, (4,5) download, (6,7) upload
        jit = _lognormal_arr(u[:, 2:8:2], u[:, 3:8:2], _JITTER_SIGMA)
        compute_s = (tokens * self.flops_per_token * self.compute_overhead
                     / (self._gflops[dev] * 1e9)) * jit[:, 0]
        download_s = 8.0 * self.bytes_down / self.download_bps * jit[:, 1]
        upload_s = 8.0 * self.bytes_up / self.upload_bps * jit[:, 2]
        n = len(ids)
        return PlanBatch(ids, dev, ctry, download_s, compute_s, upload_s,
                         np.full(n, self.bytes_down),
                         np.full(n, self.bytes_up), n_ex)

    def resolve_batch(self, pb: PlanBatch, round_idx: int,
                      start_t: Union[float, np.ndarray],
                      deadline: Optional[float] = None,
                      late_code: Optional[int] = None
                      ) -> Tuple[SessionBatch, np.ndarray]:
        """Resolve a planned cohort's outcomes; returns ``(batch, ok)``
        where ``ok[i]`` is True iff session i completed (contributed).

        start_t may be a scalar or a per-client array of task-clock starts;
        deadline is the absolute task-clock time after which the round no
        longer accepts results (sync round close / over-selection cancel);
        late_code relabels deadline-cut rows (default "dropped" — the sync
        over-selection path passes "cancelled" so the surplus it invited is
        visibly its own doing). Downlink bytes are prorated by the
        completed download fraction so a client dropped mid-download isn't
        charged the full payload."""
        fed = self.fed
        n = len(pb)
        uu = _uniforms_batch(fed.seed, pb.client_ids, round_idx + 1_000_000, 2)
        full_d, full_c, full_u = pb.download_s, pb.compute_s, pb.upload_s
        start = np.broadcast_to(np.asarray(start_t, np.float64), (n,))
        full = full_d + full_c + full_u
        # same association order as the scalar reference, so the session
        # whose end DEFINES the round deadline compares equal (not late)
        end_full = start + full_d + full_c + full_u

        dropped = uu[:, 0] < fed.dropout_rate
        timeout = ~dropped & (full_c > fed.client_timeout_s)
        if self.has_avail:
            # inadmissible devices interrupt at zero cost; admitted ones
            # interrupt mid-flight when their curve dips to their draw
            ua = self.admission_uniforms(pb.client_ids, round_idx)
            not_adm, exit_t = self._avail_masks(pb.country_idx, start, ua)
            churned = ~not_adm & ~dropped & ~timeout & (exit_t < end_full)
            inter = not_adm | churned
            iburn = np.where(not_adm, 0.0,
                             np.minimum(np.maximum(exit_t - start, 0.0),
                                        full))
            dropped &= ~not_adm
            timeout &= ~not_adm
        else:
            inter = None
        if self.has_faults:
            pre = dropped | timeout
            if inter is not None:
                pre = pre | inter
            uf = _uniforms_batch(fed.seed, pb.client_ids,
                                 round_idx + 2_000_000, 3)
            failed, fburn = self._fault_masks(pb.country_idx, start,
                                              end_full, full, uf, pre)
        else:
            failed = None
        if deadline is not None:
            late = ~dropped & ~timeout & (end_full > deadline)
            if failed is not None:
                late &= ~failed
            if inter is not None:
                late &= ~inter
        else:
            late = np.zeros(n, bool)
        # burn budget for the cut-short sessions: dropout picks a random
        # stop point, a deadline cut burns until the round closes
        burn = uu[:, 1] * full
        if deadline is not None:
            burn = np.where(late, np.maximum(0.0, deadline - start), burn)
        cut = dropped | late
        if failed is not None:
            burn = np.where(failed, fburn, burn)
            cut = cut | failed
        if inter is not None:
            burn = np.where(inter, iburn, burn)
            cut = cut | inter
        d = np.where(cut, np.minimum(full_d, burn), full_d)
        c = np.where(cut, np.minimum(full_c,
                                     np.maximum(0.0, burn - full_d)),
                     full_c)
        u = np.where(cut, np.minimum(full_u,
                                     np.maximum(0.0, burn - full_d - full_c)),
                     full_u)
        # the 4-minute training timeout truncates compute and skips upload
        c = np.where(timeout, fed.client_timeout_s, c)
        u = np.where(timeout, 0.0, u)
        end = np.where(dropped, start + burn, end_full)
        end = np.where(timeout, start + full_d + fed.client_timeout_s, end)
        if failed is not None:
            end = np.where(failed, start + fburn, end)
        if inter is not None:
            end = np.where(inter, start + iburn, end)
        if deadline is not None:
            # retries may start after the round closed: never end < start
            end = np.where(late, np.maximum(start, deadline), end)

        outcome = np.zeros(n, np.int8)  # completed
        outcome[cut] = OUTCOME_CODE["dropped"]
        outcome[timeout] = OUTCOME_CODE["timeout"]
        if failed is not None:
            outcome[failed] = OUTCOME_CODE["failed"]
        if inter is not None:
            outcome[inter] = OUTCOME_CODE["interrupted"]
        if late_code is not None and late_code != OUTCOME_CODE["dropped"]:
            outcome[late] = late_code
        ok = outcome == OUTCOME_CODE["completed"]
        frac_down = np.divide(d, full_d, out=np.zeros(n), where=full_d > 0)
        batch = SessionBatch(
            device_names=self.device_names,
            country_names=self.country_names,
            client_id=pb.client_ids,
            round_idx=np.full(n, round_idx, np.int64),
            device_idx=pb.device_idx, country_idx=pb.country_idx,
            download_s=d, compute_s=c, upload_s=u,
            bytes_down=pb.bytes_down * np.minimum(1.0, frac_down),
            bytes_up=np.where(ok, pb.bytes_up, 0.0),
            start_t=np.asarray(start, np.float64).copy(),
            end_t=end, outcome=outcome,
            staleness=np.zeros(n, np.int32))
        return batch, ok

    def apply_deadline(self, pb: PlanBatch, batch: SessionBatch,
                       ok: np.ndarray, deadline: float,
                       late_code: Optional[int] = None) -> None:
        """Patch a no-deadline ``resolve_batch`` into its with-deadline
        twin, in place (the serial twin of ``LaneSampler.apply_deadline``):
        only completed rows that finish past the deadline change — they
        burn budget until the round closes and drop (or relabel to
        ``late_code`` — the over-selection surplus outcome). Bit-identical
        to resolving with the deadline up front, because dropped / timeout
        / failed / interrupted rows never depend on it. Lets the sync
        fault path resolve retry chains before the round deadline is
        known."""
        idx = np.flatnonzero(ok & (batch.end_t > deadline))
        if not len(idx):
            return
        burn = np.maximum(0.0, deadline - batch.start_t[idx])
        fd, fc, fu = pb.download_s[idx], pb.compute_s[idx], pb.upload_s[idx]
        d = np.minimum(fd, burn)
        c = np.minimum(fc, np.maximum(0.0, burn - fd))
        u = np.minimum(fu, np.maximum(0.0, burn - fd - fc))
        frac = np.divide(d, fd, out=np.zeros(len(idx)), where=fd > 0)
        batch.download_s[idx] = d
        batch.compute_s[idx] = c
        batch.upload_s[idx] = u
        batch.bytes_down[idx] = pb.bytes_down[idx] * np.minimum(1.0, frac)
        batch.bytes_up[idx] = 0.0
        batch.end_t[idx] = np.maximum(deadline, batch.start_t[idx])
        batch.outcome[idx] = OUTCOME_CODE["dropped"] if late_code is None \
            else late_code
        ok[idx] = False

    # ------------------------------------------------- scalar (batch of 1)
    def plan(self, client_id: int, round_idx: int) -> SessionPlan:
        pb = self.plan_batch(np.asarray([client_id], np.int64), round_idx)
        return SessionPlan(client_id, self.fleet[int(pb.device_idx[0])],
                           self._countries[int(pb.country_idx[0])],
                           float(pb.download_s[0]), float(pb.compute_s[0]),
                           float(pb.upload_s[0]), self.bytes_down,
                           self.bytes_up, int(pb.n_examples[0]))

    def resolve(self, plan: SessionPlan, round_idx: int, start_t: float,
                deadline: Optional[float] = None,
                late_code: Optional[int] = None) -> Tuple[dict, bool]:
        """Resolve the outcome; returns (session_kwargs, contributed)."""
        pb = PlanBatch(np.asarray([plan.client_id], np.int64),
                       np.asarray([self.fleet.index(plan.device)], np.int32),
                       np.asarray([self._countries.index(plan.country)],
                                  np.int32),
                       np.asarray([plan.download_s]),
                       np.asarray([plan.compute_s]),
                       np.asarray([plan.upload_s]),
                       np.asarray([plan.bytes_down]),
                       np.asarray([plan.bytes_up]),
                       np.asarray([plan.n_examples], np.int64))
        b, ok = self.resolve_batch(pb, round_idx, start_t, deadline,
                                   late_code=late_code)
        s = b.to_sessions()[0]
        kw = {f: getattr(s, f) for f in
              ("client_id", "round_idx", "device", "country", "download_s",
               "compute_s", "upload_s", "bytes_down", "bytes_up", "start_t",
               "end_t", "outcome")}
        return kw, bool(ok[0])

    # ------------------------------------------------- reference (scalar)
    def plan_scalar(self, client_id: int, round_idx: int) -> SessionPlan:
        """Original pure-Python planner — reference implementation for
        equivalence tests and the scalar-engine benchmark baseline."""
        u = _uniforms(self.fed.seed, client_id, round_idx, 10)
        device = self.fleet[int(np.searchsorted(self._dcum, u[0]))]
        country = self._countries[int(np.searchsorted(self._ccum, u[1]))]
        n_ex = _pareto_samples(
            _uniforms(self.fed.seed, client_id, 0, 1)[0])
        tokens = n_ex * self.seq_len * self.fed.local_epochs
        compute_s = (tokens * self.flops_per_token * self.compute_overhead
                     / (device.train_gflops * 1e9)) \
            * _lognormal(u[2], u[3], _JITTER_SIGMA)
        download_s = 8.0 * self.bytes_down / self.download_bps \
            * _lognormal(u[4], u[5], _JITTER_SIGMA)
        upload_s = 8.0 * self.bytes_up / self.upload_bps \
            * _lognormal(u[6], u[7], _JITTER_SIGMA)
        return SessionPlan(client_id, device, country, download_s, compute_s,
                           upload_s, self.bytes_down, self.bytes_up, n_ex)

    def resolve_scalar(self, plan: SessionPlan, round_idx: int,
                       start_t: float, deadline: Optional[float] = None,
                       late_outcome: Optional[str] = None
                       ) -> Tuple[dict, bool]:
        """Original pure-Python outcome resolution (see plan_scalar)."""
        fed = self.fed
        uu = _uniforms(fed.seed, plan.client_id, round_idx + 1_000_000, 2)
        full_d, full_c, full_u = plan.download_s, plan.compute_s, plan.upload_s
        end = start_t + full_d + full_c + full_u
        outcome = "completed"
        d, c, u = full_d, full_c, full_u

        not_adm = False
        churn_burn = None
        if self.has_avail:
            ua = _uniforms(fed.seed, plan.client_id,
                           round_idx + 3_000_000, 1)[0]
            ci = np.asarray([self._countries.index(plan.country)], np.int32)
            e0 = float(self._avail_tab.at(ci, np.asarray([start_t]))[0])
            not_adm = ua >= e0
            if not not_adm and not (uu[0] < fed.dropout_rate
                                    or full_c > fed.client_timeout_s):
                et = float(exit_times(self._avail_tab, ci,
                                      np.asarray([ua]),
                                      np.asarray([start_t]))[0])
                if et < end:
                    full = full_d + full_c + full_u
                    churn_burn = min(max(et - start_t, 0.0), full)

        fail_burn = None
        if self.has_faults and not (uu[0] < fed.dropout_rate
                                    or full_c > fed.client_timeout_s
                                    or not_adm or churn_burn is not None):
            uf = _uniforms(fed.seed, plan.client_id, round_idx + 2_000_000, 3)
            ci = np.asarray([self._countries.index(plan.country)], np.int32)
            hz = float(self._hazard_tab.at(ci, np.asarray([start_t]))[0])
            full = full_d + full_c + full_u
            if uf[0] < hz:
                fail_burn = uf[2] * full
            elif len(self._burst_start):
                i = int(np.searchsorted(self._burst_end, start_t,
                                        side="right"))
                if i < len(self._burst_start) \
                        and self._burst_start[i] < end \
                        and uf[1] < self._burst_p:
                    fail_burn = min(max(0.0, float(self._burst_start[i])
                                        - start_t), full)

        if not_adm:
            # refused at admission: the device isn't eligible right now
            d = c = u = 0.0
            end = start_t
            outcome = "interrupted"
        elif uu[0] < fed.dropout_rate:
            # device stopped being idle/charging at a random point
            frac = uu[1]
            burn = frac * (full_d + full_c + full_u)
            d = min(full_d, burn)
            c = min(full_c, max(0.0, burn - full_d))
            u = min(full_u, max(0.0, burn - full_d - full_c))
            end = start_t + burn
            outcome = "dropped"
        elif full_c > fed.client_timeout_s:
            # the paper's 4-minute training timeout
            c = fed.client_timeout_s
            u = 0.0
            end = start_t + d + c
            outcome = "timeout"
        elif churn_burn is not None:
            # exited eligibility mid-flight (unplugged, off wifi)
            d = min(full_d, churn_burn)
            c = min(full_c, max(0.0, churn_burn - full_d))
            u = min(full_u, max(0.0, churn_burn - full_d - full_c))
            end = start_t + churn_burn
            outcome = "interrupted"
        elif fail_burn is not None:
            # killed by the fault model (hazard or burst)
            d = min(full_d, fail_burn)
            c = min(full_c, max(0.0, fail_burn - full_d))
            u = min(full_u, max(0.0, fail_burn - full_d - full_c))
            end = start_t + fail_burn
            outcome = "failed"
        elif deadline is not None and end > deadline:
            burn = max(0.0, deadline - start_t)
            d = min(full_d, burn)
            c = min(full_c, max(0.0, burn - full_d))
            u = min(full_u, max(0.0, burn - full_d - full_c))
            end = max(start_t, deadline)   # retries may start post-close
            outcome = late_outcome or "dropped"

        frac_down = d / full_d if full_d > 0 else 0.0
        kw = dict(client_id=plan.client_id, round_idx=round_idx,
                  device=plan.device.name, country=plan.country,
                  download_s=d, compute_s=c, upload_s=u,
                  bytes_down=plan.bytes_down * min(1.0, frac_down),
                  bytes_up=plan.bytes_up if outcome == "completed" else 0.0,
                  start_t=start_t, end_t=end, outcome=outcome)
        return kw, outcome == "completed"


# ---------------------------------------------------------------------------
# Lane-batched sampling: many compatible samplers, one columnar pass
# ---------------------------------------------------------------------------

def _pad2(rows: Sequence[np.ndarray], pad: float) -> np.ndarray:
    """Stack ragged per-lane 1-D tables into one (L, max_len) array."""
    width = max((len(r) for r in rows), default=0) or 1
    out = np.full((len(rows), width), pad, np.float64)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


class LaneSampler:
    """L independent ``SessionSampler``s advanced as ONE columnar batch.

    Every row of a plan/resolve call carries a ``lane`` id that selects
    that lane's seed and environment constants (fleet tables, country mix,
    bandwidths, payload bytes, model FLOPs). Because all per-session
    randomness is counter-based splitmix64 keyed on ``(seed, client_id,
    round_idx)`` — never on shared mutable RNG state — batching rows from
    many lanes into one array pass reproduces each lane's own
    ``SessionSampler.plan_batch``/``resolve_batch`` bit for bit; only the
    array shapes change. This is what turns S small sweep runs into one
    (S*B)-row simulation (the lane-batched sweep engine).

    Device/country indices stay *lane-local* (each lane keeps its own
    vocabularies, mirrored in ``device_names``/``country_names``), so a
    per-lane slice of the output columns is directly comparable to that
    lane's serial ``SessionBatch``.
    """

    def __init__(self, samplers: Sequence[SessionSampler]):
        self.samplers = list(samplers)
        self.n_lanes = len(self.samplers)
        assert self.n_lanes > 0
        ss = self.samplers
        self.seeds = np.asarray([s.fed.seed for s in ss], np.uint64)
        self.dropout_rate = np.asarray([s.fed.dropout_rate for s in ss])
        self.timeout_s = np.asarray([s.fed.client_timeout_s for s in ss])
        self.bytes_down = np.asarray([s.bytes_down for s in ss])
        self.bytes_up = np.asarray([s.bytes_up for s in ss])
        self.overhead = np.asarray([s.compute_overhead for s in ss])
        self.fpt = np.asarray([s.flops_per_token for s in ss])
        self.tokens_per_ex = np.asarray(
            [s.seq_len * s.fed.local_epochs for s in ss], np.int64)
        self.down_bps = np.asarray([s.download_bps for s in ss])
        self.up_bps = np.asarray([s.upload_bps for s in ss])
        self.device_names = [s.device_names for s in ss]
        self.country_names = [s.country_names for s in ss]
        # per-lane cumulative-weight / throughput tables, padded so one
        # fancy-indexed comparison replaces L searchsorted calls (pad 2.0
        # can never sit below a uniform in [0,1), so pads never count)
        self._dcum2 = _pad2([s._dcum for s in ss], 2.0)
        self._ccum2 = _pad2([s._ccum for s in ss], 2.0)
        self._gfl2 = _pad2([s._gflops for s in ss], 1.0)
        # fault lanes delegate the overlay to their own sampler's
        # element-wise _fault_masks (per-lane hazard tables/burst windows);
        # an all-fault-free pack skips the overlay entirely
        self._fault_lanes = np.asarray([s.has_faults for s in ss], bool)
        self.any_faults = bool(self._fault_lanes.any())
        # availability lanes delegate the admission/churn overlay to their
        # own sampler's element-wise _avail_masks (per-lane eligibility
        # tables); an all-available pack never draws the admission uniform
        self._avail_lanes = np.asarray([s.has_avail for s in ss], bool)
        self.any_avail = bool(self._avail_lanes.any())

    # ------------------------------------------------------------- planning
    def _plan_from_u(self, lane: np.ndarray, ids: np.ndarray,
                     u: np.ndarray) -> PlanBatch:
        """Plan math over a uniforms block (columns 0..8, see
        ``_plan_uniforms``)."""
        # count-of-strictly-less == np.searchsorted(cum, u, side="left")
        dev = (self._dcum2[lane] < u[:, 0:1]).sum(axis=1).astype(np.int32)
        ctry = (self._ccum2[lane] < u[:, 1:2]).sum(axis=1).astype(np.int32)
        n_ex = _pareto_samples_arr(u[:, 8])
        tokens = n_ex * self.tokens_per_ex[lane]
        jit = _lognormal_arr(u[:, 2:8:2], u[:, 3:8:2], _JITTER_SIGMA)
        compute_s = (tokens * self.fpt[lane] * self.overhead[lane]
                     / (self._gfl2[lane, dev] * 1e9)) * jit[:, 0]
        download_s = 8.0 * self.bytes_down[lane] / self.down_bps[lane] \
            * jit[:, 1]
        upload_s = 8.0 * self.bytes_up[lane] / self.up_bps[lane] * jit[:, 2]
        return PlanBatch(ids, dev, ctry, download_s, compute_s, upload_s,
                         self.bytes_down[lane], self.bytes_up[lane], n_ex)

    def plan_batch(self, lane: np.ndarray,
                   client_ids: Union[np.ndarray, Sequence[int]],
                   round_idx: int) -> PlanBatch:
        """Plan one row per (lane, client): the lane column selects each
        row's seed and environment constants. Matches each lane's own
        ``SessionSampler.plan_batch`` bit for bit."""
        ids = np.asarray(client_ids, np.int64)
        lane = np.asarray(lane, np.intp)
        u = _plan_uniforms_rows(self.seeds[lane], ids.astype(np.uint64),
                                round_idx)
        return self._plan_from_u(lane, ids, u)

    # ------------------------------------------------------------ resolving
    def plan_resolve(self, lane: np.ndarray,
                     client_ids: Union[np.ndarray, Sequence[int]],
                     round_idx: int, start_t: Union[float, np.ndarray],
                     rem: Optional[np.ndarray] = None
                     ) -> Tuple[PlanBatch, Dict[str, np.ndarray],
                                np.ndarray]:
        """Plan AND resolve one row per (lane, client) off a single fused
        splitmix pass — the lane loops' dispatch fast path (they always
        resolve what they just planned). ``rem`` scales each row's planned
        compute before resolution (checkpoint/resume retries redo only the
        remainder; ``x * 1.0`` is IEEE-exact, so all-ones rows are
        untouched). Returns ``(pb, cols, ok)``, bit-identical to
        ``plan_batch`` + compute scaling + ``resolve_batch``."""
        ids = np.asarray(client_ids, np.int64)
        lane = np.asarray(lane, np.intp)
        u = _fused_uniforms_rows(self.seeds[lane], ids.astype(np.uint64),
                                 round_idx)
        pb = self._plan_from_u(lane, ids, u)
        if rem is not None:
            np.multiply(pb.compute_s, rem, out=pb.compute_s)
        cols, ok = self._resolve_from_u(pb, lane, round_idx, start_t,
                                        u[:, 9:11], copy_start=False)
        return pb, cols, ok

    def resolve_batch(self, pb: PlanBatch, lane: np.ndarray, round_idx: int,
                      start_t: Union[float, np.ndarray],
                      deadline: Optional[np.ndarray] = None,
                      late_code: Optional[np.ndarray] = None
                      ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Resolve a lane-planned cohort; returns ``(cols, ok)`` where
        ``cols`` holds every SessionBatch column (device/country indices
        lane-local, ``staleness`` zeroed) keyed for a ``LaneAccumulator``
        append. ``deadline`` may be a per-row array (each lane closes its
        own round); ``late_code`` relabels each row's deadline cut
        (scalar or per-row — over-selecting lanes pass "cancelled")."""
        lane = np.asarray(lane, np.intp)
        uu = _uniforms_batch_rows(self.seeds[lane], pb.client_ids,
                                  round_idx + 1_000_000, 2)
        return self._resolve_from_u(pb, lane, round_idx, start_t, uu,
                                    deadline=deadline, late_code=late_code)

    def _resolve_from_u(self, pb: PlanBatch, lane: np.ndarray,
                        round_idx: int, start_t: Union[float, np.ndarray],
                        uu: np.ndarray,
                        deadline: Optional[np.ndarray] = None,
                        copy_start: bool = True,
                        late_code: Optional[np.ndarray] = None
                        ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Outcome math over a resolve-uniforms block (2 columns).
        ``copy_start=False`` lets a caller that hands over a fresh start
        array skip the defensive copy."""
        n = len(pb)
        full_d, full_c, full_u = pb.download_s, pb.compute_s, pb.upload_s
        start_arr = np.asarray(start_t, np.float64)
        start = np.broadcast_to(start_arr, (n,))
        full = full_d + full_c + full_u
        end_full = start + full_d + full_c + full_u

        timeout_s = self.timeout_s[lane]
        dropped = uu[:, 0] < self.dropout_rate[lane]
        timeout = ~dropped & (full_c > timeout_s)
        if self.any_avail:
            ua = _uniforms_batch_rows(self.seeds[lane], pb.client_ids,
                                      round_idx + 3_000_000, 1)[:, 0]
            not_adm = np.zeros(n, bool)
            exit_t = np.full(n, np.inf)
            for li in np.unique(lane[self._avail_lanes[lane]]):
                m = lane == li
                na_, et_ = self.samplers[li]._avail_masks(
                    pb.country_idx[m], start[m], ua[m])
                not_adm[m] = na_
                exit_t[m] = et_
            churned = ~not_adm & ~dropped & ~timeout & (exit_t < end_full)
            inter = not_adm | churned
            iburn = np.where(not_adm, 0.0,
                             np.minimum(np.maximum(exit_t - start, 0.0),
                                        full))
            dropped &= ~not_adm
            timeout &= ~not_adm
        else:
            inter = None
        if self.any_faults:
            uf = _uniforms_batch_rows(self.seeds[lane], pb.client_ids,
                                      round_idx + 2_000_000, 3)
            pre = dropped | timeout
            if inter is not None:
                pre = pre | inter
            failed = np.zeros(n, bool)
            fburn = np.zeros(n, np.float64)
            for li in np.unique(lane[self._fault_lanes[lane]]):
                m = lane == li
                f_, b_ = self.samplers[li]._fault_masks(
                    pb.country_idx[m], start[m], end_full[m], full[m],
                    uf[m], pre[m])
                failed[m] = f_
                fburn[m] = b_
        else:
            failed = None
        if deadline is not None:
            late = ~dropped & ~timeout & (end_full > deadline)
            if failed is not None:
                late &= ~failed
            if inter is not None:
                late &= ~inter
        else:
            late = np.zeros(n, bool)
        burn = uu[:, 1] * full
        if deadline is not None:
            burn = np.where(late, np.maximum(0.0, deadline - start), burn)
        cut = dropped | late
        if failed is not None:
            burn = np.where(failed, fburn, burn)
            cut = cut | failed
        if inter is not None:
            burn = np.where(inter, iburn, burn)
            cut = cut | inter
        d = np.where(cut, np.minimum(full_d, burn), full_d)
        c = np.where(cut, np.minimum(full_c,
                                     np.maximum(0.0, burn - full_d)),
                     full_c)
        u = np.where(cut, np.minimum(full_u,
                                     np.maximum(0.0, burn - full_d - full_c)),
                     full_u)
        c = np.where(timeout, timeout_s, c)
        u = np.where(timeout, 0.0, u)
        end = np.where(dropped, start + burn, end_full)
        end = np.where(timeout, start + full_d + timeout_s, end)
        if failed is not None:
            end = np.where(failed, start + fburn, end)
        if inter is not None:
            end = np.where(inter, start + iburn, end)
        if deadline is not None:
            # retries may start after the round closed: never end < start
            end = np.where(late, np.maximum(start, deadline), end)

        outcome = np.zeros(n, np.int8)  # completed
        outcome[cut] = OUTCOME_CODE["dropped"]
        outcome[timeout] = OUTCOME_CODE["timeout"]
        if failed is not None:
            outcome[failed] = OUTCOME_CODE["failed"]
        if inter is not None:
            outcome[inter] = OUTCOME_CODE["interrupted"]
        if late_code is not None:
            lc = np.broadcast_to(np.asarray(late_code, np.int8), (n,))
            relabel = late & (lc != OUTCOME_CODE["dropped"])
            outcome[relabel] = lc[relabel]
        ok = outcome == OUTCOME_CODE["completed"]
        frac_down = np.divide(d, full_d, out=np.zeros(n), where=full_d > 0)
        cols = dict(
            client_id=pb.client_ids,
            round_idx=np.full(n, round_idx, np.int64),
            device_idx=pb.device_idx, country_idx=pb.country_idx,
            download_s=d, compute_s=c, upload_s=u,
            bytes_down=pb.bytes_down * np.minimum(1.0, frac_down),
            bytes_up=np.where(ok, pb.bytes_up, 0.0),
            start_t=start_arr if (not copy_start
                                 and start_arr.shape == (n,)
                                 and start_arr.flags.writeable)
            else np.asarray(start, np.float64).copy(),
            end_t=end, outcome=outcome,
            staleness=np.zeros(n, np.int32))
        return cols, ok

    def apply_deadline(self, pb: PlanBatch, cols: Dict[str, np.ndarray],
                       ok: np.ndarray, deadline: np.ndarray,
                       late_code: Optional[np.ndarray] = None) -> None:
        """Patch a no-deadline resolve into its with-deadline twin, in
        place: only rows that completed past the deadline change (they
        burn budget until the round closes and drop, or relabel to their
        lane's ``late_code`` — the over-selection surplus outcome), every
        other row is untouched — so the sync lane round needs ONE resolve
        pass instead of two. Bit-identical to ``resolve_batch(...,
        deadline=...)``: dropped/timeout/failed/interrupted rows never
        depend on the deadline, and a completed row's ``end_t`` equals its
        full-duration end."""
        idx = np.flatnonzero(ok & (cols["end_t"] > deadline))
        if not len(idx):
            return
        dl = deadline[idx]
        burn = np.maximum(0.0, dl - cols["start_t"][idx])
        fd, fc, fu = pb.download_s[idx], pb.compute_s[idx], pb.upload_s[idx]
        d = np.minimum(fd, burn)
        c = np.minimum(fc, np.maximum(0.0, burn - fd))
        u = np.minimum(fu, np.maximum(0.0, burn - fd - fc))
        frac = np.divide(d, fd, out=np.zeros(len(idx)), where=fd > 0)
        cols["download_s"][idx] = d
        cols["compute_s"][idx] = c
        cols["upload_s"][idx] = u
        cols["bytes_down"][idx] = pb.bytes_down[idx] * np.minimum(1.0, frac)
        cols["bytes_up"][idx] = 0.0
        cols["end_t"][idx] = np.maximum(dl, cols["start_t"][idx])
        if late_code is None:
            cols["outcome"][idx] = OUTCOME_CODE["dropped"]
        else:
            lc = np.broadcast_to(np.asarray(late_code, np.int8),
                                 ok.shape)
            cols["outcome"][idx] = lc[idx]
        ok[idx] = False

    # --------------------------------------------------- replacement streams
    def slot_stream_ids(self, lane: np.ndarray, slots: np.ndarray,
                        generations: np.ndarray, population: int
                        ) -> np.ndarray:
        """Per-row-seed twin of the module-level ``slot_stream_ids``."""
        lane = np.asarray(lane, np.intp)
        s = np.asarray(slots, dtype=np.uint64)
        g = np.asarray(generations, dtype=np.uint64)
        with np.errstate(over="ignore"):
            base0 = (self.seeds[lane] & _U64(0xFFFFFFFF)) \
                * _U64(0x9E3779B9) + _U64(0x7F4A7C15)
            h = _splitmix64_arr(base0 + s * _U64(_SLOT_MIX)
                                + g * _U64(_GOLDEN))
        u_ = (h >> _U64(11)).astype(np.float64) * _INV53
        return (u_ * population).astype(np.int64)

    def retry_stream_ids(self, lane: np.ndarray, units: np.ndarray,
                         attempts: np.ndarray, population: int
                         ) -> np.ndarray:
        """Per-row-seed twin of the module-level ``retry_stream_ids``."""
        lane = np.asarray(lane, np.intp)
        s = np.asarray(units, dtype=np.uint64)
        g = np.asarray(attempts, dtype=np.uint64)
        with np.errstate(over="ignore"):
            base0 = (self.seeds[lane] & _U64(0xFFFFFFFF)) \
                * _U64(0x9E3779B9) + _U64(0x7F4A7C15)
            h = _splitmix64_arr(base0 + s * _U64(_RETRY_MIX)
                                + g * _U64(_GOLDEN))
        u_ = (h >> _U64(11)).astype(np.float64) * _INV53
        return (u_ * population).astype(np.int64)

    def probe_uniforms(self, lane: np.ndarray, slots: np.ndarray,
                       generations: np.ndarray, n: int) -> np.ndarray:
        """Per-row-seed twin of the module-level ``probe_uniforms``."""
        lane = np.asarray(lane, np.intp)
        s = np.asarray(slots, dtype=np.uint64)
        g = np.asarray(generations, dtype=np.uint64)
        probe = np.arange(1, n + 1, dtype=np.uint64) * _U64(_PROBE_MIX)
        with np.errstate(over="ignore"):
            base0 = (self.seeds[lane] & _U64(0xFFFFFFFF)) \
                * _U64(0x9E3779B9) + _U64(0x7F4A7C15)
            base = base0 + s * _U64(_SLOT_MIX) + g * _U64(_GOLDEN)
            h = _splitmix64_arr(base[:, None] + probe[None, :])
        return (h >> _U64(11)).astype(np.float64) * _INV53

    def country_draw(self, lane: np.ndarray,
                     client_ids: Union[np.ndarray, Sequence[int]],
                     round_idx: int) -> np.ndarray:
        """Per-row-seed twin of ``SessionSampler.country_draw`` over the
        pack's padded country-cumulative table (count-of-strictly-less ==
        left searchsorted, pad 2.0 never counts)."""
        lane = np.asarray(lane, np.intp)
        cid = np.asarray(client_ids, np.int64).astype(np.uint64)
        with np.errstate(over="ignore"):
            base_r = ((self.seeds[lane] * _U64(1_000_003)
                       + _U64(round_idx))
                      & _U64(0xFFFFFFFF)) * _U64(2_654_435_761) \
                + cid * _U64(97)
            vals = _splitmix64_arr(base_r + _U64(_GOLDEN))
        u1 = (vals >> _U64(11)).astype(np.float64) * _INV53
        return (self._ccum2[lane] < u1[:, None]).sum(axis=1) \
            .astype(np.int32)

    def admission_uniforms(self, lane: np.ndarray,
                           client_ids: Union[np.ndarray, Sequence[int]],
                           round_idx: int) -> np.ndarray:
        """Per-row-seed twin of ``SessionSampler.admission_uniforms``."""
        lane = np.asarray(lane, np.intp)
        cid = np.asarray(client_ids, np.int64)
        return _uniforms_batch_rows(self.seeds[lane], cid,
                                    round_idx + 3_000_000, 1)[:, 0]
