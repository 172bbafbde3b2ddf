"""Streaming telemetry — constant-memory population-scale tasks.

The paper measures FL on *millions of phones*; materializing every
simulated session as telemetry columns makes a 10^8-session task
memory-bound long before it is compute-bound. This module keeps the
engine's telemetry surface while storing O(groups + sample) instead of
O(sessions):

**Exact running reductions.** ``StreamingAccumulator`` folds each
resolved window's columns through ``estimator._kg_rows`` — the single
implementation of the per-phase ``intensity(country, t)`` span-mean
logic — into error-free ``ExactSum`` accumulators for the three
``CarbonBreakdown`` components, total bytes, and integer counters
(participation per outcome, completed-session staleness sum). Exact
summation is associative and commutative, so the folded totals equal the
materialized ``batch_carbon`` reduction **bit-for-bit** on every
schedule, regardless of window chunking or lane packing.

**Grouped breakdown table.** Per ``(country, intensity-schedule-segment,
outcome)`` group the fold also accumulates CO2e / energy / bytes /
duration / count via ``np.bincount`` into small running float64 arrays
(the per-region running-total shape of Savazzi et al.'s analysis).
Memory model: the component totals and counters are *exact*; the grouped
table is plain float64 accumulation (per-append bincount partials), i.e.
accurate to normal float rounding, not bit-pinned.

**Reservoir sample.** A deterministic bottom-k reservoir keeps
``sample`` full session rows for the fig scripts: session ``i`` (global
engine-order index) is retained iff ``events.reservoir_keys(seed, i)``
is among the k smallest keys seen. The retained *set* is a pure function
of ``(seed, index)`` — identical across chunk sizes, serial vs
lane-batched execution, and worker counts — and ``columns()`` returns it
in engine order as a well-formed ``SessionBatch``.

``StreamedLog`` packages the accumulator behind the ``TaskLog`` surface
(``n_sessions``, ``participation``, ``mean_staleness``, ``columns``,
rounds/evals), so strategies, ``Result`` and the estimator consume it
unchanged; ``CarbonEstimator.estimate`` spots ``carbon_components`` and
reads the exact sums instead of reducing the sampled columns.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.carbon import SECONDS_PER_DAY
from repro_torch.core.telemetry import (OUTCOME_CODE, OUTCOMES, SessionBatch,
                                  TaskLog, _ACC_DTYPES)

_MEASURES = ("co2e_kg", "energy_j", "bytes", "duration_s", "count")


class StreamingAccumulator:
    """Constant-memory fold of session columns (see module doc).

    ``append(**cols)`` is ``BatchAccumulator``-compatible: one block of
    engine-order rows per call, column indices relative to the fixed
    ``device_names``/``country_names`` vocabularies fixed at construction
    (both engines emit the sampler's full vocab). The estimator is bound
    at construction because the fold charges carbon as rows arrive."""

    def __init__(self, estimator, device_names: Tuple[str, ...],
                 country_names: Tuple[str, ...], *, seed: int,
                 sample: int, checkpoint_period_s: float = 0.0):
        from repro_torch.core.estimator import ExactSum
        self.estimator = estimator
        self.device_names = tuple(device_names)
        self.country_names = tuple(country_names)
        self.seed = int(seed)
        self.sample = int(sample)
        self.checkpoint_period_s = float(checkpoint_period_s)
        assert self.sample > 0
        self._n = 0
        # exact component sums (bit-for-bit vs materialized batch_carbon)
        self._kg = [ExactSum(), ExactSum(), ExactSum()]
        # exact contributed/wasted split over the same rows: completed vs
        # everything else (dropped/timeout/cancelled/failed/retried/
        # interrupted). With a live checkpoint period the waste further
        # splits into salvaged (interrupted compute up to the last
        # checkpoint, reused by a resume) vs lost — exact sums are
        # associative, so the fold matches batch_carbon's split
        # bit-for-bit regardless of block boundaries.
        self._kg_ok = ExactSum()
        self._kg_salv = ExactSum()
        self._kg_lost = ExactSum()
        self._bytes_up = ExactSum()
        self._bytes_down = ExactSum()
        # exact integer counters
        self._outcome_counts = np.zeros(len(OUTCOMES), np.int64)
        self._stale_sum = 0              # over completed sessions
        # grouped running table: (country, schedule-segment, outcome)
        tab = estimator.intensity.vocab_schedule(self.country_names)
        self._tab = tab
        self._nseg = int(tab.nseg.max()) if len(self.country_names) else 1
        ngroups = max(len(self.country_names), 1) * self._nseg * len(OUTCOMES)
        self._groups = {m: np.zeros(ngroups, np.float64) for m in _MEASURES}
        # bottom-k reservoir (engine-order rows; global-index keyed)
        self._res_idx = np.zeros(0, np.int64)
        self._res_keys = np.zeros(0, np.uint64)
        self._res_cols: Dict[str, np.ndarray] = {
            f: np.zeros(0, dt) for f, dt in _ACC_DTYPES.items()}
        # device/country remap caches for foreign-vocab batches
        self._dev_pos = {n: i for i, n in enumerate(self.device_names)}
        self._ctry_pos = {n: i for i, n in enumerate(self.country_names)}
        self._remap_cache: Dict[Tuple[Tuple[str, ...], Tuple[str, ...]],
                                Tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return self._n

    # -------------------------------------------------------------- folding
    def append(self, **cols: np.ndarray) -> None:
        n = len(cols["client_id"])
        if not n:
            return
        block = {}
        for f, dt in _ACC_DTYPES.items():
            a = np.asarray(cols[f], dt)
            block[f] = np.broadcast_to(a, (n,)) if a.ndim == 0 else a
        from repro_torch.core.estimator import _kg_rows
        kg, e = _kg_rows(self.estimator, self.device_names,
                         block["device_idx"], self.country_names,
                         block["country_idx"], block["compute_s"],
                         block["upload_s"], block["download_s"],
                         block["bytes_up"], block["bytes_down"],
                         block["start_t"], with_energy=True)
        for i in range(3):
            self._kg[i].add(kg[i])
        self._bytes_up.add(block["bytes_up"])
        self._bytes_down.add(block["bytes_down"])
        out = block["outcome"]
        self._outcome_counts += np.bincount(out, minlength=len(OUTCOMES))
        ok = out == 0  # OUTCOME_CODE["completed"]
        self._kg_ok.add(kg[:, ok])
        P = self.checkpoint_period_s
        im = (out == OUTCOME_CODE["interrupted"]) if P > 0 else None
        if im is None or not im.any():
            self._kg_lost.add(kg[:, ~ok])
        else:
            from repro_torch.core.estimator import _salvage_kg
            iw = np.flatnonzero(im)
            salv_kg, tail_kg = _salvage_kg(
                self.estimator, self.device_names, block["device_idx"][iw],
                self.country_names, block["country_idx"][iw],
                block["compute_s"][iw], block["download_s"][iw],
                block["start_t"][iw], P)
            self._kg_salv.add(salv_kg)
            self._kg_lost.add(tail_kg).add(kg[1, iw]).add(kg[2, iw]) \
                .add(kg[:, ~ok & ~im])
        self._stale_sum += int(block["staleness"][ok].sum(dtype=np.int64))
        self._fold_groups(block, kg, e, out)
        self._fold_reservoir(block, n)
        self._n += n

    def append_batch(self, b: SessionBatch) -> None:
        """Fold a ``SessionBatch``, remapping its per-batch vocabularies
        onto the accumulator's fixed ones (identity for engine batches,
        which carry the sampler's full vocab). Unknown names fail loudly —
        the fixed vocab is what keys the grouped table."""
        if not len(b):
            return
        key = (b.device_names, b.country_names)
        maps = self._remap_cache.get(key)
        if maps is None:
            try:
                dmap = np.asarray([self._dev_pos[x] for x in b.device_names],
                                  np.int32)
                cmap = np.asarray([self._ctry_pos[x] for x in b.country_names],
                                  np.int32)
            except KeyError as exc:
                raise ValueError(
                    f"session batch names {exc} not in the streaming "
                    f"accumulator's fixed vocabulary") from None
            maps = self._remap_cache[key] = (dmap, cmap)
        dmap, cmap = maps
        self.append(
            client_id=b.client_id, round_idx=b.round_idx,
            device_idx=dmap[b.device_idx] if len(dmap) else b.device_idx,
            country_idx=cmap[b.country_idx] if len(cmap) else b.country_idx,
            download_s=b.download_s, compute_s=b.compute_s,
            upload_s=b.upload_s, bytes_down=b.bytes_down,
            bytes_up=b.bytes_up, start_t=b.start_t, end_t=b.end_t,
            outcome=b.outcome, staleness=b.staleness)

    def _fold_groups(self, block, kg, e, out) -> None:
        ctry = block["country_idx"].astype(np.int64)
        tab = self._tab
        r = np.mod(block["start_t"] + tab.phase_s[ctry], SECONDS_PER_DAY)
        seg = tab._segment(ctry, r)
        g = (ctry * self._nseg + seg) * len(OUTCOMES) + out
        nb = self._groups["count"].shape[0]
        self._groups["co2e_kg"] += np.bincount(
            g, weights=kg[0] + kg[1] + kg[2], minlength=nb)
        self._groups["energy_j"] += np.bincount(
            g, weights=e[0] + e[1] + e[2], minlength=nb)
        self._groups["bytes"] += np.bincount(
            g, weights=block["bytes_up"] + block["bytes_down"], minlength=nb)
        self._groups["duration_s"] += np.bincount(
            g, weights=block["end_t"] - block["start_t"], minlength=nb)
        self._groups["count"] += np.bincount(g, minlength=nb)

    def _fold_reservoir(self, block, n: int) -> None:
        from repro_torch.federated.events import reservoir_keys
        gidx = np.arange(self._n, self._n + n, dtype=np.int64)
        keys = reservoir_keys(self.seed, gidx)
        if n > self.sample:
            # pre-trim big blocks so the merge sorts O(sample) rows
            part = np.argpartition(keys, self.sample - 1)[:self.sample]
            keys, gidx = keys[part], gidx[part]
            block = {f: a[part] for f, a in block.items()}
        idx = np.concatenate([self._res_idx, gidx])
        allk = np.concatenate([self._res_keys, keys])
        if idx.shape[0] > self.sample:
            order = np.lexsort((idx, allk))[:self.sample]
        else:
            order = np.arange(idx.shape[0])
        self._res_idx = idx[order]
        self._res_keys = allk[order]
        for f in _ACC_DTYPES:
            merged = np.concatenate([self._res_cols[f], block[f]])
            self._res_cols[f] = merged[order]

    # ---------------------------------------------------------------- views
    def carbon_components(self) -> Dict[str, float]:
        salv = self._kg_salv.value()
        lost = self._kg_lost.value()
        # waste == salvaged + lost exactly (one float add, matching
        # batch_carbon); with no live checkpoint period salv is 0.0 and
        # 0.0 + lost == lost bitwise, so the key stays back-compatible
        return {"client_compute_kg": self._kg[0].value(),
                "upload_kg": self._kg[1].value(),
                "download_kg": self._kg[2].value(),
                "ok_kg": self._kg_ok.value(),
                "waste_kg": salv + lost,
                "salvaged_kg": salv,
                "lost_kg": lost}

    def total_bytes(self) -> Dict[str, float]:
        return {"up": self._bytes_up.value(),
                "down": self._bytes_down.value()}

    def participation(self) -> Dict[str, int]:
        return {OUTCOMES[i]: int(c)
                for i, c in enumerate(self._outcome_counts) if c}

    def completed(self) -> int:
        return int(self._outcome_counts[0])

    def mean_staleness(self) -> float:
        c = self.completed()
        return self._stale_sum / c if c else 0.0

    def breakdown_table(self) -> List[Dict]:
        """Non-empty groups as rows: country, schedule segment, outcome,
        plus the five accumulated measures. Float64 running sums (see
        module doc for the exact-vs-rounded memory model)."""
        rows = []
        nz = np.flatnonzero(self._groups["count"])
        for g in nz:
            out = int(g % len(OUTCOMES))
            seg = int((g // len(OUTCOMES)) % self._nseg)
            ctry = int(g // (len(OUTCOMES) * self._nseg))
            rows.append({
                "country": self.country_names[ctry],
                "segment": seg,
                "outcome": OUTCOMES[out],
                **{m: float(self._groups[m][g]) for m in _MEASURES}})
        return rows

    def sample_columns(self) -> SessionBatch:
        """Retained reservoir rows, in engine (global-index) order."""
        order = np.argsort(self._res_idx, kind="stable")
        return SessionBatch(
            device_names=self.device_names,
            country_names=self.country_names,
            **{f: self._res_cols[f][order] for f in _ACC_DTYPES})

    def sample_indices(self) -> np.ndarray:
        """Global engine-order indices of the retained rows, sorted."""
        return np.sort(self._res_idx)

    # ------------------------------------------------------------ snapshots
    _SUM_NAMES = ("kg0", "kg1", "kg2", "kg_ok", "kg_salv", "kg_lost",
                  "bytes_up", "bytes_down")

    def _sums(self):
        return dict(zip(self._SUM_NAMES,
                        (*self._kg, self._kg_ok, self._kg_salv,
                         self._kg_lost, self._bytes_up, self._bytes_down)))

    def state(self) -> Tuple[dict, Dict[str, np.ndarray]]:
        """Full fold state as ``(json_meta, arrays)``. ``load_state`` on a
        same-config accumulator restores it exactly: the ExactSum states
        round-trip bit-for-bit, counters are integers, and the grouped
        table / reservoir come back as the identical float64/uint64
        arrays — so a resumed fold continues as if never interrupted."""
        meta = {"n": self._n, "stale_sum": self._stale_sum,
                "sums": {k: s.state() for k, s in self._sums().items()}}
        arrays = {"outcome_counts": self._outcome_counts,
                  "res_idx": self._res_idx, "res_keys": self._res_keys,
                  **{f"groups_{m}": self._groups[m] for m in _MEASURES},
                  **{f"res_{f}": self._res_cols[f] for f in _ACC_DTYPES}}
        return meta, arrays

    def load_state(self, meta: dict, arrays: Dict[str, np.ndarray]) -> None:
        from repro_torch.core.estimator import ExactSum
        self._n = int(meta["n"])
        self._stale_sum = int(meta["stale_sum"])
        sums = {k: ExactSum.from_state(s) for k, s in meta["sums"].items()}
        self._kg = [sums["kg0"], sums["kg1"], sums["kg2"]]
        self._kg_ok = sums["kg_ok"]
        self._kg_salv = sums["kg_salv"]
        self._kg_lost = sums["kg_lost"]
        self._bytes_up = sums["bytes_up"]
        self._bytes_down = sums["bytes_down"]
        self._outcome_counts = np.asarray(arrays["outcome_counts"],
                                          np.int64).copy()
        for m in _MEASURES:
            self._groups[m] = np.asarray(arrays[f"groups_{m}"],
                                         np.float64).copy()
        self._res_idx = np.asarray(arrays["res_idx"], np.int64).copy()
        self._res_keys = np.asarray(arrays["res_keys"], np.uint64).copy()
        self._res_cols = {f: np.asarray(arrays[f"res_{f}"], dt).copy()
                          for f, dt in _ACC_DTYPES.items()}

class StreamedLog(TaskLog):
    """``TaskLog`` whose session store is a ``StreamingAccumulator``:
    appends fold instead of materialize, summaries read the exact running
    reductions, and ``columns()``/``sessions`` expose the deterministic
    reservoir *sample* (``sampled`` says whether rows were dropped).
    Satisfies everything ``Result.summary()``/``to_dict()`` and
    ``CarbonEstimator.estimate`` consume."""

    def __init__(self, estimator, device_names: Tuple[str, ...],
                 country_names: Tuple[str, ...], *, seed: int,
                 sample: int = 4096, mode: str = "",
                 checkpoint_period_s: float = 0.0):
        super().__init__()
        self.mode = mode
        self.checkpoint_period_s = float(checkpoint_period_s)
        self._acc = StreamingAccumulator(
            estimator, device_names, country_names, seed=seed,
            sample=sample, checkpoint_period_s=checkpoint_period_s)

    def __len__(self) -> int:
        return self._acc._n

    # ------------------------------------------------------------ appenders
    def log_batch(self, batch: SessionBatch) -> None:
        self._acc.append_batch(batch)
        self._n = self._acc._n
        self._columns = self._sessions = None

    def log_session(self, s) -> None:
        self._acc.append_batch(SessionBatch.from_sessions([s]))
        self._n = self._acc._n
        self._columns = self._sessions = None

    def append(self, **cols: np.ndarray) -> None:
        """``BatchAccumulator``-compatible sink surface — the async engine
        folds window pops straight into the log, no staging store."""
        self._acc.append(**cols)
        self._n = self._acc._n
        self._columns = self._sessions = None

    # ------------------------------------------------------------ snapshots
    def stream_state(self) -> Tuple[dict, "Dict[str, np.ndarray]"]:
        """Accumulator fold state (see ``StreamingAccumulator.state``)."""
        return self._acc.state()

    def load_stream_state(self, meta: dict, arrays) -> None:
        self._acc.load_state(meta, arrays)
        self._n = self._acc._n
        self._columns = self._sessions = None

    # ---------------------------------------------------------------- views
    @property
    def sampled(self) -> bool:
        """True when ``columns()`` is a strict sample of the population."""
        return self._acc._n > self._acc._res_idx.shape[0]

    def columns(self) -> SessionBatch:
        if self._columns is None:
            self._columns = self._acc.sample_columns()
        return self._columns

    # ------------------------------------------------------------ summaries
    def carbon_components(self, estimator) -> Dict[str, float]:
        est = self._acc.estimator
        if estimator is not est:
            try:
                same = bool(estimator == est)
            except Exception:
                same = False
            if not same:
                raise ValueError(
                    "StreamedLog was folded under a different estimator; "
                    "its exact sums cannot be re-estimated — re-run with "
                    "telemetry='full' to change the environment post hoc")
        return self._acc.carbon_components()

    def breakdown_table(self) -> List[Dict]:
        return self._acc.breakdown_table()

    def completed_sessions(self) -> int:
        return self._acc.completed()

    def participation(self) -> Dict[str, int]:
        return self._acc.participation()

    def total_bytes(self) -> Dict[str, float]:
        return self._acc.total_bytes()

    def mean_staleness(self) -> float:
        return self._acc.mean_staleness()
