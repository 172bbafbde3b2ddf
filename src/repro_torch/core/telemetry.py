"""The client-runtime "logger" (paper §4.1) as a columnar data model.

Each FL session produces the vitals the paper's production logger captures:
device model, connecting country, download/compute/upload durations, bytes
moved, and the outcome (completed, dropped mid-round, timed out at 4
minutes, or cancelled because the task itself ended while the session was
in flight). Dropped/timed-out/cancelled clients still burned energy — the
estimator charges them (paper: "our methodology also accounts for the
clients that drop out or time out").

Storage is struct-of-arrays: strategies append one ``SessionBatch`` (a
bundle of NumPy columns plus small device/country vocabularies) per round
or per flush, and the estimator reduces whole columns at once. The
row-oriented ``ClientSession`` dataclass survives as a compatibility view —
``TaskLog.sessions`` lazily materialises it on demand — so telemetry
consumers that want objects still get them, while the hot path never
allocates per-session Python objects.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Append-only: codes are positional and live in persisted telemetry.
# "failed" = killed by the fault model (hazard or burst); "retried" = a
# failed attempt whose slot was re-dispatched (the retry is its own row);
# "interrupted" = the device exited availability-model eligibility (refused
# at admission, or churned mid-flight) — kept distinct from "failed" even
# when re-dispatched, because the checkpoint/resume salvage accounting
# needs to find these rows at estimate time.
OUTCOMES: Tuple[str, ...] = ("completed", "dropped", "timeout", "cancelled",
                             "failed", "retried", "interrupted")
OUTCOME_CODE: Dict[str, int] = {name: i for i, name in enumerate(OUTCOMES)}


@dataclass(frozen=True)
class ClientSession:
    """Row-oriented compatibility view of one session (see module doc)."""

    client_id: int
    round_idx: int               # sync round (async: server version at start)
    device: str                  # DeviceProfile.name
    country: str
    download_s: float
    compute_s: float
    upload_s: float
    bytes_down: float
    bytes_up: float
    start_t: float               # task clock, seconds
    end_t: float
    outcome: str                 # one of OUTCOMES
    staleness: int = 0           # async: server updates since model was sent

    @property
    def completed(self) -> bool:
        return self.outcome == "completed"


_FLOAT_COLS = ("download_s", "compute_s", "upload_s", "bytes_down",
               "bytes_up", "start_t", "end_t")


@dataclass(frozen=True)
class SessionBatch:
    """A cohort of sessions as columns. ``device_names``/``country_names``
    are per-batch vocabularies indexed by ``device_idx``/``country_idx``
    (strings stay out of the big arrays)."""

    device_names: Tuple[str, ...]
    country_names: Tuple[str, ...]
    client_id: np.ndarray        # int64
    round_idx: np.ndarray        # int64
    device_idx: np.ndarray       # int32 -> device_names
    country_idx: np.ndarray      # int32 -> country_names
    download_s: np.ndarray       # float64, seconds
    compute_s: np.ndarray
    upload_s: np.ndarray
    bytes_down: np.ndarray       # float64, bytes charged (prorated on drop)
    bytes_up: np.ndarray
    start_t: np.ndarray          # task clock, seconds
    end_t: np.ndarray
    outcome: np.ndarray          # int8 -> OUTCOMES
    staleness: np.ndarray        # int32

    def __len__(self) -> int:
        return int(self.client_id.shape[0])

    @property
    def completed_mask(self) -> np.ndarray:
        return self.outcome == OUTCOME_CODE["completed"]

    # ------------------------------------------------------------- builders
    @classmethod
    def empty(cls) -> "SessionBatch":
        z = np.zeros(0, np.float64)
        return cls((), (), np.zeros(0, np.int64), np.zeros(0, np.int64),
                   np.zeros(0, np.int32), np.zeros(0, np.int32),
                   z, z.copy(), z.copy(), z.copy(), z.copy(), z.copy(),
                   z.copy(), np.zeros(0, np.int8), np.zeros(0, np.int32))

    @classmethod
    def from_sessions(cls, sessions: Sequence[ClientSession]) -> "SessionBatch":
        if not sessions:
            return cls.empty()
        dev_vocab: Dict[str, int] = {}
        ctry_vocab: Dict[str, int] = {}
        dev_idx = np.fromiter(
            (dev_vocab.setdefault(s.device, len(dev_vocab)) for s in sessions),
            np.int32, len(sessions))
        ctry_idx = np.fromiter(
            (ctry_vocab.setdefault(s.country, len(ctry_vocab))
             for s in sessions), np.int32, len(sessions))
        cols = {c: np.asarray([getattr(s, c) for s in sessions], np.float64)
                for c in _FLOAT_COLS}
        return cls(
            tuple(dev_vocab), tuple(ctry_vocab),
            np.asarray([s.client_id for s in sessions], np.int64),
            np.asarray([s.round_idx for s in sessions], np.int64),
            dev_idx, ctry_idx,
            outcome=np.asarray([OUTCOME_CODE[s.outcome] for s in sessions],
                               np.int8),
            staleness=np.asarray([s.staleness for s in sessions], np.int32),
            **cols)

    @classmethod
    def concat(cls, batches: Sequence["SessionBatch"]) -> "SessionBatch":
        batches = [b for b in batches if len(b)]
        if not batches:
            return cls.empty()
        if len(batches) == 1:
            return batches[0]
        dev_vocab: Dict[str, int] = {}
        ctry_vocab: Dict[str, int] = {}
        dev_parts, ctry_parts = [], []
        for b in batches:
            dmap = np.asarray([dev_vocab.setdefault(n, len(dev_vocab))
                               for n in b.device_names], np.int32)
            cmap = np.asarray([ctry_vocab.setdefault(n, len(ctry_vocab))
                               for n in b.country_names], np.int32)
            dev_parts.append(dmap[b.device_idx] if len(dmap)
                             else b.device_idx)
            ctry_parts.append(cmap[b.country_idx] if len(cmap)
                              else b.country_idx)
        cat = np.concatenate
        return cls(
            tuple(dev_vocab), tuple(ctry_vocab),
            cat([b.client_id for b in batches]),
            cat([b.round_idx for b in batches]),
            cat(dev_parts), cat(ctry_parts),
            outcome=cat([b.outcome for b in batches]),
            staleness=cat([b.staleness for b in batches]),
            **{c: cat([getattr(b, c) for b in batches])
               for c in _FLOAT_COLS})

    # ----------------------------------------------------------------- view
    def to_sessions(self) -> List[ClientSession]:
        dn, cn = self.device_names, self.country_names
        return [ClientSession(
            client_id=int(self.client_id[i]),
            round_idx=int(self.round_idx[i]),
            device=dn[self.device_idx[i]],
            country=cn[self.country_idx[i]],
            download_s=float(self.download_s[i]),
            compute_s=float(self.compute_s[i]),
            upload_s=float(self.upload_s[i]),
            bytes_down=float(self.bytes_down[i]),
            bytes_up=float(self.bytes_up[i]),
            start_t=float(self.start_t[i]),
            end_t=float(self.end_t[i]),
            outcome=OUTCOMES[self.outcome[i]],
            staleness=int(self.staleness[i])) for i in range(len(self))]


_ACC_DTYPES = {"client_id": np.int64, "round_idx": np.int64,
               "device_idx": np.int32, "country_idx": np.int32,
               "download_s": np.float64, "compute_s": np.float64,
               "upload_s": np.float64, "bytes_down": np.float64,
               "bytes_up": np.float64, "start_t": np.float64,
               "end_t": np.float64, "outcome": np.int8,
               "staleness": np.int32}


class BatchAccumulator:
    """Arrival-ordered columnar batch assembly for strategies that log in
    windows: ``append`` is O(1) (it keeps block references), and
    consolidation lazily writes every block exactly once into
    amortized-doubling preallocated buffers sized exactly on first use —
    so repeated ``to_batch`` calls re-copy only the blocks appended since
    the last one, instead of re-concatenating every column from scratch
    each time (the old list+``np.concatenate`` scheme made window-per-
    window accumulation with periodic snapshots quadratic). Snapshots are
    copy-on-write: handing out buffer views freezes the store, and the
    next consolidation reallocates rather than mutating what a caller
    holds. Appended blocks are adopted — callers must not mutate them
    afterwards (both engines hand over freshly built arrays)."""

    # subclasses may ride extra columns in the same buffers (LaneAccumulator)
    _EXTRA_DTYPES: Dict[str, type] = {}

    def __init__(self, device_names: Tuple[str, ...],
                 country_names: Tuple[str, ...]):
        self.device_names = device_names
        self.country_names = country_names
        self._dtypes = {**_ACC_DTYPES, **self._EXTRA_DTYPES}
        self._cols: Dict[str, np.ndarray] = {}
        self._pending: List[Dict[str, np.ndarray]] = []
        self._cap = 0
        self._n = 0         # rows appended (incl. pending blocks)
        self._n_buf = 0     # rows already consolidated into the buffers
        self._frozen = False

    def __len__(self) -> int:
        return self._n

    def append(self, **cols: np.ndarray) -> None:
        """Append one block; ``cols`` must cover every SessionBatch column
        except the vocabularies (fixed at construction). Values may be
        scalars (broadcast) as long as ``client_id`` is an array."""
        assert cols.keys() == self._dtypes.keys(), sorted(cols)
        self._pending.append(cols)
        self._n += len(cols["client_id"])

    def _consolidate(self) -> None:
        """Write pending blocks into the buffers (dtype-casting like
        ``np.asarray``); grows by doubling, but the first allocation is
        exact-size so the accumulate-once/consolidate-once pattern copies
        each value exactly once."""
        if not self._pending:
            return              # nothing new; existing views stay valid
        if self._n > self._cap or self._frozen:
            # grow only when out of space (exact on first allocation, then
            # doubling); a freeze-triggered copy-on-write keeps capacity
            if self._n <= self._cap:
                cap = self._cap
            else:
                cap = self._n if self._cap == 0 \
                    else max(self._n, 2 * self._cap)
            for f, dt in self._dtypes.items():
                buf = np.empty(cap, dt)
                if self._n_buf:
                    buf[:self._n_buf] = self._cols[f][:self._n_buf]
                self._cols[f] = buf
            self._cap = cap
            self._frozen = False
        pos = self._n_buf
        for block in self._pending:
            n = len(block["client_id"])
            for f, arr in block.items():
                self._cols[f][pos:pos + n] = arr
            pos += n
        self._pending = []
        self._n_buf = pos

    def to_batch(self) -> SessionBatch:
        """Consolidated views of every appended row (the store freezes; a
        later append copies on write, so the snapshot stays immutable)."""
        if not self._n:
            return SessionBatch.empty()
        self._consolidate()
        self._frozen = True
        return SessionBatch(
            device_names=self.device_names,
            country_names=self.country_names,
            **{f: self._cols[f][:self._n] for f in _ACC_DTYPES})

    def snapshot_rows(self, start: int
                      ) -> Tuple[Tuple[str, ...], Tuple[str, ...],
                                 Dict[str, np.ndarray]]:
        """Row slices ``[start:n)`` of every SessionBatch column, read
        off the consolidated buffers AND the still-pending blocks without
        consolidating or freezing — O(new rows), and the store's own
        exact-size consolidate-once pattern stays intact (a periodic
        snapshot neither triggers copy-on-write nor forces growth by
        doubling). Values are views or broadcast-casts valid until the
        next ``append``: consume them immediately (the snapshot writer
        serializes them on the spot)."""
        cols = {f: np.empty(max(self._n - start, 0), dt)
                for f, dt in _ACC_DTYPES.items()}
        out = 0
        if start < self._n_buf:
            for f in cols:
                cols[f][:self._n_buf - start] = \
                    self._cols[f][start:self._n_buf]
            out = self._n_buf - start
        pos = self._n_buf
        for block in self._pending:
            nb = len(block["client_id"])
            if pos + nb > start:
                lo = max(0, start - pos)
                for f in cols:
                    v = block[f]     # slice assignment broadcasts scalars
                    cols[f][out:out + nb - lo] = \
                        v[lo:] if isinstance(v, np.ndarray) else v
                out += nb - lo
            pos += nb
        return self.device_names, self.country_names, cols


class LaneAccumulator(BatchAccumulator):
    """``BatchAccumulator`` with a per-row ``lane`` column: one shared
    struct-of-arrays store for a whole lane pack (the lane-batched sweep
    engine). ``split`` slices each lane's ``SessionBatch`` back out — rows
    keep append order within a lane, which is exactly that lane's serial
    log order, and each lane gets its own device/country vocabularies
    (indices in the store are lane-local)."""

    _EXTRA_DTYPES = {"lane": np.int32}

    def __init__(self, device_names_per_lane: Sequence[Tuple[str, ...]],
                 country_names_per_lane: Sequence[Tuple[str, ...]]):
        super().__init__((), ())
        self._dev_names = list(device_names_per_lane)
        self._ctry_names = list(country_names_per_lane)

    @property
    def n_lanes(self) -> int:
        return len(self._dev_names)

    def raw(self) -> Dict[str, np.ndarray]:
        """Trimmed views of every column (lane included) — for segment
        reductions over the whole pack (``estimator.lane_carbon``) with
        no per-lane copying. Freezes like ``to_batch``."""
        if not self._n:
            return {f: np.zeros(0, dt) for f, dt in self._dtypes.items()}
        self._consolidate()
        self._frozen = True
        return {f: self._cols[f][:self._n] for f in self._dtypes}

    def split(self) -> List[SessionBatch]:
        if not self._n:
            return [SessionBatch.empty() for _ in self._dev_names]
        self._consolidate()
        lane = self._cols["lane"][:self._n]
        out = []
        for i in range(self.n_lanes):
            idx = np.flatnonzero(lane == i)
            out.append(SessionBatch(
                device_names=self._dev_names[i],
                country_names=self._ctry_names[i],
                **{f: self._cols[f][:self._n][idx] for f in _ACC_DTYPES}))
        return out


class TaskLog:
    """Accumulates everything the carbon estimator needs for one FL task.

    Sessions arrive as ``SessionBatch`` chunks (``log_batch``) on the fast
    path, or as individual ``ClientSession`` objects (``log_session``) from
    legacy callers; both land in the same columnar store. ``columns()``
    consolidates all chunks into one batch (cached until the next append);
    ``sessions`` is the lazy row-oriented compatibility view."""

    def __init__(self):
        self._batches: List[SessionBatch] = []
        self._pending: List[ClientSession] = []
        self._n: int = 0
        self._columns: Optional[SessionBatch] = None
        self._sessions: Optional[Tuple[ClientSession, ...]] = None
        self.rounds: int = 0                  # server model updates so far
        self.starved_rounds: int = 0          # sync rounds closed under quorum
        self.duration_s: float = 0.0          # task wall-clock so far
        self.server_busy_s: float = 0.0       # == duration (servers stay up)
        self.eval_history: List[Dict] = []

    # ------------------------------------------------------------ appenders
    def log_batch(self, batch: SessionBatch) -> None:
        if self._pending:
            self._batches.append(SessionBatch.from_sessions(self._pending))
            self._pending = []
        self._batches.append(batch)
        self._n += len(batch)
        self._columns = self._sessions = None

    def log_session(self, s: ClientSession) -> None:
        self._pending.append(s)
        self._n += 1
        self._columns = self._sessions = None

    def log_round(self, t: float, starved: bool = False) -> None:
        self.rounds += 1
        if starved:
            self.starved_rounds += 1
        self.duration_s = max(self.duration_s, t)

    def log_eval(self, t: float, round_idx: int, perplexity: float,
                 smoothed: float) -> None:
        self.eval_history.append(dict(t=t, round=round_idx,
                                      perplexity=perplexity, smoothed=smoothed))

    # ---------------------------------------------------------------- views
    @property
    def n_sessions(self) -> int:
        return self._n

    def columns(self) -> SessionBatch:
        """All sessions consolidated into one SessionBatch (cached)."""
        if self._columns is None:
            parts = list(self._batches)
            if self._pending:
                parts.append(SessionBatch.from_sessions(self._pending))
            self._columns = SessionBatch.concat(parts)
        return self._columns

    def snapshot_rows(self, start: int
                      ) -> Tuple[Tuple[str, ...], Tuple[str, ...],
                                 Dict[str, np.ndarray]]:
        """Copies of rows ``[start:n)`` of every column, walked off the
        chunk list without consolidating — O(new rows), so periodic
        engine snapshots don't pay O(all rows) per checkpoint."""
        if self._pending:   # fold row-appends into the chunk list first
            self._batches.append(SessionBatch.from_sessions(self._pending))
            self._pending = []
        dev: Tuple[str, ...] = ()
        ctry: Tuple[str, ...] = ()
        parts: Dict[str, List[np.ndarray]] = {f: [] for f in _ACC_DTYPES}
        pos = 0
        for b in self._batches:
            if b.device_names:
                dev, ctry = b.device_names, b.country_names
            nb = len(b)
            if pos + nb > start:
                lo = max(0, start - pos)
                for f in parts:
                    parts[f].append(getattr(b, f)[lo:])
            pos += nb
        cols = {f: (np.concatenate(v) if v
                    else np.zeros(0, _ACC_DTYPES[f]))
                for f, v in parts.items()}
        return dev, ctry, cols

    @property
    def sessions(self) -> Tuple[ClientSession, ...]:
        """Row-oriented compatibility view (materialised lazily). A tuple,
        not a list: appending to the view cannot reach the columnar store,
        so it fails loudly instead of silently dropping sessions — append
        through ``log_session``/``log_batch``."""
        if self._sessions is None:
            self._sessions = tuple(self.columns().to_sessions())
        return self._sessions

    # ------------------------------------------------------------ summaries
    def completed_sessions(self) -> int:
        return int(np.count_nonzero(self.columns().completed_mask))

    def participation(self) -> Dict[str, int]:
        counts = np.bincount(self.columns().outcome, minlength=len(OUTCOMES))
        return {OUTCOMES[i]: int(n) for i, n in enumerate(counts) if n}

    def total_bytes(self) -> Dict[str, float]:
        b = self.columns()
        return {"up": float(b.bytes_up.sum()),
                "down": float(b.bytes_down.sum())}

    def mean_staleness(self) -> float:
        b = self.columns()
        ok = b.completed_mask
        return float(b.staleness[ok].mean()) if ok.any() else 0.0
