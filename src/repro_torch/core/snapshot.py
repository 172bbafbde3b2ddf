"""Engine snapshots — versioned mid-run checkpoints that resume exactly.

A production FL task runs for days; the harness must survive its own
interruptions the same way the availability model's device
checkpointing survives client churn. This module serializes the full mid-run state of the serial event
loops (`SyncStrategy._loop` / `AsyncStrategy._loop`, carbon-aware
included) as a single ``.npz`` file:

* ``header`` — a 0-d unicode array holding a JSON dict: format tag +
  ``SNAPSHOT_VERSION``, the producing spec (embedded, plus its
  ``content_hash``), the loop's scalar state (clock, round/version,
  perplexity, the sync cohort RNG state), the ``_Stopper`` and surrogate
  learner state, telemetry counters and eval history, and the streaming
  ``ExactSum`` states (hex-mantissa, exact). Python's ``json`` round-trips
  int and float64 values exactly, so every scalar restores bit-for-bit.
* array payloads — namespaced npz members: the async in-flight slot
  columns (``engine/flight_*``) and the streaming reservoir /
  grouped-table arrays (``stream/*``).
* materialized session rows live in an append-only sidecar,
  ``<path>.rows`` (``_RowStore``): each checkpoint appends ONE segment
  holding only the rows logged since the previous checkpoint
  (``np.lib.format`` arrays in ``_ACC_DTYPES`` field order), and the
  header's ``sessions`` meta records the segment table and valid byte
  length. That keeps per-checkpoint cost O(new rows); re-serializing the
  whole cumulative log every 50 windows would be quadratic over a run.

Checkpoints are written at round (sync) / server-version (async) window
boundaries only. Crash safety: the rows segment is appended and flushed
FIRST, then the head file is replaced atomically (tmp + ``os.replace``)
— a crash between the two leaves the old head pointing at a valid
prefix of the rows file, and the torn tail is truncated when the next
run adopts the store. Because every per-session draw is a counter-keyed
pure function of ``(seed, slot, generation, ...)`` — never of global
history — the state above is *sufficient*: a resumed loop replays the
remaining rounds bit-for-bit, and work done after the last checkpoint
is simply redone.

``_CrashInjector`` is the test-only fault hook: armed by env vars
(``REPRO_CRASH_ROUND``, ``REPRO_CRASH_KIND=raise|kill|hang``,
``REPRO_CRASH_SEED`` to target one spec of a sweep, ``REPRO_CRASH_ONCE``
pointing at a marker file so the crash fires exactly once), it raises
``InjectedCrash``, hard-exits the worker, or hangs it at a chosen round —
driving the resume property tests, the fault-tolerant sweep tests and the
smoke step.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.telemetry import SessionBatch, TaskLog, _ACC_DTYPES

SNAPSHOT_VERSION = 1
_FORMAT = "repro-engine-snapshot"

# exit code a kill-injected worker dies with (distinguishable from crashes
# of the interpreter itself in test assertions)
KILL_EXIT_CODE = 87


class InjectedCrash(RuntimeError):
    """Raised by an armed ``_CrashInjector`` (kind="raise")."""


class _CrashInjector:
    """Test-only: crash the current run when the loop reaches a round.

    ``tick(round_idx)`` fires once ``round_idx >= at_round``: ``raise``
    raises :class:`InjectedCrash` in-process, ``kill`` hard-exits the
    worker (``os._exit`` — simulates a dead sweep worker: no exception,
    no result), ``hang`` sleeps forever (simulates a wedged worker for
    timeout detection). With ``once_path`` set the injector creates that
    marker file *before* crashing and stays disarmed while it exists, so
    a retried attempt succeeds.
    """

    def __init__(self, at_round: int, kind: str = "raise",
                 once_path: Optional[str] = None):
        assert kind in ("raise", "kill", "hang"), kind
        self.at_round = int(at_round)
        self.kind = kind
        self.once_path = once_path

    @classmethod
    def from_env(cls, environ=None, seed: Optional[int] = None
                 ) -> Optional["_CrashInjector"]:
        env = os.environ if environ is None else environ
        at = env.get("REPRO_CRASH_ROUND")
        if at is None:
            return None
        target = env.get("REPRO_CRASH_SEED")
        if target is not None and seed is not None \
                and int(target) != int(seed):
            return None
        return cls(int(at), env.get("REPRO_CRASH_KIND", "raise"),
                   env.get("REPRO_CRASH_ONCE") or None)

    def tick(self, round_idx: int) -> None:
        if round_idx < self.at_round:
            return
        if self.once_path:
            if os.path.exists(self.once_path):
                return
            with open(self.once_path, "w"):
                pass
        if self.kind == "kill":
            os._exit(KILL_EXIT_CODE)
        if self.kind == "hang":
            while True:   # parent terminates us on timeout
                time.sleep(0.25)
        raise InjectedCrash(
            f"injected crash at round {round_idx} "
            f"(>= REPRO_CRASH_ROUND {self.at_round})")


# ---------------------------------------------------------------------------
# Save / load
# ---------------------------------------------------------------------------

_ROWS_SUFFIX = ".rows"


class _RowStore:
    """Append-only session-row sidecar beside the head checkpoint file.

    Every checkpoint appends ONE segment holding the materialized rows
    logged since the previous one — ``np.lib.format`` arrays, one per
    SessionBatch column in ``_ACC_DTYPES`` order — so periodic
    checkpointing costs O(new rows) per save instead of re-serializing
    the whole cumulative log. The segment table (offsets + row counts)
    and the valid byte length travel in the HEAD file: bytes past
    ``valid_bytes`` are a torn tail from a crash between segment append
    and head replace, truncated when the store is adopted on resume."""

    def __init__(self, path: str, meta: Optional[Dict] = None):
        self.path = path
        if meta is None:
            self.segments: list = []
            self.valid_bytes = 0
            self.rows = 0
            self.names: Optional[Tuple[tuple, tuple]] = None
            self._adopted = True            # fresh store, nothing to trim
        else:                               # continue a resumed store
            self.segments = [dict(s) for s in meta["segments"]]
            self.valid_bytes = int(meta["valid_bytes"])
            self.rows = int(meta["rows"])
            self.names = (tuple(meta["device_names"]),
                          tuple(meta["country_names"])) \
                if meta.get("device_names") else None
            self._adopted = False

    def meta(self, owner: str) -> Dict:
        dev, ctry = self.names if self.names else ((), ())
        return {"owner": owner, "file": os.path.basename(self.path),
                "rows": self.rows, "valid_bytes": self.valid_bytes,
                "segments": self.segments,
                "device_names": list(dev), "country_names": list(ctry)}

    def append(self, dev: tuple, ctry: tuple,
               cols: Dict[str, np.ndarray]) -> None:
        n = len(cols["client_id"])
        if not n:
            return
        if self.names is None:
            self.names = (tuple(dev), tuple(ctry))
        elif (tuple(dev), tuple(ctry)) != self.names:
            raise ValueError("session vocabularies changed mid-run; "
                             "cannot checkpoint incrementally")
        if not self._adopted:
            with open(self.path, "r+b") as f:   # drop any torn tail
                f.truncate(self.valid_bytes)
            self._adopted = True
        mode = "wb" if self.valid_bytes == 0 else "ab"
        with open(self.path, mode) as f:
            off = f.tell()
            for field in _ACC_DTYPES:
                np.lib.format.write_array(
                    f, np.ascontiguousarray(cols[field]),
                    allow_pickle=False)
            end = f.tell()
        self.segments.append({"offset": off, "rows": n})
        self.valid_bytes = end
        self.rows += n

    @staticmethod
    def read(path: str, meta: Dict) -> Dict[str, np.ndarray]:
        """Concatenate every segment back into full columns."""
        parts: Dict[str, list] = {f: [] for f in _ACC_DTYPES}
        with open(path, "rb") as f:
            for seg in meta["segments"]:
                f.seek(int(seg["offset"]))
                for field in _ACC_DTYPES:
                    parts[field].append(
                        np.lib.format.read_array(f, allow_pickle=False))
        return {f: (np.concatenate(v) if v else np.zeros(0, _ACC_DTYPES[f]))
                for f, v in parts.items()}


def save_snapshot(path: str, *, spec, mode: str, every: int, round_idx: int,
                  engine: Dict, log: TaskLog, learner, stop,
                  sessions: Optional[Dict] = None) -> None:
    """Write one head checkpoint atomically (tmp file + ``os.replace``).

    ``engine`` mixes JSON-able scalars (clock, counters, the sync RNG
    state dict) with numpy arrays (async flight columns) — arrays go to
    npz members, the rest into the header. ``sessions`` is the
    ``_RowStore`` meta describing the materialized session rows already
    appended to the sidecar (None for streaming telemetry, whose
    constant-size state rides in the head itself)."""
    header: Dict = {
        "format": _FORMAT,
        "version": SNAPSHOT_VERSION,
        "spec_hash": spec.content_hash(),
        "spec": spec.to_dict(),
        "mode": mode,
        "every": int(every),
        "round": int(round_idx),
        "stopper": {"smoothed": stop.smoothed, "hits": stop.hits,
                    "reached": stop.reached, "aborted": stop.aborted},
        "learner": learner.state(),
        "sessions": sessions,
    }
    arrays: Dict[str, np.ndarray] = {}
    scalars: Dict = {}
    for k, v in engine.items():
        if isinstance(v, np.ndarray):
            arrays[f"engine/{k}"] = v
        else:
            scalars[k] = v
    header["engine"] = scalars

    logh: Dict = {"rounds": log.rounds, "starved_rounds": log.starved_rounds,
                  "duration_s": log.duration_s,
                  "server_busy_s": log.server_busy_s,
                  "eval_history": log.eval_history}
    if hasattr(log, "stream_state"):
        logh["kind"] = "streaming"
        meta, arrs = log.stream_state()
        logh["stream"] = meta
        for k, a in arrs.items():
            arrays[f"stream/{k}"] = a
    else:
        logh["kind"] = "full"
    header["log"] = logh

    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, header=np.asarray(json.dumps(header)), **arrays)
    os.replace(tmp, path)


def load_snapshot(path: str) -> "Snapshot":
    """Load and validate a checkpoint; raises ``ValueError`` naming the
    found and supported versions on a format/version mismatch (spec-hash
    validation happens in ``Experiment``, which knows the expected spec)."""
    with np.load(path, allow_pickle=False) as data:
        if "header" not in data.files:
            raise ValueError(f"{path!r} is not a {_FORMAT} file "
                             f"(no header member)")
        header = json.loads(str(data["header"][()]))
        arrays = {k: data[k] for k in data.files if k != "header"}
    if header.get("format") != _FORMAT:
        raise ValueError(
            f"{path!r} is not a {_FORMAT} file "
            f"(format tag {header.get('format')!r})")
    v = header.get("version")
    if v != SNAPSHOT_VERSION:
        raise ValueError(
            f"unsupported checkpoint version {v!r} in {path!r}; this "
            f"build reads snapshot version {SNAPSHOT_VERSION}")
    return Snapshot(header, arrays, path)


class Snapshot:
    """A loaded checkpoint: validated header dict + payload arrays."""

    def __init__(self, header: Dict, arrays: Dict[str, np.ndarray],
                 path: Optional[str] = None):
        self.header = header
        self.arrays = arrays
        self.path = path

    @property
    def spec_hash(self) -> str:
        return self.header["spec_hash"]

    @property
    def round_idx(self) -> int:
        return int(self.header["round"])

    @property
    def every(self) -> int:
        return int(self.header.get("every", 0))

    def spec(self):
        from repro_torch.api.spec import ExperimentSpec   # lazy: avoid core->api
        return ExperimentSpec.from_dict(self.header["spec"])

    def engine_state(self) -> Dict:
        """Loop-local state: header scalars merged with ``engine/*``
        arrays (keys as the loop stored them)."""
        out = dict(self.header["engine"])
        for k, a in self.arrays.items():
            if k.startswith("engine/"):
                out[k[len("engine/"):]] = a
        return out

    def _sessions_batch(self, owner: str) -> Optional[SessionBatch]:
        """Rows of the given owner ("log" / "sink") read back from the
        rows sidecar, as one consolidated SessionBatch."""
        meta = self.header.get("sessions")
        if meta is None or meta["owner"] != owner or not meta["rows"]:
            return None
        rows_path = os.path.join(os.path.dirname(self.path or ""),
                                 meta["file"])
        return SessionBatch(
            device_names=tuple(meta["device_names"]),
            country_names=tuple(meta["country_names"]),
            **_RowStore.read(rows_path, meta))

    def sink_batch(self) -> Optional[SessionBatch]:
        """Pre-checkpoint rows of the async materialized window sink."""
        return self._sessions_batch("sink")

    # ------------------------------------------------------------- restore
    def restore_log(self, log: TaskLog) -> None:
        logh = self.header["log"]
        log.rounds = int(logh["rounds"])
        log.starved_rounds = int(logh["starved_rounds"])
        log.duration_s = float(logh["duration_s"])
        log.server_busy_s = float(logh["server_busy_s"])
        log.eval_history = [dict(e) for e in logh["eval_history"]]
        if logh["kind"] == "streaming":
            if not hasattr(log, "load_stream_state"):
                raise ValueError(
                    "checkpoint carries streaming telemetry state but the "
                    "resumed run built a materialized log (spec mismatch)")
            log.load_stream_state(
                logh["stream"],
                {k[len("stream/"):]: a for k, a in self.arrays.items()
                 if k.startswith("stream/")})
        else:
            batch = self._sessions_batch("log")
            if batch is not None:
                log.log_batch(batch)

    def restore_stopper(self, stop) -> None:
        sh = self.header["stopper"]
        stop.smoothed = sh["smoothed"]
        stop.hits = int(sh["hits"])
        stop.reached = bool(sh["reached"])
        stop.aborted = bool(sh["aborted"])

    def restore_learner(self, learner) -> None:
        if not hasattr(learner, "load_state"):
            raise ValueError(
                "engine snapshots require a learner with state()/"
                "load_state() (the surrogate); the real JAX learner is "
                "not resumable")
        learner.load_state(self.header["learner"])


# ---------------------------------------------------------------------------
# The loop-side hook
# ---------------------------------------------------------------------------

class SnapshotHook:
    """What the event loops see: ``tick(round_idx, build_state)`` saves a
    checkpoint every ``every`` rounds (then fires the crash injector, so a
    crash-at-checkpoint-round still leaves that checkpoint behind), and
    ``engine_state``/``sink_batch`` hand a resuming loop its saved state.

    ``build_state`` is a zero-arg callable returning ``(engine_dict,
    sink_accumulator_or_None)`` — state assembly is deferred so a hook
    with no checkpoint path (crash-injection only) costs nothing per
    round. The sink accumulator (async materialized window sink) and the
    log are mined with ``snapshot_rows`` so each save appends only the
    rows logged since the previous checkpoint to the rows sidecar.
    """

    def __init__(self, *, path: Optional[str] = None, every: int = 0,
                 spec=None, mode: str = "",
                 crash: Optional[_CrashInjector] = None,
                 resume: Optional[Snapshot] = None):
        self.path = path
        self.every = int(every)
        self.spec = spec
        self.mode = mode
        self.crash = crash
        self.resume = resume
        self.saves = 0          # checkpoints written by THIS run
        self.save_wall_s = 0.0  # wall seconds spent writing them
        # never re-save the state we just resumed from
        self._last_saved = resume.round_idx if resume is not None else -1
        self._rows: Optional[_RowStore] = None
        if path:
            meta = None
            if resume is not None and resume.path is not None \
                    and os.path.abspath(path) \
                    == os.path.abspath(resume.path):
                # continuing the resumed store: adopt its segment table
                # (a fresh path re-writes all rows as its first segment)
                meta = resume.header.get("sessions")
            self._rows = _RowStore(path + _ROWS_SUFFIX, meta)

    @property
    def engine_state(self) -> Optional[Dict]:
        return None if self.resume is None else self.resume.engine_state()

    def sink_batch(self) -> Optional[SessionBatch]:
        return None if self.resume is None else self.resume.sink_batch()

    def tick(self, round_idx: int,
             build_state: Callable[[], Tuple[Dict, Optional[object]]],
             log: TaskLog, learner, stop) -> None:
        if (self.path and self.every > 0 and round_idx > 0
                and round_idx % self.every == 0
                and round_idx != self._last_saved):
            t0 = time.perf_counter()
            engine, sink = build_state()
            sessions = None
            if not hasattr(log, "stream_state"):
                source = log if sink is None else sink
                owner = "log" if sink is None else "sink"
                dev, ctry, cols = source.snapshot_rows(self._rows.rows)
                self._rows.append(dev, ctry, cols)   # BEFORE the head
                sessions = self._rows.meta(owner)
            save_snapshot(self.path, spec=self.spec, mode=self.mode,
                          every=self.every, round_idx=round_idx,
                          engine=engine, log=log, learner=learner,
                          stop=stop, sessions=sessions)
            self._last_saved = round_idx
            self.saves += 1
            self.save_wall_s += time.perf_counter() - t0
        if self.crash is not None:
            self.crash.tick(round_idx)
