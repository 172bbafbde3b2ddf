"""`repro_torch.api.sweep` — run independent ExperimentSpecs across a process
pool, or lane-batched as a handful of columnar simulations.

    results = sweep([spec_a, spec_b, ...], workers=8)
    results = sweep(specs, vectorize=True)      # lane-batched packs

Every spec is self-contained and JSON-serializable (that was the point of
the `repro_torch.api` layer), so a sweep is embarrassingly parallel: each worker
process runs `Experiment(spec).run()` and ships the whole `Result`
(columnar TaskLog included — NumPy columns pickle cheaply) back to the
parent. Results come back in spec order; `on_result` streams them to the
caller in completion order for progress display.

`workers=None` picks min(n_specs, cpu_count); `workers<=1` (or a single
spec) runs serially in-process — no pool, no pickling — which is also the
fallback when a pool cannot be spawned (restricted environments).

Lane-batched mode (``vectorize=True``)
--------------------------------------

Design-space sweeps are dozens-to-hundreds of *small* runs, exactly where
the per-call fixed cost of small columnar dispatches dominates and a
process pool caps out near the core count. ``vectorize=True`` groups
compatible specs into *lane packs* and advances each pack in lockstep as
ONE columnar simulation (`repro_torch.federated.runtime.LaneRunner`): sampler
draws become (lane, batch)-shaped arrays keyed per lane, telemetry lands
in one lane-columnar store, and the estimator reduces per-lane segments.

Pack-compatibility rules — specs pack together iff they share:

* ``federated.mode`` (one lockstep window shape per pack), where the
  registered strategy implements ``lane_loop`` ("sync", "async" and
  "carbon-aware" do; custom strategies without it run per-spec);
* ``learner == "surrogate"`` (a real learner gains nothing from
  lockstep batching; real-learner specs run per-spec).

Everything else may differ per lane: concurrency, aggregation goal,
seeds, model size, run budgets, and every ``Environment`` knob (fleet,
country mix, bandwidths, intensity tables, network model, PUE). Results
are **seed-for-seed identical** to per-spec serial runs — same summary
scalars, same session columns — because lanes share no RNG state (all
randomness is counter-keyed on each lane's own seed).

With ``workers > 1`` each pack is chunked into up to ``workers``
sub-packs that fan out across the process pool, so lane batching and
multi-core parallelism compose (a chunk still amortizes dispatch over
its lanes); pool failures fall back to running the remaining jobs
serially in-process, delivering ``on_result`` exactly once per spec
either way.

The port's differences from the reference package's sweep
------------------------------------------------------------

* ``device=`` (default ``"cuda"``) is where a real learner runs, in the
  parent and in every worker; surrogate specs ignore it.
* A worker that runs a real-learner spec is started with the ``"spawn"``
  method: a forked child of a process that has used CUDA cannot use it
  again. Surrogate-only jobs keep the platform's default, as in the
  reference. Spawned workers load the kernels built under ``build/``.
* The fault-tolerant scheduler reads whether a worker is alive before it
  polls the worker's pipe, so a worker that sends its result and exits
  between the two checks is read, not counted as died.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import BrokenExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.api.experiment import Experiment, Result
from repro_torch.api.spec import ExperimentSpec

ResultCallback = Callable[[int, Result], None]
# on_failure(spec_index, error, attempt) — fires once per failed attempt
FailureCallback = Callable[[int, BaseException, int], None]

_POOL_ERRORS = (ImportError, OSError, PermissionError, BrokenExecutor)


class _TaskFailed(Exception):
    """Wraps an exception raised by a spec's own run inside a pool worker,
    so infrastructure failures (pool can't start) stay distinguishable
    from experiment failures (which must propagate as-is, not trigger the
    serial fallback)."""

    def __init__(self, error: BaseException):
        super().__init__(repr(error))
        self.error = error


def _n_workers(n_specs: int, workers: Optional[int]) -> int:
    if workers is None:
        workers = os.cpu_count() or 1
    return max(1, min(int(workers), n_specs))


def _annotate(e: BaseException, note: str) -> BaseException:
    """Prepend context to an exception's message in place (3.10-compatible
    stand-in for ``add_note``), preserving its type so callers' ``except``
    clauses and ``pytest.raises(..., match=...)`` searches still hit."""
    if e.args and isinstance(e.args[0], str):
        e.args = (f"{note}: {e.args[0]}",) + e.args[1:]
    else:
        e.args = (note,) + tuple(e.args)
    return e


# ---------------------------------------------------------------------------
# Lane packs
# ---------------------------------------------------------------------------

def _pack_key(spec: ExperimentSpec) -> Optional[str]:
    """Lane-pack compatibility key, or None when the spec must run
    per-spec (see the module docstring for the rules). A strategy joins
    packs only by defining ``lane_loop`` on ITSELF: a registered subclass
    that overrides ``_loop`` but inherits the parent's ``lane_loop``
    would be silently lane-batched with the parent's semantics, breaking
    the lane==serial invariant — so inheritance does not opt in."""
    if spec.learner != "surrogate":
        return None
    from repro_torch.federated.runtime import STRATEGIES
    mode = spec.federated.mode
    cls = STRATEGIES.get(mode)
    if cls is None or "lane_loop" not in cls.__dict__:
        return None
    # streaming and full-telemetry lanes use different session stores
    # (StreamedLog folds vs one LaneAccumulator) — keep them in separate
    # packs so each pack's store is uniform
    return f"{mode}|{spec.run.telemetry}"


def _group_packs(specs: Sequence[ExperimentSpec]
                 ) -> List[Tuple[str, List[int]]]:
    """Partition spec indices into jobs: ("pack", [i...]) lane packs and
    ("spec", [i]) per-spec leftovers, preserving first-seen order."""
    packs: Dict[str, List[int]] = {}
    jobs: List[Tuple[str, List[int]]] = []
    for idx, spec in enumerate(specs):
        key = _pack_key(spec)
        if key is None:
            jobs.append(("spec", [idx]))
        elif key in packs:
            packs[key].append(idx)
        else:
            packs[key] = [idx]
            jobs.append(("pack", packs[key]))
    return jobs


def _chunk_packs(jobs: List[Tuple[str, List[int]]],
                 n_chunks: int) -> List[Tuple[str, List[int]]]:
    """Split each lane pack into up to ``n_chunks`` sub-packs so packs
    fan out across the process pool instead of pinning one core per mode
    (each chunk keeps enough lanes to amortize dispatch; lanes are
    independent, so any partition is equivalence-preserving)."""
    if n_chunks <= 1:
        return jobs
    out: List[Tuple[str, List[int]]] = []
    for kind, idxs in jobs:
        if kind != "pack" or len(idxs) <= 1:
            out.append((kind, idxs))
            continue
        size = -(-len(idxs) // min(n_chunks, len(idxs)))   # ceil division
        out.extend(("pack", idxs[i:i + size])
                   for i in range(0, len(idxs), size))
    return out


def _run_pack(specs: List[ExperimentSpec],
              idxs: Optional[List[int]] = None,
              device="cuda") -> List[Result]:
    """Run one lane pack through LaneRunner; Results in pack order.
    ``wall_s`` records each lane's amortized share of the pack wall.
    Failures are annotated with the lane (and sweep spec index) at fault
    so a 50-lane pack's traceback names the offending spec."""
    from repro_torch.federated.runtime import LaneRunner, LaneTask
    t0 = time.time()
    tasks = []
    for lane, spec in enumerate(specs):
        try:
            exp = Experiment(spec, device=device)
            cfg = exp.model_config
            env = spec.environment
            tasks.append(LaneTask(
                model_cfg=cfg, fed=spec.federated, run=spec.run,
                learner=exp.build_learner(),
                sampler=env.sampler(cfg, spec.federated, spec.seq_len),
                estimator=env.estimator()))
        except Exception as e:                   # noqa: BLE001
            where = f"sweep lane {lane}" if idxs is None \
                else f"sweep lane {lane} (spec index {idxs[lane]})"
            if idxs is not None:
                e.spec_index = idxs[lane]   # culprit for pack salvage
            raise _annotate(e, where)
    try:
        trs = LaneRunner(specs[0].federated.mode).run(tasks)
    except Exception as e:                       # noqa: BLE001
        where = f"sweep lane pack of {len(specs)} lanes" if idxs is None \
            else f"sweep lane pack (spec indices {list(idxs)})"
        raise _annotate(e, where)
    wall = (time.time() - t0) / len(specs)
    return [Result.from_task_result(spec, tr, wall_s=wall)
            for spec, tr in zip(specs, trs)]


def _run_job(kind: str, specs: List[ExperimentSpec],
             idxs: Optional[List[int]] = None,
             device="cuda") -> List[Result]:
    if kind == "pack":
        return _run_pack(specs, idxs, device)
    try:
        return [Experiment(specs[0], device=device).run()]
    except Exception as e:                       # noqa: BLE001
        # same index context as pack-lane failures, on BOTH the pool path
        # and the serial(-fallback) rerun — a failing spec always names
        # its sweep index
        if idxs is not None:
            e.spec_index = idxs[0]
            raise _annotate(e, f"sweep spec index {idxs[0]}")
        raise


def _run_job_safe(kind: str, specs: List[ExperimentSpec],
                  idxs: Optional[List[int]] = None, device="cuda"):
    try:
        return ("ok", _run_job(kind, specs, idxs, device))
    except Exception as e:                       # noqa: BLE001
        return ("err", e)


# ---------------------------------------------------------------------------
# Fault-tolerant execution: timeout / retry / worker death / pack salvage
# ---------------------------------------------------------------------------

@dataclass
class SpecReport:
    """Per-spec accounting of a fault-tolerant sweep.

    ``status``: "ok" (first attempt succeeded), "retried" (succeeded
    after >= 1 failed attempt), "timeout" / "failed" (exhausted
    ``retry_limit``; its ``results`` slot stays None). ``attempts``
    counts every attempt that included this spec (pack or per-spec);
    ``wall_s`` sums its amortized share of each attempt's wall clock;
    ``error`` keeps the last failure's message."""

    index: int
    status: str = "pending"
    attempts: int = 0
    wall_s: float = 0.0
    error: Optional[str] = None


@dataclass
class SweepReport:
    """What a fault-tolerant ``sweep`` did, spec by spec."""

    specs: List[SpecReport] = field(default_factory=list)

    @property
    def all_ok(self) -> bool:
        return all(s.status in ("ok", "retried") for s in self.specs)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.specs:
            out[s.status] = out.get(s.status, 0) + 1
        return out


class _WorkerDied(RuntimeError):
    """A sweep worker process exited without reporting a result."""


class _WorkerTimeout(RuntimeError):
    """A sweep worker exceeded ``timeout_s`` and was terminated."""


@dataclass
class _FTJob:
    kind: str                 # "pack" | "spec"
    idxs: List[int]
    ready_at: float = 0.0     # monotonic clock gate (retry backoff)


class _FTState:
    """Retry/salvage bookkeeping shared by the process and serial
    fault-tolerant schedulers: turns each job outcome into follow-up
    jobs and keeps the ``SweepReport`` truthful."""

    def __init__(self, n_specs: int, deliver, retry_limit: int,
                 retry_backoff_s: float,
                 on_failure: Optional[FailureCallback]):
        self.reports = [SpecReport(i) for i in range(n_specs)]
        self.deliver = deliver
        self.retry_limit = int(retry_limit)
        self.backoff = float(retry_backoff_s)
        self.on_failure = on_failure

    def start(self, job: _FTJob) -> None:
        for i in job.idxs:
            self.reports[i].attempts += 1

    def finalized(self, i: int) -> bool:
        return self.reports[i].status in ("ok", "retried", "timeout",
                                          "failed")

    def success(self, job: _FTJob, results: List[Result],
                wall: float) -> None:
        per = wall / max(len(job.idxs), 1)
        for i in job.idxs:
            rep = self.reports[i]
            rep.wall_s += per
            rep.status = "ok" if rep.attempts == 1 else "retried"
        self.deliver(job.idxs, results)

    def failure(self, job: _FTJob, error: BaseException, wall: float,
                why: str) -> List[_FTJob]:
        """Record one failed attempt; return the follow-up jobs. ``why``
        is "error" (the job raised), "died" or "timeout"."""
        per = wall / max(len(job.idxs), 1)
        for i in job.idxs:
            rep = self.reports[i]
            rep.wall_s += per
            rep.error = f"{type(error).__name__}: {error}"
            if self.on_failure is not None:
                self.on_failure(i, error, rep.attempts)
        culprit = getattr(error, "spec_index", None) if why == "error" \
            else None
        if job.kind == "pack" and len(job.idxs) > 1:
            if culprit in job.idxs:
                # salvage: the crash names one guilty lane — re-chunk the
                # surviving lanes into a fresh sub-pack (their work died
                # with the worker but their specs are fine) and isolate
                # the culprit under the retry budget
                survivors = [i for i in job.idxs if i != culprit]
                return [_FTJob("pack", survivors)] \
                    + self._retry(_FTJob("spec", [culprit]), why)
            # anonymous death/timeout: isolate every lane per-spec so one
            # bad spec cannot take the pack down again
            out: List[_FTJob] = []
            for i in job.idxs:
                out += self._retry(_FTJob("spec", [i]), why)
            return out
        return self._retry(job, why)

    def _retry(self, job: _FTJob, why: str) -> List[_FTJob]:
        tried = max(self.reports[i].attempts for i in job.idxs)
        if tried > self.retry_limit:
            final = "timeout" if why == "timeout" else "failed"
            for i in job.idxs:
                self.reports[i].status = final
            return []
        job.ready_at = time.monotonic() \
            + self.backoff * (2.0 ** (tried - 1))
        return [job]


def _ft_worker(conn, kind: str, specs: List[ExperimentSpec],
               idxs: List[int], device="cuda") -> None:
    try:
        out = _run_job(kind, specs, idxs, device)
        conn.send(("ok", out))
    except BaseException as e:                   # noqa: BLE001
        try:
            conn.send(("err", e))
        except Exception:                        # unpicklable exception
            stub = RuntimeError(f"{type(e).__name__}: {e}")
            stub.spec_index = getattr(e, "spec_index", None)
            conn.send(("err", stub))
    finally:
        conn.close()


def _mp_context(specs: Sequence[ExperimentSpec], default=None):
    """The start method of a worker that runs ``specs``: ``"spawn"`` where
    one of them is a real-learner spec (a forked child of a process that
    has used CUDA cannot use it again), else ``default``."""
    if any(s.learner != "surrogate" for s in specs):
        import multiprocessing as mp
        return mp.get_context("spawn")
    return default


def _sweep_ft_pool(jobs: List[_FTJob], specs: List[ExperimentSpec], n: int,
                   st: _FTState, timeout_s: Optional[float],
                   device="cuda") -> None:
    """Fault-tolerant scheduler: one ``multiprocessing.Process`` + pipe
    per job (not a pool executor — per-job termination is the point).
    Detects three failure shapes: the job raised (error travels back over
    the pipe), the worker died silently (process exit without a result),
    and the worker wedged (``timeout_s`` elapsed; terminated). A job
    with a real-learner spec runs in a spawned worker."""
    import multiprocessing as mp
    ctx = mp.get_context()
    pending = list(jobs)
    running: List[Tuple[_FTJob, object, object, float]] = []
    try:
        while pending or running:
            now = time.monotonic()
            i = 0
            while len(running) < n and i < len(pending):
                job = pending[i]
                if job.ready_at > now:
                    i += 1
                    continue
                pending.pop(i)
                parent, child = ctx.Pipe(duplex=False)
                proc = _mp_context([specs[j] for j in job.idxs],
                                   ctx).Process(
                    target=_ft_worker,
                    args=(child, job.kind, [specs[j] for j in job.idxs],
                          job.idxs, device),
                    daemon=True)
                st.start(job)
                proc.start()     # _POOL_ERRORS here -> serial fallback
                child.close()
                running.append((job, proc, parent, time.monotonic()))
            progressed = False
            for item in list(running):
                job, proc, conn, t0 = item
                now = time.monotonic()
                status = payload = None
                # alive is read before the poll: a worker that sends and
                # exits between the two checks is then read, not "died"
                alive = proc.is_alive()
                if conn.poll(0):
                    try:
                        status, payload = conn.recv()
                    except EOFError:
                        status = None            # died mid-send
                elif alive:
                    if timeout_s is not None and now - t0 > timeout_s:
                        proc.terminate()
                        proc.join()
                        running.remove(item)
                        conn.close()
                        err = _WorkerTimeout(
                            f"sweep worker exceeded timeout_s="
                            f"{timeout_s} running spec indices "
                            f"{job.idxs}")
                        pending.extend(
                            st.failure(job, err, now - t0, "timeout"))
                        progressed = True
                    continue
                proc.join()
                running.remove(item)
                conn.close()
                wall = time.monotonic() - t0
                if status == "ok":
                    st.success(job, payload, wall)
                elif status == "err":
                    pending.extend(st.failure(job, payload, wall, "error"))
                else:
                    err = _WorkerDied(
                        f"sweep worker died (exit code {proc.exitcode}) "
                        f"running spec indices {job.idxs}")
                    pending.extend(st.failure(job, err, wall, "died"))
                progressed = True
            if not progressed:
                time.sleep(0.005)
    finally:
        for _, proc, conn, _ in running:
            proc.terminate()
            proc.join()
            conn.close()


def _sweep_ft_serial(jobs: List[_FTJob], specs: List[ExperimentSpec],
                     st: _FTState, device="cuda") -> None:
    """In-process fault-tolerant fallback (restricted environments):
    retries with backoff still work; ``timeout_s`` and worker-death
    detection need process isolation and do not apply here."""
    pending = list(jobs)
    while pending:
        now = time.monotonic()
        ready = next((j for j in pending if j.ready_at <= now), None)
        if ready is None:
            time.sleep(max(0.0, min(j.ready_at for j in pending) - now))
            continue
        pending.remove(ready)
        st.start(ready)
        t0 = time.monotonic()
        try:
            rs = _run_job(ready.kind, [specs[i] for i in ready.idxs],
                          ready.idxs, device)
        except Exception as e:                   # noqa: BLE001
            pending.extend(
                st.failure(ready, e, time.monotonic() - t0, "error"))
        else:
            st.success(ready, rs, time.monotonic() - t0)


# ---------------------------------------------------------------------------
# The sweep entry point
# ---------------------------------------------------------------------------

def sweep(specs: Sequence[ExperimentSpec], workers: Optional[int] = None,
          on_result: Optional[ResultCallback] = None,
          vectorize: bool = False, *,
          timeout_s: Optional[float] = None, retry_limit: int = 0,
          retry_backoff_s: float = 0.5,
          on_failure: Optional[FailureCallback] = None,
          return_report: bool = False, device="cuda"):
    """Run every spec; return Results in spec order.

    on_result(index, result) fires in completion order as workers finish
    (or after each run/pack when serial). ``vectorize=True`` lane-batches
    compatible specs into lockstep packs (see module docstring); the
    per-spec path is the degenerate one-spec-per-job case of the same
    machinery.

    Fault tolerance — armed by passing any of ``timeout_s`` /
    ``retry_limit`` / ``on_failure`` / ``return_report``; without them
    the legacy all-or-nothing semantics (first failure propagates) are
    unchanged. In fault-tolerant mode every job runs in its own worker
    process (isolation is the point — a crashing spec cannot take the
    sweep down):

    * ``timeout_s`` — per job (spec or pack): a worker exceeding it is
      terminated and the job handled as a failure;
    * worker death (segfault, ``os._exit``, OOM-kill) is detected via
      the process exit code and handled as a failure;
    * failed jobs retry with exponential backoff
      (``retry_backoff_s * 2**(attempt-1)``) up to ``retry_limit``
      retries per spec;
    * a crashed *pack* whose error names a culprit lane is salvaged:
      surviving lanes re-chunk into a fresh sub-pack, the culprit
      retries alone; an anonymous pack death isolates every lane;
    * exhausted specs leave ``None`` in their results slot (partial
      results instead of all-or-nothing) with ``on_failure(index,
      error, attempt)`` fired once per failed attempt.

    With ``return_report=True`` returns ``(results, SweepReport)`` —
    per-spec status ("ok" / "retried" / "timeout" / "failed"),
    attempts, amortized wall seconds and last error (the schema is the
    :class:`SpecReport` dataclass).

    ``device`` is where real-learner specs run (``"cuda"`` by default,
    ``"cpu"`` to run them on the CPU); a worker that runs one is spawned.
    Workers on one card share its memory, and ``workers`` (by default one
    per spec, up to the CPU count) does not look at it: a worker holds its
    own CUDA context, its learner's graph pool and working memory. On an
    80 GB H100, two workers running full-width paper-charlm specs (a
    16-client sync cohort and async) added 24.7 GiB at their peak, and the
    sync learner's graph pool alone holds 8.0 GiB (``chip_smoke.py``,
    phase 5e), so a few such workers fill the card.
    """
    specs = list(specs)
    fault_tolerant = (timeout_s is not None or retry_limit > 0
                      or on_failure is not None or return_report)
    if not specs:
        return ([], SweepReport()) if return_report else []
    if vectorize:
        jobs = _chunk_packs(_group_packs(specs),
                            _n_workers(len(specs), workers))
    else:
        jobs = [("spec", [i]) for i in range(len(specs))]
    results: List[Optional[Result]] = [None] * len(specs)

    def deliver(idxs: List[int], rs: List[Result]) -> None:
        for i, r in zip(idxs, rs):
            results[i] = r
            if on_result is not None:
                on_result(i, r)

    if fault_tolerant:
        st = _FTState(len(specs), deliver, retry_limit, retry_backoff_s,
                      on_failure)
        ft_jobs = [_FTJob(kind, list(idxs)) for kind, idxs in jobs]
        n = _n_workers(len(ft_jobs), workers)
        try:
            _sweep_ft_pool(ft_jobs, specs, n, st, timeout_s, device)
        except _POOL_ERRORS as e:
            import warnings
            remaining = [
                _FTJob(j.kind, [i for i in j.idxs if not st.finalized(i)])
                for j in ft_jobs]
            remaining = [j for j in remaining if j.idxs]
            warnings.warn(
                f"sweep: worker processes unavailable ({e!r}); running "
                f"the remaining jobs in-process — timeout_s and "
                f"worker-death detection are disabled, retries still "
                f"apply", RuntimeWarning, stacklevel=2)
            _sweep_ft_serial(remaining, specs, st, device)
        report = SweepReport(st.reports)
        return (results, report) if return_report else results

    n = _n_workers(len(jobs), workers)
    if n > 1 and len(jobs) > 1:
        try:
            _sweep_pool(jobs, specs, n, deliver, device)
        except _TaskFailed as tf:
            raise tf.error                # an experiment itself failed
        except _POOL_ERRORS as e:
            # restricted environments (no /dev/shm, no fork / broken pool)
            # fall back to in-process — only for the jobs the pool never
            # finished, so on_result fires exactly once per spec
            import warnings
            pending = [i for i, r in enumerate(results) if r is None]
            warnings.warn(
                f"sweep: process pool unavailable ({e!r}); running the "
                f"remaining {len(pending)}/{len(specs)} specs "
                f"in-process (spec indices {pending})",
                RuntimeWarning, stacklevel=2)
    for kind, idxs in jobs:
        if results[idxs[0]] is None:      # packs deliver all-or-nothing
            deliver(idxs, _run_job(kind, [specs[i] for i in idxs], idxs,
                                   device))
    return results  # type: ignore[return-value]


def _sweep_pool(jobs: List[Tuple[str, List[int]]],
                specs: List[ExperimentSpec], n: int,
                deliver: Callable[[List[int], List[Result]], None],
                device="cuda") -> None:
    from concurrent.futures import ProcessPoolExecutor, as_completed
    with ProcessPoolExecutor(max_workers=n, mp_context=_mp_context(
            [specs[i] for _, idxs in jobs for i in idxs])) as pool:
        futures = {pool.submit(_run_job_safe, kind,
                               [specs[i] for i in idxs], idxs, device): idxs
                   for kind, idxs in jobs}
        for fut in as_completed(futures):
            status, payload = fut.result()
            if status == "err":
                raise _TaskFailed(payload)
            deliver(futures[fut], payload)
