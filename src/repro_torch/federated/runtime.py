"""The FL task runtime: synchronous (FedAvg) and asynchronous (FedBuff)
event loops with full carbon telemetry (paper §3.1).

Both loops are ``Strategy`` classes registered in the string-keyed
``STRATEGIES`` registry ("sync", "async", "carbon-aware";
``register_strategy`` stays open for new policies). They drive a pluggable
learner (RealLearner or SurrogateLearner) through the same PAPAYA-shaped
protocol:

sync  — each round selects `concurrency` clients ("users per round"); the
        round closes when the `aggregation_goal`-th result arrives; clients
        still running are cancelled (over-selection waste is charged);
        server updates once per round.
async — `concurrency` clients are always in flight; a finished client's
        (staleness-weighted) delta joins the buffer; every
        `aggregation_goal` arrivals the server updates and later clients
        train on the newer model (FedBuff). Stragglers never block.
carbon-aware — the async loop with grid-aware cohort selection (CAFE-style
        time/geo shifting): each replacement dispatch screens a counter-
        keyed stream of candidate ids and takes the first whose country
        draw lands in the ``carbon_topk`` lowest-intensity countries at
        the dispatch clock (``Environment.intensity_schedule`` supplies
        the diurnal curves), with a ``carbon_explore`` floor of
        unscreened dispatches. See ``CarbonAwareStrategy``.

Both loops are columnar end-to-end: cohorts are planned/resolved through
the vectorized ``SessionSampler.plan_batch``/``resolve_batch`` and logged
as ``SessionBatch`` columns, so the per-session cost is a few array ops
rather than Python-object allocation. Sync closes each round with a
partition on end_t; async is a window-batched exact merge — per-slot
splitmix64 replacement-id streams (``slot_stream_ids``) decouple
replacement identity from arrival order, so the span between two server
updates resolves as arrays instead of a per-session heap pop (see
``AsyncStrategy``). The returned TaskLog contains every session's vitals;
CarbonEstimator turns it into the paper's component breakdown. Strategies
emit a ``RoundEvent`` after every server eval so callers
(``repro_torch.api.Experiment``) can stream progress. ``run_task`` survives
only as a deprecated shim over the registry — new code goes through
``repro_torch.api``.

The engine also vectorizes across the *spec* axis: ``LaneRunner`` packs
compatible experiments (same mode; any mix of concurrency, goals, seeds,
models, budgets, Environments) and both strategies implement
``lane_loop`` — a lockstep twin of ``_loop`` where every sampler call is
``(lane, batch)``-shaped (``events.LaneSampler``), sessions land in one
``telemetry.LaneAccumulator`` store with a lane column, and the
estimator reduces per-lane segments (``estimator.lane_carbon``).
Lane-batched results are seed-for-seed identical to per-spec runs; the
reference package's ``repro.api.sweep(specs, vectorize=True)`` is their
front end (the port has no ``sweep`` yet).
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from repro_torch.configs.base import FederatedConfig, ModelConfig, RunConfig
from repro_torch.core.carbon import SECONDS_PER_DAY
from repro_torch.core.estimator import (CarbonBreakdown, CarbonEstimator,
                                  lane_carbon)
from repro_torch.core.streaming import StreamedLog
from repro_torch.core.telemetry import (OUTCOME_CODE, BatchAccumulator,
                                  LaneAccumulator, SessionBatch, TaskLog)
from repro_torch.federated.events import (LaneSampler, SessionSampler,
                                    probe_uniforms, retry_stream_ids,
                                    slot_stream_ids)

_SERVER_AGG_S = 2.0     # server-side aggregation latency per update
_POPULATION = 5_000_000  # eligible-device pool the coordinator selects from
# dispatch cohorts are planned/resolved in blocks of at most this many rows
# so population-scale concurrency never materializes a full-cohort plan;
# plan/resolve are row-pure, so any chunking is bit-identical (tests
# monkeypatch this down to exercise the chunked paths at small scale)
_DISPATCH_CHUNK = 1 << 17


@dataclass
class TaskResult:
    log: TaskLog
    carbon: CarbonBreakdown
    reached_target: bool
    rounds: int
    duration_h: float
    final_perplexity: float
    smoothed_perplexity: float
    # True iff the sync loop gave up after `starvation_patience`
    # consecutive under-quorum (starved) rounds
    aborted: bool = False

    def summary(self) -> Dict[str, float]:
        return {
            "rounds": self.rounds,
            "duration_h": self.duration_h,
            "reached_target": float(self.reached_target),
            "perplexity": self.final_perplexity,
            "carbon_total_kg": self.carbon.total_kg,
            **{k: v for k, v in self.carbon.as_dict().items()},
            "sessions": float(self.log.n_sessions),
            "aborted": float(self.aborted),
        }


@dataclass(frozen=True)
class RoundEvent:
    """Streamed to `on_round` after every server eval (both strategies)."""
    round_idx: int               # server model updates so far
    t_s: float                   # task clock, seconds
    perplexity: float
    smoothed_perplexity: float
    n_sessions: int              # client sessions logged so far
    mode: str                    # strategy key ("sync"/"async"/"carbon-aware")


RoundCallback = Callable[[RoundEvent], None]


class _Stopper:
    """Paper §3.2: stop when smoothed test perplexity has been at/below the
    target for `patience` consecutive evals, or at the time limit."""

    def __init__(self, run: RunConfig):
        self.run = run
        self.smoothed: Optional[float] = None
        self.hits = 0
        self.reached = False
        self.aborted = False   # set by the sync starvation-patience abort

    def update(self, ppl: float) -> None:
        a = self.run.ema_alpha
        self.smoothed = ppl if self.smoothed is None else \
            a * ppl + (1 - a) * self.smoothed
        if self.smoothed <= self.run.target_perplexity:
            self.hits += 1
        else:
            self.hits = 0
        if self.hits >= self.run.patience_rounds:
            self.reached = True

    def out_of_budget(self, t_s: float, rounds: int) -> bool:
        return (t_s >= self.run.max_hours * 3600.0
                or rounds >= self.run.max_rounds)


def _select_cohort(rng: np.random.Generator, k: int,
                   population: int) -> np.ndarray:
    """Coordinator client selection: eligible devices, unique per round.
    Sampled without replacement from the population directly (the old
    sample-from-a-larger-range-then-modulo trick silently reintroduced
    duplicates and a mild modulo bias)."""
    return rng.choice(population, size=k, replace=False).astype(np.int64)


def _sync_dispatch_n(fed: FederatedConfig, goal: int) -> int:
    """Sync round cohort size. With ``over_select_fraction`` f > 0 the
    coordinator explicitly dispatches ceil((1+f)*goal) clients (always
    >= goal) and cancels the surplus at the round close; f == 0 keeps the
    legacy concurrency-sized cohort."""
    if fed.over_select_fraction > 0:
        return int(math.ceil((1.0 + fed.over_select_fraction) * goal))
    return fed.concurrency


def _retry_rem(outcome: np.ndarray, planned_c: np.ndarray,
               burned_c: np.ndarray, rem, period_s) -> np.ndarray:
    """Per-row remainder fraction (of an ORIGINAL full session's compute)
    a retry child must redo, given its parent attempt's outcome. Failed
    attempts redo their parent's whole remainder ``rem``; interrupted
    attempts salvage local progress to the last checkpoint —
    ``floor(burned / P) * P`` of the parent's (already rem-scaled)
    planned compute survives the interruption, so the child's remainder
    shrinks by that completed fraction. With ``period_s`` == 0 (salvage
    off) every entry stays at its parent's ``rem`` (1.0 for fresh
    dispatches), and all downstream ``compute_s * rem`` multiplies are
    IEEE-exact no-ops — fault-only runs are untouched bit for bit.
    Row-pure, shared verbatim by the scalar oracle."""
    F, I = OUTCOME_CODE["failed"], OUTCOME_CODE["interrupted"]
    out = np.where((outcome == F) | (outcome == I),
                   np.asarray(rem, np.float64), 1.0)
    P = np.broadcast_to(np.asarray(period_s, np.float64), outcome.shape)
    im = np.flatnonzero((outcome == I) & (P > 0))
    if len(im):
        salv = np.floor(burned_c[im] / P[im]) * P[im]
        fc = planned_c[im]
        frac = np.divide(salv, fc, out=np.zeros(len(im)), where=fc > 0)
        out[im] = out[im] * (1.0 - frac)
    return out


def _sync_server_update(learner, contributors: List[int]) -> float:
    """One FedAvg server update from a round's contributor list; returns
    the fresh eval perplexity (shared by the serial and lane loops)."""
    deltas, weights = [], []
    if getattr(learner, "real", True):
        if hasattr(learner, "client_deltas"):
            deltas, weights = learner.client_deltas(contributors)
        else:
            for c in contributors:
                d, w = learner.client_delta(c, None)
                deltas.append(d)
                weights.append(w)
    else:
        deltas, weights = [None], [1.0]
    learner.apply(deltas, weights, n_contributors=len(contributors))
    return learner.eval_perplexity()


def _async_server_update(learner, cids: np.ndarray, vers_ok: np.ndarray,
                         version: int) -> float:
    """One FedBuff server update from the buffer's contributing arrivals;
    returns the fresh eval perplexity (shared by the serial and lane
    loops)."""
    if getattr(learner, "real", True):
        staleness = (version - vers_ok).tolist()
        deltas, weights = [], []
        for bc, bv in zip(cids.tolist(), vers_ok.tolist()):
            dd, w = learner.client_delta(bc, bv)
            deltas.append(dd)
            weights.append(w)
        kw_extra = {"staleness": staleness}
        mean_st = float(np.mean(staleness))
    else:
        deltas, weights, kw_extra = [None], [1.0], {}
        mean_st = version - (vers_ok.sum() / len(vers_ok))
    learner.apply(deltas, weights, n_contributors=len(vers_ok),
                  mean_staleness=mean_st, **kw_extra)
    return learner.eval_perplexity()


# ---------------------------------------------------------------------------
# Strategy registry
# ---------------------------------------------------------------------------

STRATEGIES: Dict[str, Type["Strategy"]] = {}


def register_strategy(name: str):
    """Class decorator: expose a Strategy under a string key (open for
    carbon-aware selection policies next)."""
    def deco(cls: Type["Strategy"]) -> Type["Strategy"]:
        cls.mode = name
        STRATEGIES[name] = cls
        return cls
    return deco


def get_strategy(name: str) -> "Strategy":
    try:
        return STRATEGIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; registered: {sorted(STRATEGIES)}"
        ) from None


class Strategy:
    """One FL orchestration policy. Subclasses implement `_loop`; the base
    handles sampler/estimator wiring so every strategy sees the same
    environment knobs (fleet, country mix, bandwidths, carbon models)."""

    mode: str = ""

    def run(self, model_cfg: ModelConfig, fed: FederatedConfig,
            run: RunConfig, learner, *, seq_len: int = 64,
            estimator: Optional[CarbonEstimator] = None,
            sampler: Optional[SessionSampler] = None,
            on_round: Optional[RoundCallback] = None,
            snap=None) -> TaskResult:
        sampler = sampler or SessionSampler(model_cfg, fed, seq_len)
        est = estimator or CarbonEstimator()
        # selection policies may read the environment's grid model (the
        # carbon-aware strategy screens candidates by intensity-at-clock)
        self._estimator = est
        # checkpoint/resume salvage only counts when a resume can actually
        # use the checkpoint: availability churn live AND retries enabled.
        # The estimator reads this off the log to split interrupted rows'
        # wasted compute into salvaged (pre-checkpoint) vs lost.
        ckpt = fed.checkpoint_period_s \
            if (sampler.has_avail and fed.retry_limit > 0) else 0.0
        if run.telemetry == "streaming":
            log: TaskLog = StreamedLog(est, sampler.device_names,
                                       sampler.country_names, seed=fed.seed,
                                       sample=run.telemetry_sample,
                                       mode=self.mode,
                                       checkpoint_period_s=ckpt)
        else:
            log = TaskLog()
            log.checkpoint_period_s = ckpt
        stop = _Stopper(run)
        # engine snapshots (repro_torch.core.snapshot): the hook rides on the
        # instance so subclassed `_loop` signatures stay untouched; loops
        # read it back with getattr. Resume restores the log / stopper /
        # learner here (they are built above); the loop-local state is
        # restored by `_loop` itself.
        self._snap = snap
        if snap is not None and snap.resume is not None:
            snap.resume.restore_log(log)
            snap.resume.restore_stopper(stop)
            snap.resume.restore_learner(learner)
        t, rounds, ppl = self._loop(model_cfg, fed, learner, sampler, log,
                                    stop, on_round)
        return TaskResult(log, est.estimate(log), stop.reached, rounds,
                          t / 3600.0, ppl, stop.smoothed or ppl,
                          aborted=stop.aborted)

    # subclasses: run the event loop, return (t_s, rounds, perplexity)
    def _loop(self, model_cfg: ModelConfig, fed: FederatedConfig, learner,
              sampler: SessionSampler, log: TaskLog, stop: _Stopper,
              on_round: Optional[RoundCallback]) -> Tuple[float, int, float]:
        raise NotImplementedError

    def _emit(self, on_round: Optional[RoundCallback], n_sessions: int,
              round_idx: int, t: float, ppl: float, smoothed: float) -> None:
        if on_round is not None:
            on_round(RoundEvent(round_idx, t, ppl, smoothed,
                                n_sessions, self.mode))

    @staticmethod
    def _make_sink(log: TaskLog, device_names: Tuple[str, ...],
                   country_names: Tuple[str, ...]):
        """Window sink for loops that log in column blocks: a streaming
        log folds appended blocks directly (constant memory); a full log
        stages them in a BatchAccumulator flushed at task end."""
        if hasattr(log, "append"):
            return log
        return BatchAccumulator(device_names, country_names)

    @staticmethod
    def _flush_sink(log: TaskLog, acc) -> None:
        if acc is not log and len(acc):
            log.log_batch(acc.to_batch())


@register_strategy("sync")
class SyncStrategy(Strategy):
    """FedAvg rounds with over-selection cancel (paper §3.1 sync)."""

    def _loop(self, model_cfg, fed, learner, sampler, log, stop, on_round):
        assert fed.mode == "sync"
        snap = getattr(self, "_snap", None)
        rng = np.random.default_rng(fed.seed + 1)
        t = 0.0
        rounds = 0
        ppl = float(model_cfg.vocab_size)
        goal = min(fed.aggregation_goal, fed.concurrency)
        # explicit over-selection: surplus sessions past the round close
        # relabel "cancelled" (dropped is the implicit-deadline legacy)
        ndisp = _sync_dispatch_n(fed, goal)
        lc = OUTCOME_CODE["cancelled"] if fed.over_select_fraction > 0 \
            else None
        # graceful degradation: a round that closes with fewer than
        # `quorum` completions is *starved* — it still charges its cohort,
        # but the server skips the update; `starvation_patience`
        # consecutive starved rounds abort the task outright
        quorum = max(1, int(np.ceil(fed.min_report_fraction * goal)))
        streak = 0
        if snap is not None and snap.engine_state is not None:
            # resume at a round boundary: the saved RNG state was captured
            # before the round's cohort draw, so selection replays exactly
            es = snap.engine_state
            t = float(es["t"])
            rounds = int(es["rounds"])
            ppl = float(es["ppl"])
            streak = int(es["streak"])
            rng.bit_generator.state = es["rng_state"]

        while True:
            if snap is not None:
                snap.tick(rounds, lambda: (
                    dict(t=t, rounds=rounds, ppl=ppl, streak=streak,
                         rng_state=rng.bit_generator.state), None),
                    log, learner, stop)
            cohort = _select_cohort(rng, ndisp, population=_POPULATION)
            if sampler.has_faults or (sampler.has_avail
                                      and fed.retry_limit > 0):
                n_ok, contributors, round_end = self._faulty_round(
                    fed, sampler, log, cohort, rounds, t, goal,
                    late_code=lc)
            elif len(cohort) <= _DISPATCH_CHUNK:
                pb = sampler.plan_batch(cohort, rounds)
                # pass 1: tentative outcomes, find when the goal-th result
                # arrives (a partition on end_t, not a full sort)
                tb, ok = sampler.resolve_batch(pb, rounds, t)
                ends = tb.end_t[ok]
                if len(ends) >= goal:
                    round_end = float(np.partition(ends, goal - 1)[goal - 1])
                elif len(ends):
                    # dropouts ate the over-selection slack: the round
                    # closes at the last survivor (production would hit the
                    # round deadline) and the server updates with what it
                    # received
                    round_end = float(ends.max())
                else:
                    round_end = float(tb.end_t.max()) if len(tb) else t
                # pass 2: sessions against the round deadline (cancel
                # stragglers)
                fb, ok2 = sampler.resolve_batch(pb, rounds, t,
                                                deadline=round_end,
                                                late_code=lc)
                log.log_batch(fb)
                n_ok = int(np.count_nonzero(ok2))
                contributors: List[int] = \
                    cohort[np.nonzero(ok2)[0][:goal]].tolist()
            else:
                # population-scale cohort: bounded-size chunks. Pass 1
                # keeps only the surviving end times (plans are re-derived
                # in pass 2 — plan/resolve are row-pure, so re-planning is
                # bit-identical to caching); the round close is a
                # partition, which is order-independent across chunks.
                ends_parts: List[np.ndarray] = []
                n_rows, max_end = 0, t
                for lo in range(0, len(cohort), _DISPATCH_CHUNK):
                    ch = cohort[lo:lo + _DISPATCH_CHUNK]
                    tb, ok = sampler.resolve_batch(
                        sampler.plan_batch(ch, rounds), rounds, t)
                    ends_parts.append(tb.end_t[ok])
                    if len(tb):
                        max_end = max(max_end, float(tb.end_t.max()))
                    n_rows += len(tb)
                ends = np.concatenate(ends_parts)
                if len(ends) >= goal:
                    round_end = float(np.partition(ends, goal - 1)[goal - 1])
                elif len(ends):
                    round_end = float(ends.max())
                else:
                    round_end = max_end if n_rows else t
                ok2_parts: List[np.ndarray] = []
                for lo in range(0, len(cohort), _DISPATCH_CHUNK):
                    ch = cohort[lo:lo + _DISPATCH_CHUNK]
                    fb, ok2c = sampler.resolve_batch(
                        sampler.plan_batch(ch, rounds), rounds, t,
                        deadline=round_end, late_code=lc)
                    log.log_batch(fb)
                    ok2_parts.append(ok2c)
                ok2 = np.concatenate(ok2_parts)
                n_ok = int(np.count_nonzero(ok2))
                contributors = cohort[np.nonzero(ok2)[0][:goal]].tolist()
            starved = n_ok < quorum
            t = round_end + _SERVER_AGG_S
            rounds += 1
            if not starved and contributors:
                ppl = _sync_server_update(learner, contributors)
                stop.update(ppl)
            log.log_round(t, starved=starved)
            log.log_eval(t, rounds, ppl, stop.smoothed or ppl)
            self._emit(on_round, log.n_sessions, rounds, t, ppl,
                       stop.smoothed or ppl)
            if starved:
                streak += 1
                if fed.starvation_patience \
                        and streak >= fed.starvation_patience:
                    stop.aborted = True
                    break
            else:
                streak = 0
            if stop.reached or stop.out_of_budget(t, rounds):
                break
        return t, rounds, ppl

    @staticmethod
    def _faulty_round(fed, sampler, log, cohort, rounds, t, goal,
                      late_code=None):
        """One sync round under a live fault and/or churn model: resolve
        the cohort with no deadline, chase failed AND interrupted slots
        through up to ``retry_limit`` re-dispatches (exponential backoff,
        distinct counter-keyed retry ids — every attempt is charged),
        close the round over ALL attempts' survivors, then patch the
        deadline in and log the blocks attempt-major. Checkpoint/resume:
        when ``checkpoint_period_s`` > 0 an interrupted attempt's retry
        redoes only the un-checkpointed remainder (its planned compute is
        scaled by the running ``rem`` fraction — see ``_retry_rem``).
        Cohorts resolve one-shot (no ``_DISPATCH_CHUNK`` pass — retry
        waves shrink geometrically, the cohort block dominates). Returns
        (n_ok, contributors, round_end)."""
        F, I = OUTCOME_CODE["failed"], OUTCOME_CODE["interrupted"]
        salv_on = sampler.has_avail and fed.retry_limit > 0 \
            and fed.checkpoint_period_s > 0
        pos = np.arange(len(cohort), dtype=np.int64)
        ids = cohort
        starts = t
        rem = np.ones(len(cohort))
        blocks = []
        for att in range(fed.retry_limit + 1):
            pb = sampler.plan_batch(ids, rounds)
            if salv_on and att:
                np.multiply(pb.compute_s, rem, out=pb.compute_s)
            fb, ok = sampler.resolve_batch(pb, rounds, starts)
            blocks.append((pb, fb, ok))
            fm = np.flatnonzero((fb.outcome == F) | (fb.outcome == I))
            if att == fed.retry_limit or not len(fm):
                break
            # failed/interrupted slots re-dispatch: a fresh client id off
            # the retry stream (keyed by cohort position + a round-scoped
            # attempt counter) after an exponential-backoff delay
            if salv_on:
                rem = _retry_rem(fb.outcome, pb.compute_s, fb.compute_s,
                                 rem, fed.checkpoint_period_s)[fm]
            pos = pos[fm]
            ids = retry_stream_ids(
                fed.seed, pos,
                np.full(len(pos), rounds * (fed.retry_limit + 1) + att + 1,
                        np.int64),
                _POPULATION)
            starts = fb.end_t[fm] + fed.retry_backoff_s * 2.0 ** att
        ok_ends = np.concatenate([fb.end_t[ok] for _, fb, ok in blocks])
        if len(ok_ends) >= goal:
            round_end = float(np.partition(ok_ends, goal - 1)[goal - 1])
        elif len(ok_ends):
            round_end = float(ok_ends.max())
        else:
            round_end = float(max(fb.end_t.max() for _, fb, _ in blocks))
        n_ok = 0
        contributors: List[int] = []
        for att, (pb, fb, ok) in enumerate(blocks):
            sampler.apply_deadline(pb, fb, ok, round_end,
                                   late_code=late_code)
            if att < fed.retry_limit:
                # a retry went out for every one of these failures
                # (interrupted rows keep their label — the outcome
                # taxonomy separates churn from the crash-retry path)
                fb.outcome[fb.outcome == F] = OUTCOME_CODE["retried"]
            log.log_batch(fb)
            n_ok += int(np.count_nonzero(ok))
            if len(contributors) < goal:
                sel = np.flatnonzero(ok)[:goal - len(contributors)]
                contributors.extend(fb.client_id[sel].tolist())
        return n_ok, contributors, round_end

    def lane_loop(self, pack: "_LanePack") -> None:
        """Lockstep lane-batched twin of ``_loop``: one plan/resolve pass
        covers every active lane's cohort (rows keyed per lane through
        ``LaneSampler``), the per-lane round close stays a partition on
        that lane's ``end_t`` slice, and learner/stopper bookkeeping runs
        per lane on scalars. Active lanes always share the lockstep round
        index ``k`` (every window closes exactly one round per lane), so
        ``round_idx`` stays a scalar in the sampler keys. Seed-for-seed
        identical to running each lane alone — cohort selection consumes
        each lane's own rng exactly as the serial loop does, and lanes
        share no other RNG state.

        Fault lanes ride the same lockstep: each retry wave is one batched
        plan/resolve over every lane's surviving failures (attempt-major,
        exactly the serial ``_faulty_round`` per lane), and quorum /
        starvation bookkeeping runs per lane on scalars."""
        lanes = pack.lanes
        rngs = [np.random.default_rng(f.seed + 1) for f in pack.feds]
        goals = [min(f.aggregation_goal, f.concurrency) for f in pack.feds]
        ndisp = [_sync_dispatch_n(f, goals[i])
                 for i, f in enumerate(pack.feds)]
        L = pack.n_lanes
        quorum = [max(1, int(np.ceil(f.min_report_fraction * goals[i])))
                  for i, f in enumerate(pack.feds)]
        retry_lim = np.asarray([f.retry_limit
                                if (s.has_faults or s.has_avail) else 0
                                for f, s in zip(pack.feds, lanes.samplers)],
                               np.int64)
        retry_bo = np.asarray([f.retry_backoff_s for f in pack.feds])
        any_faults = any(s.has_faults for s in lanes.samplers)
        # retry waves run when any lane chases failures (fault lanes
        # resolve one-shot even at retry 0, like the serial route) or
        # retries churn interruptions
        any_retry = any_faults or bool((retry_lim > 0).any())
        # per-lane checkpoint salvage (see serial _faulty_round)
        salv_P = np.asarray([f.checkpoint_period_s
                             if (s.has_avail and f.retry_limit > 0) else 0.0
                             for f, s in zip(pack.feds, lanes.samplers)])
        any_salv = bool((salv_P > 0).any())
        # per-lane late-straggler label (cancelled under over-selection)
        late_arr = np.asarray(
            [OUTCOME_CODE["cancelled"] if f.over_select_fraction > 0
             else OUTCOME_CODE["dropped"] for f in pack.feds], np.int8)
        any_osel = any(f.over_select_fraction > 0 for f in pack.feds)
        streak = np.zeros(L, np.int64)
        F, R = OUTCOME_CODE["failed"], OUTCOME_CODE["retried"]
        I = OUTCOME_CODE["interrupted"]
        k = 0                        # == every active lane's `rounds`
        while pack.active.any():
            act = np.flatnonzero(pack.active)
            cohorts = [_select_cohort(rngs[i], ndisp[i], _POPULATION)
                       for i in act]
            sizes = np.asarray([ndisp[i] for i in act], np.int64)
            offs = np.concatenate([[0], np.cumsum(sizes)])
            lane_row = np.repeat(act, sizes)
            start = pack.t[lane_row]
            ids = np.concatenate(cohorts)
            total = len(lane_row)
            # retry lanes resolve one-shot, like the serial fault path
            chunked = total > _DISPATCH_CHUNK and not any_retry
            if not chunked:
                pb, fb, ok = lanes.plan_resolve(lane_row, ids, k, start)
                blocks = [(lane_row, pb, fb, ok)]
                if any_retry:
                    # lockstep retry waves: wave a re-dispatches every
                    # lane's attempt-(a-1) failures AND interruptions in
                    # ONE batched resolve
                    prev_lane, prev_pb, prev_fb = lane_row, pb, fb
                    prev_pos = np.concatenate(
                        [np.arange(ndisp[i], dtype=np.int64) for i in act])
                    prev_rem = np.ones(total) if any_salv else None
                    att = 0
                    while True:
                        sel = np.flatnonzero(
                            ((prev_fb["outcome"] == F)
                             | (prev_fb["outcome"] == I))
                            & (retry_lim[prev_lane] > att))
                        att += 1
                        if not len(sel):
                            break
                        lane_r = prev_lane[sel]
                        pos_r = prev_pos[sel]
                        rem_r = None
                        if any_salv:
                            rem_r = _retry_rem(
                                prev_fb["outcome"], prev_pb.compute_s,
                                prev_fb["compute_s"], prev_rem,
                                salv_P[prev_lane])[sel]
                        ids_r = lanes.retry_stream_ids(
                            lane_r, pos_r,
                            k * (retry_lim[lane_r] + 1) + att, _POPULATION)
                        starts_r = prev_fb["end_t"][sel] \
                            + retry_bo[lane_r] * 2.0 ** (att - 1)
                        pb_r, fb_r, ok_r = lanes.plan_resolve(
                            lane_r, ids_r, k, starts_r, rem=rem_r)
                        blocks.append((lane_r, pb_r, fb_r, ok_r))
                        prev_lane, prev_pb, prev_fb = lane_r, pb_r, fb_r
                        prev_pos, prev_rem = pos_r, rem_r
                # per-block per-lane segment bounds (every block stays
                # lane-sorted: attempt 0 by construction, retry waves
                # because flatnonzero preserves the sorted row order)
                cuts = [np.append(np.searchsorted(lane_b, act), len(lane_b))
                        for lane_b, _, _, _ in blocks]
                round_end = np.empty(len(act))
                for j, i in enumerate(act):
                    oe = [fb_b["end_t"][cb[j]:cb[j + 1]]
                          [ok_b[cb[j]:cb[j + 1]]]
                          for (_, _, fb_b, ok_b), cb in zip(blocks, cuts)]
                    oe = oe[0] if len(oe) == 1 else np.concatenate(oe)
                    g = goals[i]
                    if len(oe) >= g:
                        round_end[j] = np.partition(oe, g - 1)[g - 1]
                    elif len(oe):
                        round_end[j] = oe.max()
                    else:
                        seg = np.concatenate(
                            [fb_b["end_t"][cb[j]:cb[j + 1]]
                             for (_, _, fb_b, _), cb in zip(blocks, cuts)])
                        round_end[j] = seg.max() if len(seg) else pack.t[i]
                # pass 2 of the serial loop collapses to a masked patch of
                # the stragglers (cancel-at-deadline); failures whose
                # retry went out relabel as "retried"; log attempt-major
                deadline_lane = np.empty(L)
                deadline_lane[act] = round_end
                for att_i, (lane_b, pb_b, fb_b, ok_b) in enumerate(blocks):
                    lanes.apply_deadline(
                        pb_b, fb_b, ok_b, deadline_lane[lane_b],
                        late_code=late_arr[lane_b] if any_osel else None)
                    if any_retry:
                        m = (fb_b["outcome"] == F) \
                            & (retry_lim[lane_b] > att_i)
                        fb_b["outcome"][m] = R
                    pack.acc.append(lane=lane_b, **fb_b)
                n_ok_lane = np.zeros(L, np.int64)
                rows_lane = np.zeros(L, np.int64)
                contrib: Dict[int, List[int]] = {int(i): [] for i in act}
                for (lane_b, _, fb_b, ok_b), cb in zip(blocks, cuts):
                    for j, i in enumerate(act):
                        sl = slice(int(cb[j]), int(cb[j + 1]))
                        okb = ok_b[sl]
                        n_ok_lane[i] += int(np.count_nonzero(okb))
                        rows_lane[i] += sl.stop - sl.start
                        got = contrib[int(i)]
                        if len(got) < goals[i]:
                            got.extend(fb_b["client_id"][sl][okb]
                                       [:goals[i] - len(got)].tolist())
            else:
                # population-scale pack: resolve in bounded chunks keeping
                # only end_t/ok for the round close; pass 2 re-plans
                # (row-pure, bit-identical — see the serial loop)
                et_parts, ok_parts = [], []
                for lo in range(0, total, _DISPATCH_CHUNK):
                    sc = slice(lo, lo + _DISPATCH_CHUNK)
                    _, fb_c, ok_c = lanes.plan_resolve(
                        lane_row[sc], ids[sc], k, start[sc])
                    et_parts.append(fb_c["end_t"])
                    ok_parts.append(ok_c)
                end_t = np.concatenate(et_parts)
                ok = np.concatenate(ok_parts)
                round_end = np.empty(len(act))
                for j, i in enumerate(act):
                    sl = slice(offs[j], offs[j + 1])
                    ends = end_t[sl][ok[sl]]
                    g = goals[i]
                    if len(ends) >= g:
                        round_end[j] = np.partition(ends, g - 1)[g - 1]
                    elif len(ends):
                        round_end[j] = ends.max()
                    else:
                        seg = end_t[sl]
                        round_end[j] = seg.max() if len(seg) else pack.t[i]
                deadline_rows = np.repeat(round_end, sizes)
                ok2_parts: List[np.ndarray] = []
                for lo in range(0, total, _DISPATCH_CHUNK):
                    sc = slice(lo, lo + _DISPATCH_CHUNK)
                    pb_c, fb_c, ok2_c = lanes.plan_resolve(
                        lane_row[sc], ids[sc], k, start[sc])
                    lanes.apply_deadline(
                        pb_c, fb_c, ok2_c, deadline_rows[sc],
                        late_code=(late_arr[lane_row[sc]]
                                   if any_osel else None))
                    pack.acc.append(lane=lane_row[sc], **fb_c)
                    ok2_parts.append(ok2_c)
                ok2 = np.concatenate(ok2_parts)
                n_ok_lane = np.zeros(L, np.int64)
                rows_lane = np.zeros(L, np.int64)
                contrib = {int(i): [] for i in act}
                for j, i in enumerate(act):
                    sl = slice(offs[j], offs[j + 1])
                    n_ok_lane[i] = int(np.count_nonzero(ok2[sl]))
                    rows_lane[i] = int(sizes[j])
                    contrib[int(i)] = cohorts[j][
                        np.flatnonzero(ok2[sl])[:goals[i]]].tolist()
            k += 1
            for j, i in enumerate(act):
                contributors = contrib[int(i)]
                starved = bool(n_ok_lane[i] < quorum[i])
                pack.t[i] = round_end[j] + _SERVER_AGG_S
                pack.rounds[i] = k
                stop = pack.stoppers[i]
                if not starved and contributors:
                    pack.ppl[i] = _sync_server_update(pack.learners[i],
                                                      contributors)
                    stop.update(pack.ppl[i])
                pack.n_logged[i] += int(rows_lane[i])
                pack.close_round(i, k, self.mode, starved=starved)
                if starved:
                    streak[i] += 1
                    if pack.feds[i].starvation_patience \
                            and streak[i] >= pack.feds[i].starvation_patience:
                        stop.aborted = True
                        pack.active[i] = False
                        continue
                else:
                    streak[i] = 0
                if stop.reached or stop.out_of_budget(pack.t[i], k):
                    pack.active[i] = False


# async pool fields that only the window close needs (the expansion phase
# works on slot/gen/end/ok alone, so these stay as per-generation blocks
# and are concatenated once per window)
_DEFERRED = ("cid", "ver", "start", "d", "c", "u", "bd", "bu",
             "dev", "ctry", "out")

# canonical in-flight column order (what `_async_rows` returns) — the
# engine-snapshot payload stores/restores the flight dict by these keys
_FLIGHT_FIELDS = ("slot", "gen", "cid", "ver", "start", "end", "d", "c",
                  "u", "bd", "bu", "dev", "ctry", "out", "ok", "att", "nrem")


def _async_rows(slots: np.ndarray, gens: np.ndarray, version: int,
                batch: SessionBatch, ok: np.ndarray,
                att: Optional[np.ndarray] = None,
                nrem: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """One column block of dispatched async sessions (slot + generation
    identify the session; everything else comes from ``resolve_batch``).
    ``att`` is the row's consecutive-failure retry counter (0 = a fresh
    dispatch, not a retry); ``nrem`` the remainder fraction this row's
    retry successor would redo (1.0 outside checkpoint/resume salvage —
    see ``_retry_rem``)."""
    n = len(ok)
    return dict(slot=np.asarray(slots, np.int64),
                gen=np.asarray(gens, np.int64),
                cid=batch.client_id,
                ver=np.full(n, version, np.int64),
                start=batch.start_t, end=batch.end_t,
                d=batch.download_s, c=batch.compute_s, u=batch.upload_s,
                bd=batch.bytes_down, bu=batch.bytes_up,
                dev=batch.device_idx, ctry=batch.country_idx,
                out=batch.outcome, ok=ok,
                att=(np.zeros(n, np.int64) if att is None
                     else np.asarray(att, np.int64)),
                nrem=(np.ones(n) if nrem is None
                      else np.asarray(nrem, np.float64)))


def _async_rows_cols(slots: np.ndarray, gens: np.ndarray, version: int,
                     cols: Dict[str, np.ndarray], ok: np.ndarray,
                     att: Optional[np.ndarray] = None,
                     nrem: Optional[np.ndarray] = None
                     ) -> Dict[str, np.ndarray]:
    """``_async_rows`` over a LaneSampler column dict instead of a
    SessionBatch (the lane-batched async loop's dispatch format)."""
    n = len(ok)
    return dict(slot=np.asarray(slots, np.int64),
                gen=np.asarray(gens, np.int64),
                cid=cols["client_id"],
                ver=np.full(n, version, np.int64),
                start=cols["start_t"], end=cols["end_t"],
                d=cols["download_s"], c=cols["compute_s"],
                u=cols["upload_s"],
                bd=cols["bytes_down"], bu=cols["bytes_up"],
                dev=cols["device_idx"], ctry=cols["country_idx"],
                out=cols["outcome"], ok=ok,
                att=(np.zeros(n, np.int64) if att is None
                     else np.asarray(att, np.int64)),
                nrem=(np.ones(n) if nrem is None
                      else np.asarray(nrem, np.float64)))


def _truncate_cancelled(flight: Dict[str, np.ndarray], idx: np.ndarray,
                        t_final: float) -> Dict[str, np.ndarray]:
    """In-flight sessions at task end: truncate the burned phases at the
    final task clock (a device stops the moment the task is torn down),
    prorate downlink bytes to the downloaded fraction, and zero uplink
    bytes (the result never reached the server). Mirrored scalar-ly by the
    reference oracle's flush — keep the two numerically identical."""
    d, c, u = flight["d"][idx], flight["c"][idx], flight["u"][idx]
    cap = np.maximum(0.0, t_final - flight["start"][idx])
    nd = np.minimum(d, cap)
    nc = np.minimum(c, np.maximum(0.0, cap - d))
    nu = np.minimum(u, np.maximum(0.0, cap - d - c))
    frac = np.divide(nd, d, out=np.zeros(len(idx)), where=d > 0)
    # a pending retry may be scheduled past the task end (backoff delay):
    # it burned nothing, but never let end_t precede start_t
    return dict(download_s=nd, compute_s=nc, upload_s=nu,
                bytes_down=flight["bd"][idx] * frac,
                bytes_up=np.zeros(len(idx)),
                end_t=np.minimum(flight["end"][idx],
                                 np.maximum(t_final, flight["start"][idx])))


@register_strategy("async")
class AsyncStrategy(Strategy):
    """FedBuff: always-`concurrency` in-flight clients, buffer size =
    aggregation_goal, staleness-weighted aggregation — vectorized as a
    window-batched exact merge (no event heap).

    Two facts make the merge exact:

    * arrivals are globally sorted by ``(end_t, slot, generation)``: every
      dispatch happens at the then-current clock, so a replacement's end
      never precedes its predecessor's — the old heap's pop order IS this
      sort order;
    * replacement *identity* is decoupled from pop *rank*: slot s draws
      its g-th replacement id from a counter-based splitmix64 stream
      (``slot_stream_ids``), so chained replacements inside a window can
      be planned/resolved as arrays without knowing global arrival order
      first (the circularity that previously forced per-pop dispatch).

    Each window (the span between two server updates) resolves all
    candidate arrivals columnar-ly, finds the update boundary with a
    cumsum over ok flags (the ``aggregation_goal``-th ok arrival), and
    expands chained replacements generation-by-generation until no
    undiscovered arrival precedes the boundary. A speculative chain row
    can never move the boundary wrongly: any row with key <= boundary has
    its whole ancestor chain at strictly smaller keys, so the ancestors
    all pop and the row is validly dispatched. Sessions still in flight
    when the task ends are logged as ``cancelled``, truncated at the
    final clock.
    """

    # ------------------------------------------------------ dispatch hooks
    # Replacement *identity* is the one policy axis subclasses may bend
    # without touching the window merge: ids must stay a pure function of
    # (seed, slot, generation, dispatch clock, model version) — never of
    # global arrival order — so the merge, the lane engine and the scalar
    # oracle keep replaying the same draws. The carbon-aware strategy
    # overrides these to screen candidates by grid intensity.
    # ``skip`` marks rows whose ids the caller overwrites right after the
    # call (the retry stream) — strategies with expensive screening use it
    # to avoid paying for picks that are discarded. The cheap counter
    # streams ignore it (masking would cost more than the draw).
    def _replacement_ids(self, sampler: SessionSampler, fed: FederatedConfig,
                         slots: np.ndarray, gens: np.ndarray,
                         starts: np.ndarray, version: int,
                         skip: Optional[np.ndarray] = None) -> np.ndarray:
        return slot_stream_ids(fed.seed, slots, gens, _POPULATION)

    def _lane_replacement_ids(self, pack: "_LanePack", lane: np.ndarray,
                              slots: np.ndarray, gens: np.ndarray,
                              starts: np.ndarray, version: int,
                              skip: Optional[np.ndarray] = None
                              ) -> np.ndarray:
        return pack.lanes.slot_stream_ids(lane, slots, gens, _POPULATION)

    def _loop(self, model_cfg, fed, learner, sampler, log, stop, on_round):
        assert fed.mode == self.mode
        rng = np.random.default_rng(fed.seed + 2)
        conc = fed.concurrency
        goal = fed.aggregation_goal
        t = 0.0
        version = 0
        ppl = float(model_cfg.vocab_size)
        max_t = stop.run.max_hours * 3600.0
        acc = self._make_sink(log, sampler.device_names,
                              sampler.country_names)
        # recovery policy: failed AND churn-interrupted rows chain a RETRY
        # successor (distinct id stream, exponential backoff, attempt
        # counter up) instead of a fresh replacement; `att` rides the
        # flight/expansion columns. Checkpoint/resume: an interrupted
        # row's retry redoes only the un-checkpointed remainder (`nrem`
        # rides along — see ``_retry_rem``).
        retry_on = (sampler.has_faults or sampler.has_avail) \
            and fed.retry_limit > 0
        salv_on = retry_on and sampler.has_avail \
            and fed.checkpoint_period_s > 0
        F, R = OUTCOME_CODE["failed"], OUTCOME_CODE["retried"]
        I = OUTCOME_CODE["interrupted"]

        snap = getattr(self, "_snap", None)
        if snap is not None and snap.engine_state is not None:
            # resume at a window boundary: the flight columns + scalars
            # are the whole loop state (the init RNG below this point is
            # never consumed again, and every later draw is counter-keyed)
            es = snap.engine_state
            t = float(es["t"])
            version = int(es["version"])
            ppl = float(es["ppl"])
            alive = np.asarray(es["alive"], bool).copy()
            flight = {f: np.asarray(es["flight_" + f]).copy()
                      for f in _FLIGHT_FIELDS}
            sb = snap.sink_batch()
            if sb is not None and acc is not log:
                # pre-checkpoint pops re-enter the staging sink (streaming
                # folds were restored into the log itself by Strategy.run)
                acc.append(client_id=sb.client_id, round_idx=sb.round_idx,
                           device_idx=sb.device_idx,
                           country_idx=sb.country_idx,
                           download_s=sb.download_s, compute_s=sb.compute_s,
                           upload_s=sb.upload_s, bytes_down=sb.bytes_down,
                           bytes_up=sb.bytes_up, start_t=sb.start_t,
                           end_t=sb.end_t, outcome=sb.outcome,
                           staleness=sb.staleness)
        else:
            # initial cohort: batched plan/resolve with jittered starts, in
            # bounded chunks at population scale (row-pure, so chunking is
            # bit-identical); slot s starts out running cohort[s] at
            # generation 0
            cohort = _select_cohort(rng, conc, population=_POPULATION)
            starts0 = rng.uniform(0, 5.0, size=conc)
            flight: Optional[Dict[str, np.ndarray]] = None
            for lo in range(0, conc, _DISPATCH_CHUNK):
                sc = slice(lo, min(lo + _DISPATCH_CHUNK, conc))
                pb0 = sampler.plan_batch(cohort[sc], version)
                b0, ok0 = sampler.resolve_batch(pb0, version, starts0[sc])
                nr0 = _retry_rem(b0.outcome, pb0.compute_s, b0.compute_s,
                                 np.ones(len(ok0)), fed.checkpoint_period_s) \
                    if salv_on else None
                rows = _async_rows(
                    np.arange(sc.start, sc.stop, dtype=np.int64),
                    np.zeros(sc.stop - sc.start, np.int64),
                    version, b0, ok0, nrem=nr0)
                if flight is None and conc <= _DISPATCH_CHUNK:
                    flight = rows
                    break
                if flight is None:
                    flight = {f: np.empty(conc, a.dtype)
                              for f, a in rows.items()}
                for f, a in rows.items():
                    flight[f][sc] = a
            alive = np.ones(conc, bool)

        while True:
            if t >= max_t or version >= stop.run.max_rounds:
                break
            if snap is not None:
                snap.tick(version, lambda: (
                    dict(t=t, version=version, ppl=ppl, alive=alive,
                         **{"flight_" + f: flight[f]
                            for f in _FLIGHT_FIELDS}),
                    None if acc is log else acc),
                    log, learner, stop)
            t0 = t
            # ---- expansion phase: discover this window's arrivals -------
            # Chains are expanded against a cheap upper bound on the window
            # end — the goal-th smallest ok end (a partition, not a sort)
            # and/or the first end at/past the time budget. The bound only
            # tightens as rows join, so "every unexpanded row sits past the
            # bound" is a sound fixed point; the single exact lexsort below
            # then settles the boundary.
            slot_all, gen_all = flight["slot"], flight["gen"]
            end_all, ok_all = flight["end"], flight["ok"]
            att_all = flight["att"]
            nrem_all = flight["nrem"]
            out_run = flight["out"] if retry_on else None
            parts: Dict[str, List[np.ndarray]] = \
                {f: [flight[f]] for f in _DEFERRED}
            succ = np.full(conc, -1, np.int64)   # row -> successor row
            n_rows = conc
            while True:
                bound = np.inf
                if int(np.count_nonzero(ok_all)) >= goal:
                    bound = float(np.partition(end_all[ok_all],
                                               goal - 1)[goal - 1])
                over = end_all[end_all >= max_t]
                if len(over):
                    # the budget check runs before each pop against the
                    # PREVIOUS arrival's clock, so the first arrival at/past
                    # max_t still pops before the loop stops
                    bound = min(bound, float(over.min()))
                frontier = succ < 0
                if not np.isinf(bound):
                    frontier &= end_all <= bound
                    if not frontier.any():
                        break
                need = np.nonzero(frontier)[0]
                slots_n = slot_all[need]
                gens_n = gen_all[need] + 1
                starts_n = np.maximum(t0, end_all[need])
                if retry_on:
                    prev_att = att_all[need]
                    rf = ((out_run[need] == F) | (out_run[need] == I)) \
                        & (prev_att < fed.retry_limit)
                    att_n = np.where(rf, prev_att + 1, 0)
                    starts_n = starts_n + np.where(
                        rf, fed.retry_backoff_s * 2.0 ** prev_att, 0.0)
                else:
                    att_n = np.zeros(len(need), np.int64)
                ids_n = self._replacement_ids(
                    sampler, fed, slots_n, gens_n, starts_n, version,
                    skip=rf if retry_on else None)
                if retry_on and rf.any():
                    ids_n[rf] = retry_stream_ids(fed.seed, slots_n[rf],
                                                 gens_n[rf], _POPULATION)
                pb_n = sampler.plan_batch(ids_n, version)
                rem_n = None
                if salv_on:
                    # retry children redo their parent's remainder only
                    rem_n = np.where(rf, nrem_all[need], 1.0)
                    np.multiply(pb_n.compute_s, rem_n, out=pb_n.compute_s)
                bn, okn = sampler.resolve_batch(pb_n, version, starts_n)
                nrem_n = _retry_rem(bn.outcome, pb_n.compute_s,
                                    bn.compute_s, rem_n,
                                    fed.checkpoint_period_s) \
                    if salv_on else None
                succ[need] = n_rows + np.arange(len(need))
                n_rows += len(need)
                succ = np.concatenate(
                    [succ, np.full(len(need), -1, np.int64)])
                slot_all = np.concatenate([slot_all, slots_n])
                gen_all = np.concatenate([gen_all, gens_n])
                end_all = np.concatenate([end_all, bn.end_t])
                ok_all = np.concatenate([ok_all, okn])
                att_all = np.concatenate([att_all, att_n])
                new = _async_rows(slots_n, gens_n, version, bn, okn, att_n,
                                  nrem=nrem_n)
                nrem_all = np.concatenate([nrem_all, new["nrem"]])
                for f in _DEFERRED:
                    parts[f].append(new[f])
                if retry_on:
                    out_run = np.concatenate([out_run, new["out"]])
            # ---- exact close: one lexsort settles the boundary ----------
            order = np.lexsort((gen_all, slot_all, end_all))
            ends_sorted = end_all[order]
            cum = np.cumsum(ok_all[order])
            b_pos = int(np.searchsorted(cum, goal)) \
                if cum[-1] >= goal else -1
            cut = int(np.searchsorted(ends_sorted, max_t, side="left"))
            if 0 <= b_pos <= cut:
                pops_to, closes = b_pos, "update"
            else:
                pops_to, closes = cut, "budget"   # cut < n_rows: bound was
            pop_idx = order[:pops_to + 1]         # finite via max_t
            # every pop precedes the bound, so its chain was expanded
            assert succ[pop_idx].min() >= 0
            A = {"slot": slot_all, "gen": gen_all,
                 "end": end_all, "ok": ok_all, "att": att_all,
                 "nrem": nrem_all,
                 **{f: np.concatenate(p) if len(p) > 1 else p[0]
                    for f, p in parts.items()}}
            # ---- log pops, advance per-slot chains ----------------------
            okm = A["ok"][pop_idx]
            out_p = A["out"][pop_idx]
            if retry_on:
                # label at LOG time only (parts blocks alias the flight
                # arrays): a failed pop with attempt budget left had a
                # retry successor scheduled -> "retried"
                out_p = np.where((out_p == F)
                                 & (A["att"][pop_idx] < fed.retry_limit),
                                 R, out_p)
            acc.append(client_id=A["cid"][pop_idx],
                       round_idx=A["ver"][pop_idx],
                       device_idx=A["dev"][pop_idx],
                       country_idx=A["ctry"][pop_idx],
                       download_s=A["d"][pop_idx],
                       compute_s=A["c"][pop_idx],
                       upload_s=A["u"][pop_idx],
                       bytes_down=A["bd"][pop_idx],
                       bytes_up=A["bu"][pop_idx],
                       start_t=A["start"][pop_idx],
                       end_t=A["end"][pop_idx],
                       outcome=out_p,
                       staleness=version - A["ver"][pop_idx])
            # per-slot chain tip among the pops -> its successor goes
            # in-flight (fancy-index write is made unique by the tip mask)
            sl, gn = A["slot"][pop_idx], A["gen"][pop_idx]
            best = np.full(conc, -1, np.int64)
            np.maximum.at(best, sl, gn)
            is_tip = gn == best[sl]
            tip_slots = sl[is_tip]
            repl_rows = succ[pop_idx[is_tip]]
            for f in flight:
                flight[f][tip_slots] = A[f][repl_rows]
            if closes == "budget":
                t = max(t0, float(ends_sorted[pops_to]))
                break
            # ---- server update at the boundary arrival ------------------
            b_row = int(pop_idx[-1])
            vers_ok = A["ver"][pop_idx][okm]
            ppl = _async_server_update(learner, A["cid"][pop_idx][okm],
                                       vers_ok, version)
            version += 1
            t = max(t0, float(A["end"][b_row])) + _SERVER_AGG_S
            stop.update(ppl)
            log.log_round(t)
            log.log_eval(t, version, ppl, stop.smoothed or ppl)
            self._emit(on_round, len(acc), version, t, ppl,
                       stop.smoothed or ppl)
            b_slot = int(A["slot"][b_row])
            if stop.reached or stop.out_of_budget(t, version):
                alive[b_slot] = False   # its replacement never went out
                break
            # the boundary slot's replacement goes out AFTER the update,
            # against the new model version (the plain async stream id is
            # version-independent; a carbon-aware pick may differ from the
            # speculative expansion row, which is overwritten here anyway)
            b_gen = int(A["gen"][b_row]) + 1
            nid = self._replacement_ids(sampler, fed,
                                        np.asarray([b_slot], np.int64),
                                        np.asarray([b_gen], np.int64),
                                        np.asarray([t]), version)
            pb_b1 = sampler.plan_batch(nid, version)
            b1, okb = sampler.resolve_batch(pb_b1, version, t)
            nrem_b = _retry_rem(b1.outcome, pb_b1.compute_s, b1.compute_s,
                                np.ones(1), fed.checkpoint_period_s) \
                if salv_on else None
            row = _async_rows(np.asarray([b_slot], np.int64),
                              np.asarray([b_gen], np.int64), version, b1,
                              okb, nrem=nrem_b)
            for f in flight:
                flight[f][b_slot] = row[f][0]

        # ---- task end: in-flight sessions are logged as cancelled -------
        idx = np.nonzero(alive)[0]
        if len(idx):
            acc.append(client_id=flight["cid"][idx],
                       round_idx=flight["ver"][idx],
                       device_idx=flight["dev"][idx],
                       country_idx=flight["ctry"][idx],
                       start_t=flight["start"][idx],
                       outcome=np.full(len(idx), OUTCOME_CODE["cancelled"],
                                       np.int8),
                       staleness=version - flight["ver"][idx],
                       **_truncate_cancelled(flight, idx, t))
        self._flush_sink(log, acc)
        return t, version, ppl

    def lane_loop(self, pack: "_LanePack") -> None:
        """Lockstep lane-batched twin of ``_loop``: every iteration closes
        one window (one server update) per active lane. The per-lane flight
        state lives in one concatenated array store (``offsets`` maps lane
        -> slot block); the expansion fixed point interleaves all lanes'
        chain discovery so each inner iteration issues ONE batched
        plan/resolve for every lane's frontier, and the post-update
        boundary redispatches batch into a single L-row call — the two
        per-window fixed costs that dominate small-concurrency sweeps.
        Per-lane bounds/lexsort/boundary bookkeeping are unchanged from the
        serial loop, just applied to lane slices, so the merge stays exact
        per lane. Active lanes always share the lockstep version ``k``."""
        lanes = pack.lanes
        feds = pack.feds
        L = pack.n_lanes
        concs = np.asarray([f.concurrency for f in feds], np.int64)
        goals = [f.aggregation_goal for f in feds]
        offsets = np.concatenate([[0], np.cumsum(concs)])
        max_ts = [r.max_hours * 3600.0 for r in pack.runs]
        max_rounds = [r.max_rounds for r in pack.runs]
        # per-lane recovery policy (0 disables; see serial `_loop`)
        retry_lim = np.asarray(
            [f.retry_limit if (s.has_faults or s.has_avail) else 0
             for f, s in zip(feds, lanes.samplers)], np.int64)
        retry_bo = np.asarray([f.retry_backoff_s for f in feds])
        retry_on = bool((retry_lim > 0).any())
        # per-lane checkpoint salvage (see serial `_loop`)
        lane_P = np.asarray(
            [f.checkpoint_period_s
             if (s.has_avail and f.retry_limit > 0) else 0.0
             for f, s in zip(feds, lanes.samplers)])
        any_salv = bool((lane_P > 0).any())
        F, R = OUTCOME_CODE["failed"], OUTCOME_CODE["retried"]
        I = OUTCOME_CODE["interrupted"]
        # ---- initial cohorts: one batched resolve across all lanes ------
        rngs = [np.random.default_rng(f.seed + 2) for f in feds]
        cohorts, starts0 = [], []
        for i, f in enumerate(feds):
            cohorts.append(_select_cohort(rngs[i], f.concurrency,
                                          _POPULATION))
            starts0.append(rngs[i].uniform(0, 5.0, size=f.concurrency))
        lane_of = np.repeat(np.arange(L, dtype=np.intp), concs)
        slot_of = np.concatenate(
            [np.arange(c, dtype=np.int64) for c in concs])
        ids0 = np.concatenate(cohorts)
        st0 = np.concatenate(starts0)
        n_slots = len(slot_of)
        if n_slots <= _DISPATCH_CHUNK:
            pb0, b0, ok0 = lanes.plan_resolve(lane_of, ids0, 0, st0)
            nr0 = _retry_rem(b0["outcome"], pb0.compute_s, b0["compute_s"],
                             np.ones(n_slots), lane_P[lane_of]) \
                if any_salv else None
            flight = _async_rows_cols(slot_of,
                                      np.zeros(n_slots, np.int64),
                                      0, b0, ok0, nrem=nr0)
        else:
            # population-scale pack: bounded-chunk dispatch (row-pure,
            # bit-identical to the one-shot resolve)
            flight = None
            for lo in range(0, n_slots, _DISPATCH_CHUNK):
                sc = slice(lo, min(lo + _DISPATCH_CHUNK, n_slots))
                pb0, b0, ok0 = lanes.plan_resolve(lane_of[sc], ids0[sc], 0,
                                                  st0[sc])
                nr0 = _retry_rem(b0["outcome"], pb0.compute_s,
                                 b0["compute_s"],
                                 np.ones(sc.stop - sc.start),
                                 lane_P[lane_of[sc]]) \
                    if any_salv else None
                rows = _async_rows_cols(slot_of[sc],
                                        np.zeros(sc.stop - sc.start,
                                                 np.int64), 0, b0, ok0,
                                        nrem=nr0)
                if flight is None:
                    flight = {f: np.empty(n_slots, a.dtype)
                              for f, a in rows.items()}
                for f, a in rows.items():
                    flight[f][sc] = a
        alive = np.ones(int(offsets[-1]), bool)
        k = 0                        # == every active lane's `version`

        def _flush_cancelled(i: int, t_final: float, version_i: int) -> None:
            """Lane i is done: log its in-flight slots as cancelled
            (truncated at its final clock) and deactivate it."""
            lo, hi = int(offsets[i]), int(offsets[i + 1])
            idx = lo + np.flatnonzero(alive[lo:hi])
            if len(idx):
                pack.acc.append(lane=np.full(len(idx), i, np.int32),
                                client_id=flight["cid"][idx],
                                round_idx=flight["ver"][idx],
                                device_idx=flight["dev"][idx],
                                country_idx=flight["ctry"][idx],
                                start_t=flight["start"][idx],
                                outcome=np.full(len(idx),
                                                OUTCOME_CODE["cancelled"],
                                                np.int8),
                                staleness=version_i - flight["ver"][idx],
                                **_truncate_cancelled(flight, idx, t_final))
                pack.n_logged[i] += len(idx)
            pack.active[i] = False

        while True:
            for i in np.flatnonzero(pack.active):
                if pack.t[i] >= max_ts[i] or k >= max_rounds[i]:
                    _flush_cancelled(i, float(pack.t[i]), k)
            act = np.flatnonzero(pack.active)
            if not len(act):
                break
            t0 = pack.t.copy()
            # ---- expansion: all active lanes' windows discover at once --
            rows_idx = np.concatenate(
                [np.arange(offsets[i], offsets[i + 1]) for i in act])
            win_lane = lane_of[rows_idx]
            slot_all = flight["slot"][rows_idx]
            gen_all = flight["gen"][rows_idx]
            end_all = flight["end"][rows_idx]
            ok_all = flight["ok"][rows_idx]
            att_all = flight["att"][rows_idx]
            nrem_all = flight["nrem"][rows_idx]
            out_run = flight["out"][rows_idx] if retry_on else None
            parts: Dict[str, List[np.ndarray]] = \
                {f: [flight[f][rows_idx]] for f in _DEFERRED}
            succ = np.full(len(rows_idx), -1, np.int64)
            n_rows = len(rows_idx)
            # Expansion bounds are SOUND, not tight: a lane's bound only
            # has to sit at/above its final boundary, because rows beyond
            # the boundary are speculative — never popped, never logged,
            # never in flight (only popped tips' successors survive). So
            # unlike the serial loop, the goal-bound partition runs ONCE
            # per lane per window (not per inner iteration) over the rows
            # present at computation time — it can only be looser than the
            # serial re-tightened bound, trading a few extra speculative
            # resolves (batched, cheap) for per-lane Python (expensive at
            # lane-pack scale). Lanes below goal recheck as arrivals join;
            # the over-budget fallback min updates vectorized.
            goal_bound = np.full(L, np.inf)
            over_min = np.full(L, np.inf)
            max_t_arr = np.asarray(max_ts)
            goals_arr = np.asarray(goals, np.int64)
            n_ok_lane = np.bincount(win_lane[ok_all], minlength=L)
            ov0 = end_all >= max_t_arr[win_lane]
            if ov0.any():
                np.minimum.at(over_min, win_lane[ov0], end_all[ov0])
            below: List[int] = []
            pos = 0
            for i in act:
                sl = slice(pos, pos + int(concs[i]))
                pos += int(concs[i])
                if n_ok_lane[i] >= goals[i]:
                    e_i, o_i = end_all[sl], ok_all[sl]
                    goal_bound[i] = np.partition(e_i[o_i],
                                                 goals[i] - 1)[goals[i] - 1]
                else:
                    below.append(i)
            unexp = np.arange(n_rows, dtype=np.int64)
            while True:
                if below:
                    for i in list(below):
                        if n_ok_lane[i] >= goals[i]:
                            m_i = win_lane == i
                            e_i = end_all[m_i]
                            goal_bound[i] = np.partition(
                                e_i[ok_all[m_i]],
                                goals[i] - 1)[goals[i] - 1]
                            below.remove(i)
                bound_row = np.minimum(goal_bound,
                                       over_min)[win_lane[unexp]]
                m = end_all[unexp] <= bound_row   # inf bound passes all
                need = unexp[m]
                if not len(need):
                    break
                unexp = unexp[~m]
                lanes_n = win_lane[need]
                slots_n = slot_all[need]
                gens_n = gen_all[need] + 1
                starts_n = np.maximum(t0[lanes_n], end_all[need])
                if retry_on:
                    prev_att = att_all[need]
                    rf = ((out_run[need] == F) | (out_run[need] == I)) \
                        & (prev_att < retry_lim[lanes_n])
                    att_n = np.where(rf, prev_att + 1, 0)
                    starts_n = starts_n + np.where(
                        rf, retry_bo[lanes_n] * 2.0 ** prev_att, 0.0)
                else:
                    att_n = np.zeros(len(need), np.int64)
                ids_n = self._lane_replacement_ids(
                    pack, lanes_n, slots_n, gens_n, starts_n, k,
                    skip=rf if retry_on else None)
                if retry_on and rf.any():
                    ids_n[rf] = lanes.retry_stream_ids(
                        lanes_n[rf], slots_n[rf], gens_n[rf], _POPULATION)
                rem_n = None
                if any_salv:
                    # retry children redo their parent's remainder only
                    rem_n = np.where(rf, nrem_all[need], 1.0)
                pb_n, bn, okn = lanes.plan_resolve(lanes_n, ids_n, k,
                                                   starts_n, rem=rem_n)
                nrem_n = _retry_rem(bn["outcome"], pb_n.compute_s,
                                    bn["compute_s"], rem_n,
                                    lane_P[lanes_n]) \
                    if any_salv else None
                end_n = bn["end_t"]
                succ[need] = n_rows + np.arange(len(need))
                unexp = np.concatenate(
                    [unexp, np.arange(n_rows, n_rows + len(need),
                                      dtype=np.int64)])
                n_rows += len(need)
                succ = np.concatenate(
                    [succ, np.full(len(need), -1, np.int64)])
                win_lane = np.concatenate([win_lane, lanes_n])
                slot_all = np.concatenate([slot_all, slots_n])
                gen_all = np.concatenate([gen_all, gens_n])
                end_all = np.concatenate([end_all, end_n])
                ok_all = np.concatenate([ok_all, okn])
                att_all = np.concatenate([att_all, att_n])
                new = _async_rows_cols(slots_n, gens_n, k, bn, okn, att_n,
                                       nrem=nrem_n)
                nrem_all = np.concatenate([nrem_all, new["nrem"]])
                for f in _DEFERRED:
                    parts[f].append(new[f])
                if retry_on:
                    out_run = np.concatenate([out_run, new["out"]])
                if below:
                    n_ok_lane = n_ok_lane + np.bincount(lanes_n[okn],
                                                        minlength=L)
                ov = end_n >= max_t_arr[lanes_n]
                if ov.any():
                    np.minimum.at(over_min, lanes_n[ov], end_n[ov])
            # ---- per-lane exact close (unchanged serial logic on slices)
            A = {"slot": slot_all, "gen": gen_all,
                 "end": end_all, "ok": ok_all, "att": att_all,
                 "nrem": nrem_all,
                 **{f: np.concatenate(p) if len(p) > 1 else p[0]
                    for f, p in parts.items()}}
            # ONE lexsort settles every lane's boundary: keying by (lane,
            # end, slot, gen) makes each lane's segment contiguous AND
            # internally sorted exactly like the serial per-lane lexsort
            # ((slot, gen) is unique within a lane); a global cumsum then
            # gives each lane's ok-count prefix via one base subtraction
            order = np.lexsort((gen_all, slot_all, end_all, win_lane))
            lane_sorted = win_lane[order]
            ends_s = end_all[order]
            cum_pad = np.concatenate(([0], np.cumsum(ok_all[order])))
            seg = np.searchsorted(lane_sorted, act, side="left")
            seg = np.append(seg, len(lane_sorted))
            # vectorized boundary search: the global ok-cumsum is monotone,
            # so one searchsorted per window finds every lane's goal-th ok
            # arrival (b_pos), with per-lane bases read off the segment
            # starts
            bases = cum_pad[seg[:-1]]
            tot_ok = cum_pad[seg[1:]] - bases
            b_glob = np.searchsorted(cum_pad[1:], bases + goals_arr[act])
            pops_to_arr = np.empty(len(act), np.int64)
            closes_upd = np.zeros(len(act), bool)
            for j, i in enumerate(act):
                lo = int(seg[j])
                b_pos = int(b_glob[j]) - lo if tot_ok[j] >= goals[i] else -1
                cut = int(np.searchsorted(ends_s[lo:int(seg[j + 1])],
                                          max_ts[i], side="left"))
                if 0 <= b_pos <= cut:
                    pops_to_arr[j], closes_upd[j] = b_pos, True
                else:
                    pops_to_arr[j] = cut
            # one batched gather serves the tip updates, the log append
            # and the per-lane server updates (views into the pop block)
            pop_parts = [order[int(seg[j]):int(seg[j]) + int(p) + 1]
                         for j, p in enumerate(pops_to_arr)]
            pops = np.concatenate(pop_parts) \
                if len(pop_parts) > 1 else pop_parts[0]
            sizes_p = np.asarray([len(p) for p in pop_parts])
            offs_p = np.concatenate([[0], np.cumsum(sizes_p)])
            pop_lane_rep = np.repeat(act, sizes_p)
            # every pop precedes its lane's bound, so its chain expanded
            assert succ[pops].min() >= 0
            ok_p = A["ok"][pops]
            ver_p = A["ver"][pops]
            cid_p = A["cid"][pops]
            end_p = A["end"][pops]
            slot_p = A["slot"][pops]
            gen_p = A["gen"][pops]
            # per-slot chain tips (slots disjoint across lanes, so one
            # global maximum.at replaces L per-lane passes) -> successors
            # go in flight before the cancelled flushes read it
            slots_glob = offsets[pop_lane_rep] + slot_p
            best = np.full(int(offsets[-1]), -1, np.int64)
            np.maximum.at(best, slots_glob, gen_p)
            is_tip = gen_p == best[slots_glob]
            tip_rows = slots_glob[is_tip]
            repl_rows = succ[pops[is_tip]]
            for f in flight:
                flight[f][tip_rows] = A[f][repl_rows]
            # one batched append logs every lane's pops for this window
            # (within-lane order is pop order, which is all that matters);
            # cancelled flushes follow so a closing lane's store order
            # stays pops-then-cancelled like the serial loop's
            out_p = A["out"][pops]
            if retry_on:
                # relabel on the fancy-index copy only (see serial `_loop`)
                out_p = np.where((out_p == F)
                                 & (A["att"][pops]
                                    < retry_lim[pop_lane_rep]),
                                 R, out_p)
            pack.acc.append(lane=pop_lane_rep,
                            client_id=cid_p,
                            round_idx=ver_p,
                            device_idx=A["dev"][pops],
                            country_idx=A["ctry"][pops],
                            download_s=A["d"][pops],
                            compute_s=A["c"][pops],
                            upload_s=A["u"][pops],
                            bytes_down=A["bd"][pops],
                            bytes_up=A["bu"][pops],
                            start_t=A["start"][pops],
                            end_t=end_p,
                            outcome=out_p,
                            staleness=k - ver_p)
            redis: List[Tuple[int, int, int]] = []   # (lane, slot, gen)
            flush_q: List[Tuple[int, float, int]] = []
            for j, i in enumerate(act):
                sl = slice(int(offs_p[j]), int(offs_p[j + 1]))
                pack.n_logged[i] += sl.stop - sl.start
                if not closes_upd[j]:
                    pack.t[i] = max(float(t0[i]), float(end_p[sl.stop - 1]))
                    flush_q.append((i, float(pack.t[i]), k))
                    continue
                # ---- server update at the boundary arrival --------------
                okm = ok_p[sl]
                vers_ok = ver_p[sl][okm]
                pack.ppl[i] = _async_server_update(
                    pack.learners[i], cid_p[sl][okm], vers_ok, k)
                pack.t[i] = max(float(t0[i]),
                                float(end_p[sl.stop - 1])) + _SERVER_AGG_S
                stop = pack.stoppers[i]
                stop.update(pack.ppl[i])
                pack.rounds[i] = k + 1
                pack.close_round(i, k + 1, self.mode)
                b_slot = int(slot_p[sl.stop - 1])
                if stop.reached or stop.out_of_budget(pack.t[i], k + 1):
                    alive[int(offsets[i]) + b_slot] = False
                    flush_q.append((i, float(pack.t[i]), k + 1))
                    continue
                redis.append((i, b_slot, int(gen_p[sl.stop - 1]) + 1))
            for i, t_fin, ver_fin in flush_q:
                _flush_cancelled(i, t_fin, ver_fin)
            # ---- boundary slots redispatch after the update, batched ----
            if redis:
                rl = np.asarray([r[0] for r in redis], np.intp)
                rs = np.asarray([r[1] for r in redis], np.int64)
                rg = np.asarray([r[2] for r in redis], np.int64)
                nid = self._lane_replacement_ids(pack, rl, rs, rg,
                                                 pack.t[rl], k + 1)
                pb_b, bb, okb = lanes.plan_resolve(rl, nid, k + 1,
                                                   pack.t[rl])
                nrem_b = _retry_rem(bb["outcome"], pb_b.compute_s,
                                    bb["compute_s"], np.ones(len(rl)),
                                    lane_P[rl]) if any_salv else None
                row = _async_rows_cols(rs, rg, k + 1, bb, okb, nrem=nrem_b)
                fl_rows = offsets[rl] + rs
                for f in flight:
                    flight[f][fl_rows] = row[f]
            k += 1


# ---------------------------------------------------------------------------
# Carbon-aware selection (CAFE-style time/geo shifting)
# ---------------------------------------------------------------------------

_CARBON_PROBES = 8   # candidate ids screened per dispatch


def carbon_pick_ids(sampler: SessionSampler, intensity, fed: FederatedConfig,
                    slots: np.ndarray, gens: np.ndarray,
                    starts, version: int,
                    skip: Optional[np.ndarray] = None) -> np.ndarray:
    """Carbon-aware replacement ids, columnar: for each (slot, generation)
    dispatch, walk that slot's probe stream (``events.probe_uniforms``) and
    pick the first candidate whose deterministic country draw lands in the
    ``fed.carbon_topk`` lowest-intensity countries at the row's dispatch
    clock; rows under the ``fed.carbon_explore`` floor (and rows where all
    ``_CARBON_PROBES`` candidates miss) take the unscreened first probe.

    Under a live ``AvailabilityModel`` the screen also intersects each
    candidate's admission test (its own counter-keyed admission uniform vs
    eligibility at the dispatch clock — the exact draw ``resolve`` will
    re-derive), preferring low-carbon AND admissible; rows with no
    admissible low-carbon candidate fall back to the first admissible
    probe, then to the unscreened first probe.

    Diurnal screening runs off the schedule's COMPILED segment grid
    (``_VocabSchedule.segment_table``/``allowed_masks``): one searchsorted
    per row plus a precomputed (segment, country) mask gather, instead of
    evaluating all V countries' intensities per row and re-partitioning.
    The precompute cannot change picks: the grid's segments are exactly
    the maximal clock spans on which no country's schedule changes value,
    the per-segment mask stores the same "value <= k-th smallest" screen
    (a value threshold, never an argpartition rank, so tied intensities
    resolve identically), and both admission uniforms and candidate
    country draws stay untouched counter streams — so the compiled gather
    answers with the very mask the direct per-row recompute would build.

    Every output is a pure per-row function of (seed, slot, generation,
    start clock, version) and the environment — never of batch grouping or
    global arrival order — so the serial loop, the lane-batched engine and
    the scalar oracle replay identical picks, row for row. ``skip`` marks
    rows whose result the caller will overwrite (the retry stream): they
    take the unscreened first probe without paying for screening, which
    is pick-identical because screening is row-local and their pick is
    discarded anyway."""
    slots = np.asarray(slots, np.int64)
    gens = np.asarray(gens, np.int64)
    n = len(slots)
    u = probe_uniforms(fed.seed, slots, gens, _CARBON_PROBES + 1)
    cand = (u[:, 1:] * _POPULATION).astype(np.int64)
    names = sampler.country_names
    k = min(int(fed.carbon_topk), len(names))
    if k >= len(names) and not sampler.has_avail:
        return cand[:, 0]
    # exploration rows take the unscreened first probe regardless — skip
    # their country/admission probe work up front (pick-identical)
    live = u[:, 0] >= fed.carbon_explore
    if skip is not None:
        live &= ~skip
    out = cand[:, 0].copy()
    if not live.any():
        return out
    starts = np.broadcast_to(np.asarray(starts, np.float64), (n,))
    cd = cand[live]
    stl = starts[live]
    m = len(cd)
    ctry = sampler.country_draw(cd.reshape(-1), version) \
        .reshape(m, _CARBON_PROBES)
    if k >= len(names):
        allowed = np.ones((m, _CARBON_PROBES), bool)
    else:
        # the allowed set is "intensity <= the k-th smallest" — a value
        # threshold, not an argpartition rank, so ties resolve identically
        # everywhere regardless of partition order
        tab = intensity.vocab_schedule(names)
        if not tab.any_dynamic:
            # static grid: the allowed-country mask is clock-independent —
            # one (V,) threshold serves every row (the window merge issues
            # many small dispatch batches; skip the per-row (n, V) work)
            allowed_row = tab.static <= np.partition(tab.static,
                                                     k - 1)[k - 1]
            allowed = allowed_row[ctry]
        else:
            seg = tab.segment_at(stl)                    # (m,) grid rows
            allowed = tab.allowed_masks(k)[seg[:, None], ctry]
    if sampler.has_avail:
        ua = sampler.admission_uniforms(cd.reshape(-1), version) \
            .reshape(m, _CARBON_PROBES)
        av = sampler._avail_tab
        if av.any_dynamic:
            _, evals = av.segment_table()
            e = evals[av.segment_at(stl)[:, None], ctry]
        else:
            e = av.static[ctry]
        adm = ua < e
        both = allowed & adm
        j = np.where(both.any(axis=1), np.argmax(both, axis=1),
                     np.where(adm.any(axis=1), np.argmax(adm, axis=1), 0))
    else:
        j = np.where(allowed.any(axis=1), np.argmax(allowed, axis=1), 0)
    out[live] = cd[np.arange(m), j]
    return out


def _pad3(mats: List[np.ndarray], vmax: int, fill, dtype) -> np.ndarray:
    """Stack ragged per-lane (S_i, V_i) tables into one padded
    (L, S_max, V_max) block (the 2-D analogue of ``events._pad2``).
    Pads are never gathered: segment indices stay < S_i and country
    draws stay < V_i for each lane."""
    smax = max(t.shape[0] for t in mats)
    out = np.full((len(mats), smax, vmax), fill, dtype)
    for i, t in enumerate(mats):
        out[i, :t.shape[0], :t.shape[1]] = t
    return out


def _group_grids(breaks_list) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Group per-lane breakpoint grids by content so the per-wave segment
    lookup runs one searchsorted per DISTINCT grid (sweep packs usually
    share one or two environments), not one per lane. Lanes with no grid
    (clock-independent screens) get group -1 / segment 0."""
    grids: List[np.ndarray] = []
    grp = np.full(len(breaks_list), -1, np.int64)
    for i, b in enumerate(breaks_list):
        if b is None:
            continue
        for g, e in enumerate(grids):
            if e is b or np.array_equal(e, b):
                grp[i] = g
                break
        else:
            grids.append(b)
            grp[i] = len(grids) - 1
    return grp, grids


class _LaneCarbonScreen:
    """Pack-wide compiled carbon screen: per-lane explore floors and top-k
    widths plus padded (lane, segment, country) allowed-mask and
    eligibility tables, mirroring ``LaneSampler``'s padded fleet/country
    tables — so one batched gather screens a whole multi-lane dispatch
    wave instead of a Python loop of per-lane ``carbon_pick_ids`` calls.
    Per lane the math is identical to ``carbon_pick_ids``: same
    counter-keyed probe/country/admission draws (per-row-seed twins),
    same compiled segment grids, same value-threshold masks. Non-avail
    lanes screen admission against +inf eligibility — ``ua < inf`` is
    always true, which collapses the shared formula to the
    no-availability pick, row for row."""

    def __init__(self, pack: "_LanePack"):
        lanes = pack.lanes
        ss = lanes.samplers
        feds = pack.feds
        ints = [t.estimator.intensity for t in pack.tasks]
        n_lanes = pack.n_lanes
        self.lanes = lanes
        self.explore = np.asarray([f.carbon_explore for f in feds])
        nv = np.asarray([len(s.country_names) for s in ss], np.int64)
        self.kk = np.asarray([min(int(f.carbon_topk), int(v))
                              for f, v in zip(feds, nv)], np.int64)
        avail = np.asarray([s.has_avail for s in ss], bool)
        # k covers the whole vocabulary and nothing gates admission:
        # every pick is the unscreened first probe (the serial early-out)
        self.trivial = (self.kk >= nv) & ~avail
        amasks: List[np.ndarray] = []
        abreaks: List[Optional[np.ndarray]] = []
        for i in range(n_lanes):
            tab = ints[i].vocab_schedule(ss[i].country_names)
            k = int(self.kk[i])
            if k >= int(nv[i]):
                amasks.append(np.ones((1, int(nv[i])), bool))
                abreaks.append(None)
            elif not tab.any_dynamic:
                row = tab.static <= np.partition(tab.static, k - 1)[k - 1]
                amasks.append(row[None, :])
                abreaks.append(None)
            else:
                amasks.append(tab.allowed_masks(k))
                abreaks.append(tab.segment_table()[0])
        evals: List[np.ndarray] = []
        ebreaks: List[Optional[np.ndarray]] = []
        for i in range(n_lanes):
            if not avail[i]:
                evals.append(np.full((1, int(nv[i])), np.inf))
                ebreaks.append(None)
            elif ss[i]._avail_tab.any_dynamic:
                brk, ev = ss[i]._avail_tab.segment_table()
                evals.append(ev)
                ebreaks.append(brk)
            else:
                evals.append(ss[i]._avail_tab.static[None, :])
                ebreaks.append(None)
        vmax = int(nv.max())
        self.amask = _pad3(amasks, vmax, False, bool)
        self.evals = _pad3(evals, vmax, np.inf, np.float64)
        self.agrp, self.agrids = _group_grids(abreaks)
        self.egrp, self.egrids = _group_grids(ebreaks)

    def _segments(self, grp: np.ndarray, grids: List[np.ndarray],
                  li: np.ndarray, tl: np.ndarray) -> np.ndarray:
        seg = np.zeros(len(li), np.int64)
        g_of = grp[li]
        for g, brk in enumerate(grids):
            rows = g_of == g
            if rows.any():
                seg[rows] = np.searchsorted(brk, tl[rows],
                                            side="right") - 1
        return seg

    def pick(self, lane: np.ndarray, slots: np.ndarray, gens: np.ndarray,
             starts, version: int,
             skip: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched ``carbon_pick_ids`` across lanes (see class doc)."""
        lanes = self.lanes
        lane = np.asarray(lane, np.intp)
        n = len(lane)
        u = lanes.probe_uniforms(lane, slots, gens, _CARBON_PROBES + 1)
        cand = (u[:, 1:] * _POPULATION).astype(np.int64)
        out = cand[:, 0].copy()
        live = (u[:, 0] >= self.explore[lane]) & ~self.trivial[lane]
        if skip is not None:
            live &= ~skip
        if not live.any():
            return out
        starts = np.broadcast_to(np.asarray(starts, np.float64), (n,))
        li = lane[live]
        cd = cand[live]
        m = len(li)
        lrep = np.repeat(li, _CARBON_PROBES)
        ctry = lanes.country_draw(lrep, cd.reshape(-1), version) \
            .reshape(m, _CARBON_PROBES)
        tl = np.mod(starts[live], SECONDS_PER_DAY)
        sa = self._segments(self.agrp, self.agrids, li, tl)
        allowed = self.amask[li[:, None], sa[:, None], ctry]
        ua = lanes.admission_uniforms(lrep, cd.reshape(-1), version) \
            .reshape(m, _CARBON_PROBES)
        se = self._segments(self.egrp, self.egrids, li, tl)
        adm = ua < self.evals[li[:, None], se[:, None], ctry]
        both = allowed & adm
        j = np.where(both.any(axis=1), np.argmax(both, axis=1),
                     np.where(adm.any(axis=1), np.argmax(adm, axis=1), 0))
        out[live] = cd[np.arange(m), j]
        return out


@register_strategy("carbon-aware")
class CarbonAwareStrategy(AsyncStrategy):
    """FedBuff with carbon-aware cohort selection: the same always-
    ``concurrency``-in-flight event loop as "async", but every replacement
    dispatch screens a short stream of candidate client ids and picks the
    first whose country (a deterministic sampler draw) sits in the k
    lowest-intensity countries *at the dispatch clock* — time/geo shifting
    in the CAFE mold, driven by ``Environment.carbon_intensity`` +
    ``intensity_schedule``. ``fed.carbon_topk`` sets the country filter
    width and ``fed.carbon_explore`` the exploration floor (unscreened
    dispatch probability), so no region is ever starved and convergence
    stats stay honest. The initial cohort (generation 0) goes out
    unscreened, exactly like "async" — the filter starts with the first
    replacement wave.

    Because picks stay pure counter functions of (seed, slot, generation,
    clock, version), the strategy inherits the async window-batched merge
    AND its lane_loop unchanged — only the id hooks differ — and stays
    seed-for-seed equal to its scalar oracle twin
    (``reference.run_scalar``) and to its own lanes under
    ``sweep(vectorize=True)``."""

    def _replacement_ids(self, sampler, fed, slots, gens, starts, version,
                         skip=None):
        return carbon_pick_ids(sampler, self._estimator.intensity, fed,
                               slots, gens, starts, version, skip=skip)

    def _lane_replacement_ids(self, pack, lane, slots, gens, starts,
                              version, skip=None):
        # one batched screen per dispatch wave over the pack's compiled
        # per-lane mask tables (built once per run, cached on the pack).
        # Picks are row-local — each row reads only its own lane's seed,
        # grids and knobs — so batching across lanes cannot change any
        # row's result vs a per-lane carbon_pick_ids call.
        screen = pack.carbon_screen
        if screen is None:
            screen = pack.carbon_screen = _LaneCarbonScreen(pack)
        return screen.pick(lane, slots, gens, starts, version, skip=skip)

    # explicit lane-pack opt-in (sweep._pack_key requires lane_loop in
    # cls.__dict__): the parent's lockstep loop dispatched through THIS
    # class's id hooks IS the correct lane semantics for this strategy
    lane_loop = AsyncStrategy.lane_loop


# ---------------------------------------------------------------------------
# Lane-batched execution: a pack of compatible experiments as ONE simulation
# ---------------------------------------------------------------------------

@dataclass
class LaneTask:
    """One lane of a lane-batched pack — everything ``Strategy.run`` would
    receive for a single experiment, pre-resolved (model config, learner,
    sampler, estimator) so the pack runner never touches spec plumbing."""
    model_cfg: ModelConfig
    fed: FederatedConfig
    run: RunConfig
    learner: object
    sampler: SessionSampler
    estimator: CarbonEstimator
    on_round: Optional[RoundCallback] = None


class _LaneStreamSink:
    """``LaneAccumulator``-compatible ``append`` surface for streaming
    packs: each appended block's rows forward to their lane's
    ``StreamedLog`` fold. ``np.flatnonzero`` keeps within-lane row order,
    which is the lane's serial log order (the lane-equivalence
    invariant), so per-lane reservoir global indices line up with a
    serial streaming run exactly."""

    def __init__(self, logs: List[StreamedLog]):
        self.logs = logs

    def append(self, lane: np.ndarray, **cols: np.ndarray) -> None:
        lane = np.asarray(lane)
        n = len(cols["client_id"])
        block = {f: (np.broadcast_to(np.asarray(a), (n,))
                     if np.ndim(a) == 0 else a) for f, a in cols.items()}
        for i in np.unique(lane):
            m = np.flatnonzero(lane == i)
            self.logs[int(i)].append(**{f: a[m] for f, a in block.items()})


class _LanePack:
    """Shared mutable state for one lockstep lane run: per-lane clocks,
    round counters, stoppers, logs and learners, plus the pack-wide
    ``LaneSampler`` and the single ``LaneAccumulator`` session store that
    per-lane TaskLogs are sliced out of at the end. Streaming packs
    (``run.telemetry == "streaming"``, uniform across lanes — the sweep
    packer splits mixed groups) swap the store for per-lane
    ``StreamedLog`` folds behind a ``_LaneStreamSink``."""

    def __init__(self, tasks: List[LaneTask]):
        self.tasks = tasks
        self.n_lanes = len(tasks)
        self.feds = [t.fed for t in tasks]
        self.runs = [t.run for t in tasks]
        self.learners = [t.learner for t in tasks]
        self.lanes = LaneSampler([t.sampler for t in tasks])
        self.stoppers = [_Stopper(t.run) for t in tasks]
        self.streaming = tasks[0].run.telemetry == "streaming"
        assert all((t.run.telemetry == "streaming") == self.streaming
                   for t in tasks), \
            "lane packs must not mix streaming and full telemetry"
        # per-lane effective checkpoint period (see Strategy.run)
        self.ckpt = [t.fed.checkpoint_period_s
                     if (t.sampler.has_avail and t.fed.retry_limit > 0)
                     else 0.0 for t in tasks]
        if self.streaming:
            self.logs: List[TaskLog] = [
                StreamedLog(t.estimator, t.sampler.device_names,
                            t.sampler.country_names, seed=t.fed.seed,
                            sample=t.run.telemetry_sample, mode=t.fed.mode,
                            checkpoint_period_s=self.ckpt[i])
                for i, t in enumerate(tasks)]
            self.acc = _LaneStreamSink(self.logs)
        else:
            self.logs = [TaskLog() for _ in tasks]
            for i, log in enumerate(self.logs):
                log.checkpoint_period_s = self.ckpt[i]
            self.acc = LaneAccumulator(self.lanes.device_names,
                                       self.lanes.country_names)
        self.t = np.zeros(self.n_lanes)
        self.rounds = np.zeros(self.n_lanes, np.int64)
        self.ppl = np.asarray([float(t.model_cfg.vocab_size) for t in tasks])
        self.active = np.ones(self.n_lanes, bool)
        self.n_logged = np.zeros(self.n_lanes, np.int64)
        # compiled carbon screen (built lazily by CarbonAwareStrategy)
        self.carbon_screen: Optional["_LaneCarbonScreen"] = None

    def close_round(self, i: int, round_idx: int, mode: str,
                    starved: bool = False) -> None:
        """Per-lane post-update bookkeeping (log + streamed RoundEvent),
        identical to the serial loops' tail."""
        stop = self.stoppers[i]
        sm = stop.smoothed or self.ppl[i]
        self.logs[i].log_round(self.t[i], starved=starved)
        self.logs[i].log_eval(self.t[i], round_idx, self.ppl[i], sm)
        cb = self.tasks[i].on_round
        if cb is not None:
            cb(RoundEvent(round_idx, float(self.t[i]), float(self.ppl[i]),
                          sm, int(self.n_logged[i]), mode))


class LaneRunner:
    """Run a pack of compatible experiments (same ``mode``) in lockstep as
    ONE columnar simulation: sampler draws become ``(lane, batch)``-shaped
    arrays keyed per lane, per-lane clocks advance under an active-lane
    mask, sessions accumulate into one lane-columnar store, and the
    estimator reduces per-lane segments. Results equal per-task
    ``Strategy.run`` **seed for seed** (same summaries, same session
    columns): lanes share no RNG state — all per-session randomness is
    counter-keyed on each lane's own seed — so batching changes only array
    shapes, never values. Lanes may differ in concurrency, aggregation
    goal, seeds, model size, run budgets and every Environment knob; they
    must share the event-loop mode (one lockstep window shape)."""

    def __init__(self, mode: str):
        self.mode = mode
        self.strategy = get_strategy(mode)
        if not hasattr(self.strategy, "lane_loop"):
            raise ValueError(
                f"strategy {mode!r} has no lane_loop; run specs serially")

    def run(self, tasks: Sequence[LaneTask]) -> List[TaskResult]:
        tasks = list(tasks)
        assert all(t.fed.mode == self.mode for t in tasks), \
            "lane packs must share the event-loop mode"
        pack = _LanePack(tasks)
        self.strategy.lane_loop(pack)
        assert not pack.active.any()
        if pack.streaming:
            # each lane's StreamedLog already holds its exact running
            # sums; estimate() reads them via carbon_components
            carbons = [t.estimator.estimate(pack.logs[i])
                       for i, t in enumerate(tasks)]
        else:
            batches = pack.acc.split()
            cols = pack.acc.raw()
            carbons = lane_carbon(cols, cols["lane"],
                                  [t.estimator for t in tasks],
                                  pack.lanes.device_names,
                                  pack.lanes.country_names,
                                  [log.duration_s for log in pack.logs],
                                  checkpoint_period_s=pack.ckpt)
        out: List[TaskResult] = []
        for i, task in enumerate(tasks):
            log = pack.logs[i]
            if not pack.streaming:
                log.log_batch(batches[i])
            stop = pack.stoppers[i]
            ppl = float(pack.ppl[i])
            out.append(TaskResult(log, carbons[i], stop.reached,
                                  int(pack.rounds[i]),
                                  float(pack.t[i]) / 3600.0, ppl,
                                  stop.smoothed or ppl,
                                  aborted=stop.aborted))
        return out


# ---------------------------------------------------------------------------
# Deprecated free-function shims (pre-`repro_torch.api` entry points)
# ---------------------------------------------------------------------------

def run_sync(model_cfg: ModelConfig, fed: FederatedConfig, run: RunConfig,
             learner, seq_len: int = 64,
             estimator: Optional[CarbonEstimator] = None) -> TaskResult:
    warnings.warn(
        "run_sync is deprecated; use repro.api.Experiment",
        DeprecationWarning, stacklevel=2)
    return SyncStrategy().run(model_cfg, fed, run, learner, seq_len=seq_len,
                              estimator=estimator)


def run_async(model_cfg: ModelConfig, fed: FederatedConfig, run: RunConfig,
              learner, seq_len: int = 64,
              estimator: Optional[CarbonEstimator] = None) -> TaskResult:
    warnings.warn(
        "run_async is deprecated; use repro.api.Experiment",
        DeprecationWarning, stacklevel=2)
    return AsyncStrategy().run(model_cfg, fed, run, learner, seq_len=seq_len,
                               estimator=estimator)


def run_task(model_cfg: ModelConfig, fed: FederatedConfig, run: RunConfig,
             learner, seq_len: int = 64) -> TaskResult:
    """Deprecated: build an `repro_torch.api.ExperimentSpec` and run it through
    `repro_torch.api.Experiment` instead."""
    warnings.warn(
        "run_task is deprecated; use repro.api.Experiment", DeprecationWarning,
        stacklevel=2)
    return get_strategy(fed.mode).run(model_cfg, fed, run, learner,
                                      seq_len=seq_len)
