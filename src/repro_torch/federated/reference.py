"""Scalar reference engine — the pre-columnar event loops, kept verbatim.

The production strategies in ``repro_torch.federated.runtime`` are vectorized
end-to-end (``plan_batch``/``resolve_batch``/``SessionBatch``). This module
preserves the original per-session Python loops, driven by the sampler's
``plan_scalar``/``resolve_scalar`` and the estimator's ``estimate_scalar``,
for two purposes only:

* seed-for-seed equivalence tests (``tests/test_torch_oracle.py``, as
  ``tests/test_columnar.py`` for the reference package) prove the
  columnar sync AND async engines reproduce this loop's TaskLog stats and
  CarbonBreakdown;
* it is a copy of the reference package's oracle, held to its source by
  ``tests/test_torch_engine_copy.py``, so the port's engine is held to
  the same loop.

The async loop here still pops a heap one session at a time, but it is
keyed the same way as the vectorized window merge: heap order is
``(end_t, slot, generation)`` and replacement client ids come from the
per-slot counter-based splitmix64 streams (``slot_stream_id``) rather
than the shared rng — identity decoupled from pop rank is exactly what
makes the columnar engine's batched merge reproduce this loop.

Do not grow features here — it intentionally trails the real engine except
where equivalence demands parity (cohort selection, byte proration, the
cancelled-session flush at task end).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import FederatedConfig, ModelConfig, RunConfig
from repro_torch.core.estimator import CarbonEstimator
from repro_torch.core.telemetry import OUTCOME_CODE, ClientSession, TaskLog
from repro_torch.federated.events import (SessionSampler, retry_stream_id,
                                          slot_stream_id)
from repro_torch.federated.runtime import (_POPULATION, _SERVER_AGG_S,
                                           TaskResult, _retry_rem,
                                           _select_cohort, _sync_dispatch_n,
                                           _Stopper)


def _rem_after(kw: dict, planned_c: float, rem: float,
               period_s: float) -> float:
    """Scalar twin of the engine's per-row remainder bookkeeping: wraps
    ``_retry_rem`` batch-of-1 so the float op sequence (floor, divide,
    multiply) is shared verbatim with the columnar loops."""
    return float(_retry_rem(
        np.asarray([OUTCOME_CODE[kw["outcome"]]], np.int8),
        np.asarray([planned_c]), np.asarray([kw["compute_s"]]),
        np.asarray([rem]), period_s)[0])


def run_scalar(model_cfg: ModelConfig, fed: FederatedConfig, run: RunConfig,
               learner, *, seq_len: int = 64,
               estimator: Optional[CarbonEstimator] = None,
               sampler: Optional[SessionSampler] = None) -> TaskResult:
    """Run one FL task through the scalar reference loop for `fed.mode`."""
    sampler = sampler or SessionSampler(model_cfg, fed, seq_len)
    est = estimator or CarbonEstimator()
    log = TaskLog()
    # mirror Strategy.run's effective salvage period for estimate_scalar
    log.checkpoint_period_s = fed.checkpoint_period_s \
        if (sampler.has_avail and fed.retry_limit > 0) else 0.0
    stop = _Stopper(run)
    if fed.mode == "sync":
        t, rounds, ppl = _sync_loop(model_cfg, fed, learner, sampler, log,
                                    stop)
    elif fed.mode == "carbon-aware":
        t, rounds, ppl = _async_loop(model_cfg, fed, learner, sampler, log,
                                     stop,
                                     pick_id=_carbon_pick(sampler, est, fed))
    else:
        t, rounds, ppl = _async_loop(model_cfg, fed, learner, sampler, log,
                                     stop)
    return TaskResult(log, est.estimate_scalar(log), stop.reached, rounds,
                      t / 3600.0, ppl, stop.smoothed or ppl,
                      aborted=stop.aborted)


def _carbon_pick(sampler: SessionSampler, est: CarbonEstimator,
                 fed: FederatedConfig):
    """Per-pop replacement picker for the carbon-aware oracle: delegates to
    the engine's own columnar ``carbon_pick_ids`` with a batch of one, so
    the oracle is keyed to the SAME probe draws / country screens and the
    heap loop stays a pure event-order reference. That call also shares
    the engine's compiled schedule-segment tables
    (``_VocabSchedule.segment_table``/``allowed_masks``), so the oracle's
    batch-of-1 screen reads the exact float values the batched engine
    gathers — pick identity holds by construction, not by luck. The
    oracle never passes ``skip``: its retry rows are re-keyed before the
    pick, so every row here is a live screen."""
    from repro_torch.federated.runtime import carbon_pick_ids

    def pick(slot: int, gen: int, now: float, version: int) -> int:
        return int(carbon_pick_ids(sampler, est.intensity, fed,
                                   np.asarray([slot], np.int64),
                                   np.asarray([gen], np.int64),
                                   np.asarray([now]), version)[0])
    return pick


def _sync_loop(model_cfg, fed, learner, sampler, log, stop):
    rng = np.random.default_rng(fed.seed + 1)
    t = 0.0
    rounds = 0
    ppl = float(model_cfg.vocab_size)
    goal = min(fed.aggregation_goal, fed.concurrency)
    ndisp = _sync_dispatch_n(fed, goal)
    lo = "cancelled" if fed.over_select_fraction > 0 else None
    quorum = max(1, int(np.ceil(fed.min_report_fraction * goal)))
    streak = 0

    while True:
        cohort = _select_cohort(rng, ndisp, population=_POPULATION)
        if sampler.has_faults or (sampler.has_avail
                                  and fed.retry_limit > 0):
            n_ok, contributors, round_end = _sync_faulty_round(
                fed, sampler, log, cohort, rounds, t, goal,
                late_outcome=lo)
        else:
            plans = [sampler.plan_scalar(int(c), rounds) for c in cohort]
            tentative = [sampler.resolve_scalar(p, rounds, t) for p in plans]
            ends = sorted(s["end_t"] for s, ok in tentative if ok)
            if len(ends) >= goal:
                round_end = ends[goal - 1]
            elif ends:
                round_end = ends[-1]
            else:
                round_end = max((s["end_t"] for s, _ in tentative),
                                default=t)
            n_ok = 0
            contributors: List[int] = []
            for p in plans:
                kw, ok = sampler.resolve_scalar(p, rounds, t,
                                                deadline=round_end,
                                                late_outcome=lo)
                log.log_session(ClientSession(**kw))
                if ok:
                    n_ok += 1
                    if len(contributors) < goal:
                        contributors.append(p.client_id)
        starved = n_ok < quorum
        t = round_end + _SERVER_AGG_S
        rounds += 1
        if not starved and contributors:
            if getattr(learner, "real", True):
                deltas, weights = [], []
                for c in contributors:
                    d, w = learner.client_delta(c, None)
                    deltas.append(d)
                    weights.append(w)
            else:
                deltas, weights = [None], [1.0]
            learner.apply(deltas, weights, n_contributors=len(contributors))
            ppl = learner.eval_perplexity()
            stop.update(ppl)
        log.log_round(t, starved=starved)
        log.log_eval(t, rounds, ppl, stop.smoothed or ppl)
        if starved:
            streak += 1
            if fed.starvation_patience and streak >= fed.starvation_patience:
                stop.aborted = True
                break
        else:
            streak = 0
        if stop.reached or stop.out_of_budget(t, rounds):
            break
    return t, rounds, ppl


def _sync_faulty_round(fed, sampler, log, cohort, rounds, t, goal,
                       late_outcome=None):
    """Scalar twin of ``SyncStrategy._faulty_round``: chase failed AND
    churn-interrupted slots through retry re-dispatches (distinct
    counter-keyed ids, exponential backoff; an interrupted attempt's
    retry redoes only the un-checkpointed remainder when
    ``checkpoint_period_s`` > 0), close the round over all attempts'
    survivors, then re-resolve every row WITH the deadline for logging
    (bit-identical to the engine's in-place ``apply_deadline`` patch).
    Returns (n_ok, contributors, round_end)."""
    salv_on = sampler.has_avail and fed.retry_limit > 0 \
        and fed.checkpoint_period_s > 0
    pos = list(range(len(cohort)))
    ids = [int(c) for c in cohort]
    starts = [t] * len(cohort)
    rems = [1.0] * len(cohort)
    blocks = []      # per attempt: list of (scaled_plan, start, kw_nodl)
    for att in range(fed.retry_limit + 1):
        rows = []
        for cid, s0, rm in zip(ids, starts, rems):
            plan = sampler.plan_scalar(cid, rounds)
            if salv_on and att:
                plan = dataclasses.replace(plan,
                                           compute_s=plan.compute_s * rm)
            kw, _ = sampler.resolve_scalar(plan, rounds, s0)
            rows.append((plan, s0, kw))
        blocks.append(rows)
        fm = [j for j, (_, _, kw) in enumerate(rows)
              if kw["outcome"] in ("failed", "interrupted")]
        if att == fed.retry_limit or not fm:
            break
        if salv_on:
            rems = [_rem_after(rows[j][2], rows[j][0].compute_s, rems[j],
                               fed.checkpoint_period_s) for j in fm]
        else:
            rems = [1.0] * len(fm)
        pos = [pos[j] for j in fm]
        ids = [retry_stream_id(fed.seed, p,
                               rounds * (fed.retry_limit + 1) + att + 1,
                               _POPULATION) for p in pos]
        starts = [rows[j][2]["end_t"] + fed.retry_backoff_s * 2.0 ** att
                  for j in fm]
    ok_ends = sorted(kw["end_t"] for rows in blocks
                     for _, _, kw in rows if kw["outcome"] == "completed")
    if len(ok_ends) >= goal:
        round_end = ok_ends[goal - 1]
    elif ok_ends:
        round_end = ok_ends[-1]
    else:
        round_end = max(kw["end_t"] for rows in blocks for _, _, kw in rows)
    n_ok = 0
    contributors: List[int] = []
    for att, rows in enumerate(blocks):
        for plan, s0, _ in rows:
            kw, ok = sampler.resolve_scalar(plan, rounds, s0,
                                            deadline=round_end,
                                            late_outcome=late_outcome)
            if att < fed.retry_limit and kw["outcome"] == "failed":
                # a retry went out for this failure (interrupted rows
                # keep their label — churn vs crash stays separable)
                kw = dict(kw, outcome="retried")
            log.log_session(ClientSession(**kw))
            if ok:
                n_ok += 1
                if len(contributors) < goal:
                    contributors.append(plan.client_id)
    return n_ok, contributors, round_end


def _cancel_scalar(kw: dict, t_final: float) -> dict:
    """Scalar twin of the columnar engine's ``_truncate_cancelled``: an
    in-flight session at task end burns until the final clock, downlink
    bytes prorate, uplink bytes zero (never reached the server)."""
    d, c, u = kw["download_s"], kw["compute_s"], kw["upload_s"]
    cap = max(0.0, t_final - kw["start_t"])
    nd = min(d, cap)
    nc = min(c, max(0.0, cap - d))
    nu = min(u, max(0.0, cap - d - c))
    frac = nd / d if d > 0 else 0.0
    out = dict(kw)
    # a pending retry may start past the task end (backoff delay): it
    # burned nothing, but never let end_t precede start_t
    out.update(download_s=nd, compute_s=nc, upload_s=nu,
               bytes_down=kw["bytes_down"] * frac, bytes_up=0.0,
               end_t=min(kw["end_t"], max(t_final, kw["start_t"])),
               outcome="cancelled")
    return out


def _async_loop(model_cfg, fed, learner, sampler, log, stop, pick_id=None):
    """The FedBuff heap oracle. ``pick_id(slot, gen, now, version)``
    overrides replacement identity (default: the per-slot counter streams)
    — how the carbon-aware twin reuses this loop unchanged."""
    if pick_id is None:
        def pick_id(slot, gen, now, version):
            return slot_stream_id(fed.seed, slot, gen, _POPULATION)
    retry_on = (sampler.has_faults or sampler.has_avail) \
        and fed.retry_limit > 0
    salv_on = retry_on and sampler.has_avail \
        and fed.checkpoint_period_s > 0
    rng = np.random.default_rng(fed.seed + 2)
    t = 0.0
    version = 0
    ppl = float(model_cfg.vocab_size)
    buffer: List[Tuple[int, int]] = []
    # heap rows ordered by (end_t, slot, generation) — the same key the
    # vectorized window merge sorts on. Replacement ids come from the
    # per-slot counter-based streams (slot_stream_id), NOT from `rng`, so
    # identity is independent of pop order in both engines.
    heap: List[tuple] = []

    def dispatch(slot: int, gen: int, cid: int, now: float, att: int = 0,
                 rem: float = 1.0):
        plan = sampler.plan_scalar(cid, version)
        if salv_on:
            # checkpoint/resume: a retry redoes only its parent's
            # remainder (x * 1.0 is exact for fresh dispatches)
            plan = dataclasses.replace(plan,
                                       compute_s=plan.compute_s * rem)
        kw, ok = sampler.resolve_scalar(plan, version, now)
        nrem = _rem_after(kw, plan.compute_s, rem,
                          fed.checkpoint_period_s) if salv_on else 1.0
        heapq.heappush(heap, (kw["end_t"], slot, gen, cid,
                              (kw, ok, version, att, nrem)))

    for slot, c in enumerate(_select_cohort(rng, fed.concurrency,
                                            population=_POPULATION)):
        dispatch(slot, 0, int(c), t + float(rng.uniform(0, 5.0)))

    while heap:
        if stop.out_of_budget(t, version):
            break
        end, slot, gen, cid, (kw, ok, ver_sent, att, nrem) = \
            heapq.heappop(heap)
        t = max(t, end)
        # a failed/interrupted pop with attempt budget left schedules a
        # retry below (distinct id stream, exponential backoff) -> a
        # failure logs as "retried"; churn keeps its "interrupted" label
        will_retry = retry_on \
            and kw["outcome"] in ("failed", "interrupted") \
            and att < fed.retry_limit
        log.log_session(ClientSession(
            staleness=version - ver_sent,
            **(dict(kw, outcome="retried")
               if will_retry and kw["outcome"] == "failed" else kw)))
        if ok:
            buffer.append((cid, ver_sent))
            if len(buffer) >= fed.aggregation_goal:
                staleness = [version - v for _, v in buffer]
                if getattr(learner, "real", True):
                    deltas, weights = [], []
                    for bc, bv in buffer:
                        d, w = learner.client_delta(bc, bv)
                        deltas.append(d)
                        weights.append(w)
                    kw_extra = {"staleness": staleness}
                else:
                    deltas, weights, kw_extra = [None], [1.0], {}
                learner.apply(deltas, weights, n_contributors=len(buffer),
                              mean_staleness=float(np.mean(staleness)),
                              **kw_extra)
                buffer = []
                version += 1
                t += _SERVER_AGG_S
                ppl = learner.eval_perplexity()
                stop.update(ppl)
                log.log_round(t)
                log.log_eval(t, version, ppl, stop.smoothed or ppl)
                if stop.reached or stop.out_of_budget(t, version):
                    break
        if will_retry:
            nid = retry_stream_id(fed.seed, slot, gen + 1, _POPULATION)
            dispatch(slot, gen + 1, nid,
                     t + fed.retry_backoff_s * 2.0 ** att, att + 1,
                     rem=nrem)
        else:
            nid = pick_id(slot, gen + 1, t, version)
            dispatch(slot, gen + 1, nid, t)
    # task end: sessions still in flight are logged as cancelled,
    # truncated at the final clock (keeps energy accounting complete)
    for end, slot, gen, cid, (kw, ok, ver_sent, att, nrem) in sorted(
            heap, key=lambda r: r[1]):
        log.log_session(ClientSession(staleness=version - ver_sent,
                                      **_cancel_scalar(kw, t)))
    return t, version, ppl
