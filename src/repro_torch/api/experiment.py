"""`Experiment` — the one way to run an FL task — and its `Result`.

    spec = ExperimentSpec(model=ModelRef("paper-charlm"),
                          federated=FederatedConfig(concurrency=100, ...))
    result = Experiment(spec).run(on_round=print)
    result.summary()          # rounds / duration / per-component carbon

The runner resolves the model ref, builds the chosen learner, dispatches
`spec.federated.mode` through the strategy registry, and threads the
spec's `Environment` into both the session sampler and the carbon
estimator. Per-round `RoundEvent`s stream to callbacks while the task
runs; the returned `Result` subsumes the legacy TaskResult + its
CarbonBreakdown and records the spec that produced it.

Population-scale tasks keep the same surface with constant memory:

    spec = ExperimentSpec(
        model=ModelRef("paper-charlm"),
        federated=FederatedConfig(mode="async", concurrency=1_000_000,
                                  aggregation_goal=10_000),
        run=RunConfig(max_rounds=1_000, telemetry="streaming"))
    res = Experiment(spec).run()
    res.summary()            # exact — bit-for-bit vs telemetry="full"
    res.log.columns()        # seed-deterministic reservoir sample

`telemetry="streaming"` swaps the materialized TaskLog for a
`repro_torch.core.streaming.StreamedLog`: summary scalars (carbon, energy,
bytes, participation, staleness) fold into error-free running sums and
stay exactly equal to the materialized path, while per-session columns
are a `telemetry_sample`-row reservoir (`log.sampled` says whether the
population outgrew it).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from repro_torch.api.spec import ExperimentSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.core.estimator import CarbonBreakdown
from repro_torch.core.telemetry import TaskLog
from repro_torch.federated.runtime import (RoundEvent, TaskResult, get_strategy)

RoundCallback = Callable[[RoundEvent], None]
StartCallback = Callable[[ExperimentSpec], None]
CompleteCallback = Callable[["Result"], None]


@dataclass(frozen=True)
class Result:
    """Everything a finished experiment produced: telemetry log, carbon
    breakdown, convergence verdict — plus the spec that generated it and
    the real wall-clock cost of running the simulation."""

    spec: ExperimentSpec
    log: TaskLog
    carbon: CarbonBreakdown
    reached_target: bool
    rounds: int
    duration_h: float
    final_perplexity: float
    smoothed_perplexity: float
    wall_s: float = 0.0
    aborted: bool = False   # starvation abort (sync graceful degradation)
    # when the run checkpointed: {"saves": n, "save_wall_s": s} — what the
    # snapshots cost this run (not part of summary(); summaries stay
    # bit-comparable across checkpointed and plain runs)
    checkpoint_stats: Optional[Dict[str, float]] = None

    @classmethod
    def from_task_result(cls, spec: ExperimentSpec, tr: TaskResult,
                         wall_s: float = 0.0,
                         checkpoint_stats: Optional[Dict[str, float]] = None
                         ) -> "Result":
        return cls(spec=spec, log=tr.log, carbon=tr.carbon,
                   reached_target=tr.reached_target, rounds=tr.rounds,
                   duration_h=tr.duration_h,
                   final_perplexity=tr.final_perplexity,
                   smoothed_perplexity=tr.smoothed_perplexity,
                   wall_s=wall_s, aborted=tr.aborted,
                   checkpoint_stats=checkpoint_stats)

    def summary(self) -> Dict[str, float]:
        """Same keys as the legacy TaskResult.summary() so downstream CSV
        tooling keeps working unchanged."""
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

    def to_dict(self) -> dict:
        return {
            "summary": self.summary(),
            "carbon_shares": self.carbon.shares(),
            "participation": self.log.participation(),
            "mean_staleness": self.log.mean_staleness(),
            "wall_s": self.wall_s,
            "spec": self.spec.to_dict(),
        }


class Experiment:
    """Runs an ExperimentSpec. `run()` uses the injected learner if one was
    given, else the learner pre-built with `build_learner()` (handy for
    inspecting initial state), else builds a fresh one — and a second
    `run()` always rebuilds a non-injected learner, so the same Experiment
    re-runs reproducibly.

    ``device`` is where a real learner that the Experiment builds itself
    runs: the card by default, and without one it raises unless
    ``device="cpu"``. A surrogate run touches no tensor and ignores it. The
    spec carries no device, so its JSON and ``content_hash()`` equal the
    reference package's."""

    def __init__(self, spec: ExperimentSpec, learner=None, *,
                 device="cuda"):
        self.spec = spec
        self.device = device              # where a built real learner runs
        self._injected = learner is not None
        self.learner = learner            # the learner of the next/latest run
        self._consumed = False
        self._model_cfg: Optional[ModelConfig] = None

    @property
    def model_config(self) -> ModelConfig:
        if self._model_cfg is None:
            self._model_cfg = self.spec.model.resolve()
        return self._model_cfg

    def build_learner(self):
        """Build (and remember) the learner the next `run()` will use."""
        if not self._injected:
            self.learner = self._make_learner()
            self._consumed = False
        return self.learner

    def _make_learner(self):
        spec = self.spec
        cfg = self.model_config
        if spec.learner == "surrogate":
            from repro_torch.federated.surrogate import SurrogateLearner
            return SurrogateLearner(cfg, spec.federated, spec.run)
        from repro_torch import resolve_device
        from repro_torch.data.synthetic import FederatedDataset
        from repro_torch.federated.real import RealLearner
        device = resolve_device(self.device)
        ds = FederatedDataset(vocab_size=cfg.vocab_size, seq_len=spec.seq_len,
                              char_vocab=cfg.char_vocab,
                              max_word_len=cfg.max_word_len)
        return RealLearner(cfg, spec.federated, spec.run, ds,
                           max_client_steps=spec.max_client_steps,
                           device=device)

    def run(self, on_round: Optional[RoundCallback] = None,
            on_start: Optional[StartCallback] = None,
            on_complete: Optional[CompleteCallback] = None, *,
            checkpoint_path: Optional[str] = None,
            checkpoint_every_rounds: int = 0,
            resume_from: Optional[str] = None) -> Result:
        """Run the spec; optionally checkpoint and/or resume mid-run state.

        Snapshot contract (see ``repro_torch.core.snapshot``): with
        ``checkpoint_path`` + ``checkpoint_every_rounds=N`` the engine
        writes a versioned checkpoint every N rounds (sync) / server
        versions (async), atomically. ``resume_from`` restores one and
        continues; a resumed run's ``summary()`` AND session columns are
        **bit-for-bit** identical to the uninterrupted run on every
        strategy × telemetry × schedule combination — that is what the
        counter-keyed randomness buys. NOT exact: ``wall_s`` (real time
        actually spent), and any work done after the last checkpoint is
        redone, not replayed. Snapshots cover the surrogate learner only
        (the port's real learner carries unserialized params).
        """
        spec = self.spec
        cfg = self.model_config
        if self.learner is None or (self._consumed and not self._injected):
            self.build_learner()
        self._consumed = True
        strategy = get_strategy(spec.federated.mode)
        env = spec.environment
        snap = self._snapshot_hook(checkpoint_path, checkpoint_every_rounds,
                                   resume_from)
        if on_start is not None:
            on_start(spec)
        t0 = time.time()
        tr = strategy.run(
            cfg, spec.federated, spec.run, self.learner,
            seq_len=spec.seq_len,
            estimator=env.estimator(),
            sampler=env.sampler(cfg, spec.federated, spec.seq_len),
            on_round=on_round, snap=snap)
        stats = None
        if snap is not None and snap.saves:
            stats = {"saves": snap.saves,
                     "save_wall_s": round(snap.save_wall_s, 6)}
        result = Result.from_task_result(spec, tr, wall_s=time.time() - t0,
                                         checkpoint_stats=stats)
        if on_complete is not None:
            on_complete(result)
        return result

    def _snapshot_hook(self, checkpoint_path, checkpoint_every_rounds,
                       resume_from):
        from repro_torch.core.snapshot import (SnapshotHook, _CrashInjector,
                                         load_snapshot)
        spec = self.spec
        crash = _CrashInjector.from_env(seed=spec.federated.seed)
        resume = None
        if resume_from is not None:
            resume = load_snapshot(resume_from)
            want, found = spec.content_hash(), resume.spec_hash
            if found != want:
                raise ValueError(
                    f"checkpoint {resume_from!r} was written by a "
                    f"different spec: its spec hash is {found}, this "
                    f"experiment's spec hash is {want} — refusing a "
                    f"wrong-spec resume")
        if (checkpoint_path or resume is not None) \
                and spec.learner != "surrogate":
            raise ValueError(
                "engine snapshots support learner='surrogate' only; the "
                "port's real learner's parameters are not serialized")
        if checkpoint_path and checkpoint_every_rounds <= 0 \
                and resume is None:
            raise ValueError(
                "checkpoint_path requires checkpoint_every_rounds > 0")
        if checkpoint_path is None and resume is None and crash is None:
            return None
        path = checkpoint_path or resume_from
        every = checkpoint_every_rounds or (resume.every if resume else 0)
        return SnapshotHook(path=path, every=every, spec=spec,
                            mode=spec.federated.mode, crash=crash,
                            resume=resume)

    @classmethod
    def resume(cls, path: str, *,
               checkpoint_path: Optional[str] = None,
               checkpoint_every_rounds: int = 0,
               on_round: Optional[RoundCallback] = None,
               on_start: Optional[StartCallback] = None,
               on_complete: Optional[CompleteCallback] = None) -> Result:
        """Resume a checkpointed run from its snapshot file and run it to
        completion. The spec travels inside the checkpoint header, so the
        caller needs nothing but the path. By default the resumed run
        keeps checkpointing to the same file at the saved cadence;
        override with ``checkpoint_path``/``checkpoint_every_rounds``."""
        from repro_torch.core.snapshot import load_snapshot
        snap = load_snapshot(path)
        exp = cls(snap.spec())
        return exp.run(on_round=on_round, on_start=on_start,
                       on_complete=on_complete,
                       checkpoint_path=checkpoint_path or path,
                       checkpoint_every_rounds=checkpoint_every_rounds,
                       resume_from=path)


def run_spec(spec: ExperimentSpec, **callbacks) -> Result:
    """One-liner convenience: `run_spec(ExperimentSpec(...))`."""
    return Experiment(spec).run(**callbacks)
