"""The port's sweep (``repro_torch.api.sweep``): serial, pool and
lane-batched sweeps agree bit for bit and equal the reference package's
``sweep`` on the same specs; the reference's fault-tolerant cases
(``tests/test_sweep_ft.py``) run on the port, crash injection through the
same ``REPRO_CRASH_*`` variables; a worker that sends its result and exits
between the scheduler's two checks is read, not counted as died; and a
real-learner sweep runs in spawned worker processes.
"""
import importlib
import math
import multiprocessing
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import repro.api as ref_api  # noqa: E402
from repro_torch.api import (Environment, Experiment, ExperimentSpec,  # noqa: E402
                             ModelRef, sweep)
from repro_torch.configs import FederatedConfig, RunConfig  # noqa: E402

# the submodule, not the same-named function re-exported by the package
sweep_mod = importlib.import_module("repro_torch.api.sweep")
SweepReport = sweep_mod.SweepReport


def _spec(seed: int, mode: str = "sync", conc: int = 6,
          max_rounds: int = 8, arch: str = "paper-charlm"
          ) -> ExperimentSpec:
    """tests/test_sweep_ft.py's spec, on the port."""
    return ExperimentSpec(
        model=ModelRef(arch),
        federated=FederatedConfig(mode=mode, concurrency=conc,
                                  aggregation_goal=max(1, int(conc * 0.8)),
                                  seed=seed),
        run=RunConfig(target_perplexity=1.0, max_rounds=max_rounds),
        environment=Environment(), learner="surrogate")


def _summaries(results):
    return [None if r is None else r.summary() for r in results]


def _fingerprint(r):
    """A Result's summary, participation, staleness and carbon breakdown."""
    return (r.summary(), r.log.participation(), r.log.mean_staleness(),
            r.carbon.as_dict())


# ------------------------------------------- serial, pool, lanes vs JAX
def _mixed_specs():
    out = []
    for i, mode in enumerate(("sync", "async", "carbon-aware") * 2):
        out.append(_spec(200 + i, mode=mode, conc=6 + 3 * i,
                         max_rounds=6 + i))
    return out


@pytest.mark.parametrize("how", ["pool", "vectorize", "vectorize-pool"])
def test_sweep_paths_equal_serial_and_the_reference(how):
    specs = _mixed_specs()
    serial = [_fingerprint(r) for r in sweep(specs, workers=1)]
    kw = {"pool": dict(workers=2),
          "vectorize": dict(workers=1, vectorize=True),
          "vectorize-pool": dict(workers=2, vectorize=True)}[how]
    got = [_fingerprint(r) for r in sweep(specs, **kw)]
    assert got == serial
    ref_specs = [ref_api.ExperimentSpec.from_json(s.to_json())
                 for s in specs]
    want = [_fingerprint(r) for r in ref_api.sweep(ref_specs, workers=1)]
    assert serial == want


def test_sweep_on_result_streams_every_spec_once():
    specs = _mixed_specs()[:4]
    seen = []
    results = sweep(specs, workers=2, on_result=lambda i, r: seen.append(i))
    assert sorted(seen) == [0, 1, 2, 3]
    assert _summaries(results) == _summaries(sweep(specs, workers=1))


# ----------------------------------------------------- fault tolerance
@pytest.fixture
def crash_env(monkeypatch, tmp_path):
    """Arm the crash injector for exactly one spec of a sweep; the
    once-marker lives in tmp_path, so the retried attempt succeeds."""
    def arm(at_round, kind, seed, once=True):
        monkeypatch.setenv("REPRO_CRASH_ROUND", str(at_round))
        monkeypatch.setenv("REPRO_CRASH_KIND", kind)
        monkeypatch.setenv("REPRO_CRASH_SEED", str(seed))
        if once:
            monkeypatch.setenv("REPRO_CRASH_ONCE",
                               str(tmp_path / "crash.once"))
    return arm


def test_ft_clean_sweep_reports_all_ok():
    specs = [_spec(s) for s in (1, 2, 3)]
    baseline = [Experiment(s).run().summary() for s in specs]
    results, report = sweep(specs, workers=2, return_report=True)
    assert _summaries(results) == baseline
    assert isinstance(report, SweepReport) and report.all_ok
    assert report.counts() == {"ok": 3}
    assert all(r.attempts == 1 and r.error is None for r in report.specs)
    assert all(r.wall_s > 0 for r in report.specs)


def test_ft_empty_sweep():
    results, report = sweep([], return_report=True)
    assert results == [] and report.specs == [] and report.all_ok


def test_ft_killed_worker_is_retried_and_result_is_identical(crash_env):
    specs = [_spec(s) for s in (10, 11, 12)]
    baseline = [Experiment(s).run().summary() for s in specs]
    crash_env(4, "kill", seed=11)
    failures = []
    results, report = sweep(
        specs, workers=2, retry_limit=2, retry_backoff_s=0.01,
        on_failure=lambda i, e, att: failures.append(
            (i, type(e).__name__, att)),
        return_report=True)
    assert _summaries(results) == baseline
    assert report.counts() == {"ok": 2, "retried": 1}
    rep = report.specs[1]
    assert rep.status == "retried" and rep.attempts == 2
    assert "_WorkerDied" in rep.error
    assert failures == [(1, "_WorkerDied", 1)]


def test_ft_hung_worker_times_out_and_is_retried(crash_env):
    specs = [_spec(s) for s in (20, 21)]
    crash_env(2, "hang", seed=21)
    results, report = sweep(
        specs, workers=2, timeout_s=2.0, retry_limit=1,
        retry_backoff_s=0.01, return_report=True)
    assert all(r is not None for r in results)
    assert report.counts() == {"ok": 1, "retried": 1}
    assert "timeout_s" in report.specs[1].error


def test_ft_exhausted_retries_leave_partial_results(crash_env):
    specs = [_spec(s) for s in (30, 31, 32)]
    crash_env(3, "kill", seed=31, once=False)    # crashes EVERY attempt
    results, report = sweep(specs, workers=2, retry_limit=1,
                            retry_backoff_s=0.01, return_report=True)
    assert results[1] is None
    assert results[0] is not None and results[2] is not None
    assert not report.all_ok
    rep = report.specs[1]
    assert rep.status == "failed" and rep.attempts == 2
    assert report.counts() == {"ok": 2, "failed": 1}


def test_ft_raised_failure_without_report_still_returns_partial():
    specs = [_spec(40), _spec(41, arch="no-such-arch"), _spec(42)]
    results = sweep(specs, workers=2, on_failure=lambda *a: None)
    assert results[1] is None
    assert results[0] is not None and results[2] is not None


def test_ft_on_result_fires_exactly_once_per_spec(crash_env):
    specs = [_spec(s) for s in (50, 51, 52)]
    crash_env(3, "raise", seed=52)
    seen = []
    results, _ = sweep(specs, workers=2, retry_limit=1,
                       retry_backoff_s=0.01, return_report=True,
                       on_result=lambda i, r: seen.append(i))
    assert sorted(seen) == [0, 1, 2]
    assert all(r is not None for r in results)


def test_ft_pack_salvage_reruns_survivors_and_isolates_culprit():
    specs = [_spec(60), _spec(61, arch="no-such-arch"),
             _spec(62), _spec(63)]
    good = [0, 2, 3]
    baseline = {i: Experiment(specs[i]).run().summary() for i in good}
    results, report = sweep(specs, workers=1, vectorize=True,
                            retry_limit=1, retry_backoff_s=0.01,
                            return_report=True)
    assert results[1] is None
    assert {i: results[i].summary() for i in good} == baseline
    assert report.counts() == {"retried": 3, "failed": 1}
    assert "spec index 1" in report.specs[1].error
    assert report.specs[1].attempts == 2


def test_ft_serial_fallback_when_processes_unavailable(monkeypatch,
                                                       crash_env):
    def no_pool(*a, **k):
        raise OSError("no processes here")
    monkeypatch.setattr(sweep_mod, "_sweep_ft_pool", no_pool)
    crash_env(3, "raise", seed=71)
    specs = [_spec(70), _spec(71)]
    with pytest.warns(RuntimeWarning, match="in-process"):
        results, report = sweep(specs, retry_limit=1,
                                retry_backoff_s=0.01, return_report=True)
    assert all(r is not None for r in results)
    assert report.counts() == {"ok": 1, "retried": 1}
    assert "sweep spec index 1" in report.specs[1].error


def test_legacy_serial_fallback_failure_names_spec_index(monkeypatch):
    def no_pool(*a, **k):
        raise OSError("no pool")
    monkeypatch.setattr(sweep_mod, "_sweep_pool", no_pool)
    specs = [_spec(80), _spec(81, arch="no-such-arch")]
    with pytest.warns(RuntimeWarning, match="in-process"):
        with pytest.raises(KeyError, match="sweep spec index 1"):
            sweep(specs, workers=2)


def test_legacy_serial_failure_names_spec_index():
    specs = [_spec(90), _spec(91, arch="no-such-arch")]
    with pytest.raises(KeyError, match="sweep spec index 1"):
        sweep(specs, workers=1)


def test_legacy_sweep_semantics_unchanged():
    specs = [_spec(s) for s in (100, 101)]
    results = sweep(specs, workers=1)
    assert [r.summary() for r in results] \
        == [Experiment(s).run().summary() for s in specs]


# ------------------------------------------------------- the pipe drain
def _late(target):
    """The worker's own target, started 0.3 s late, so it has sent nothing
    when the scheduler first looks at it."""
    def run(*args):
        time.sleep(0.3)
        target(*args)
    return run


class _LateContext:
    """A fork context whose workers start late and whose pipes answer
    their first poll as a poll made before the worker sent: no result. That
    poll returns only once the worker has sent its result and exited, so
    the scheduler's next check finds the worker dead with its result in
    the pipe: the race of a worker that sends and exits between the two
    checks, made certain. A result this small fits the pipe's buffer, so
    the worker can send it whole and exit without a reader."""

    def __init__(self):
        self.ctx, self.procs, self.raced = \
            multiprocessing.get_context("fork"), [], 0

    def Pipe(self, duplex=True):
        parent, child = self.ctx.Pipe(duplex=duplex)
        return _LatePipe(parent, self, len(self.procs)), child

    def Process(self, target, **kw):
        proc = self.ctx.Process(target=_late(target), **kw)
        self.procs.append(proc)
        return proc


class _LatePipe:
    def __init__(self, conn, owner, index):
        self.conn, self.owner, self.index, self.first = conn, owner, index, \
            True

    def poll(self, timeout=0.0):
        if self.first:
            self.first = False
            if not self.conn.poll(0):       # nothing sent yet: the race
                self.owner.raced += 1
                assert self.conn.poll(30)   # the worker sends ...
                self.owner.procs[self.index].join(30)   # ... and exits
                assert self.owner.procs[self.index].exitcode == 0
                return False
        return self.conn.poll(timeout)

    def recv(self):
        return self.conn.recv()

    def close(self):
        self.conn.close()


def test_ft_worker_that_sends_and_exits_before_the_poll_counts_as_ok(
        monkeypatch):
    spec = _spec(300)
    want = Experiment(spec).run().summary()
    late = _LateContext()
    monkeypatch.setattr(multiprocessing, "get_context",
                        lambda method=None: late)
    results, report = sweep([spec], workers=1, return_report=True)
    assert late.raced == 1 and len(late.procs) == 1
    assert report.counts() == {"ok": 1}
    assert results[0].summary() == want


def _record_start_methods(monkeypatch):
    """Make ``multiprocessing.get_context`` hand out contexts that record,
    for each process they start, the start method they were asked for;
    returns that list."""
    started = []
    real_get_context = multiprocessing.get_context

    class Recording:
        def __init__(self, method=None):
            self.method, self.ctx = method, real_get_context(method)

        def Process(self, *args, **kw):
            started.append(self.method)
            return self.ctx.Process(*args, **kw)

        def __getattr__(self, name):
            return getattr(self.ctx, name)
    monkeypatch.setattr(multiprocessing, "get_context", Recording)
    return started


def test_ft_pool_starts_surrogate_jobs_with_the_default_context(
        monkeypatch):
    """Surrogate-only jobs keep the platform's default start method (the
    reference's); the spawn method is for real-learner jobs."""
    started = _record_start_methods(monkeypatch)
    specs = [_spec(310), _spec(311)]
    results, report = sweep(specs, workers=2, return_report=True)
    assert report.all_ok and started == [None, None]
    assert _summaries(results) == [Experiment(s).run().summary()
                                   for s in specs]


# -------------------------------------------- real learners, spawned
def _real_spec(mode):
    """tests/test_torch_experiment.py's tiny real-learner spec."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    cfg = dataclasses.replace(
        reduced(get_config("paper-charlm"), layers=1, d_model=64, d_ff=64,
                vocab=256), lstm_hidden=64, max_context=16)
    fed = FederatedConfig(mode=mode, concurrency=6,
                          aggregation_goal=4 if mode == "sync" else 3,
                          client_lr=0.3, server_lr=0.02, client_batch_size=8,
                          staleness_cap=8, compression="int8")
    run = RunConfig(target_perplexity=1.0, max_rounds=4, max_hours=1e6,
                    eval_clients=4)
    return ExperimentSpec(model=ModelRef.from_config(cfg), federated=fed,
                          run=run, learner="real", seq_len=16,
                          max_client_steps=3)


def test_real_learner_sweep_runs_in_spawned_workers(monkeypatch):
    """Two real-learner specs on the CPU with workers=2: the pool is
    started with "spawn", each Result crosses the pipe with float
    perplexities, and the summaries equal the same specs run in this
    process bit for bit. Against the reference package's sweep every
    summary key, the participation and the mean staleness are equal; the
    port's seeded init is not JAX's, so the perplexity is held finite here
    (tests/test_torch_experiment.py holds it within rel 1e-4 from the JAX
    learner's own weights)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    specs = [_real_spec("sync"), _real_spec("async")]
    contexts = []
    real_get_context = multiprocessing.get_context

    def spy(method=None):
        contexts.append(method)
        return real_get_context(method)
    monkeypatch.setattr(multiprocessing, "get_context", spy)
    spawned = sweep(specs, workers=2, device="cpu")
    assert contexts == ["spawn"]
    here = sweep(specs, workers=1, device="cpu")
    for a, b in zip(spawned, here):
        assert type(a.final_perplexity) is float
        assert type(a.smoothed_perplexity) is float
        assert _fingerprint(a) == _fingerprint(b)
    ref_specs = [ref_api.ExperimentSpec.from_json(s.to_json())
                 for s in specs]
    assert [s.content_hash() for s in ref_specs] == \
        [s.content_hash() for s in specs]
    for got, want in zip(spawned, ref_api.sweep(ref_specs, workers=1)):
        g, w = got.summary(), want.summary()
        assert sorted(g) == sorted(w)
        assert math.isfinite(g["perplexity"])
        assert {k: v for k, v in g.items() if k != "perplexity"} == \
            {k: v for k, v in w.items() if k != "perplexity"}
        assert got.log.participation() == want.log.participation()
        assert got.log.mean_staleness() == want.log.mean_staleness()


def test_real_learner_ft_sweep_spawns_each_real_job(monkeypatch):
    """The fault-tolerant scheduler picks the start method job by job:
    "spawn" for the real-learner spec, the default for the surrogate."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    specs = [_real_spec("sync"), _spec(320)]
    started = _record_start_methods(monkeypatch)
    results, report = sweep(specs, workers=2, device="cpu",
                            return_report=True)
    assert report.counts() == {"ok": 2}
    assert started == ["spawn", None]
    assert results[0].summary() == Experiment(
        specs[0], device="cpu").run().summary()
    assert results[1].summary() == Experiment(specs[1]).run().summary()
