"""Where the time of one full-width sync round goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_round

Runs the round of ``chip_smoke.py``'s main path (paper-charlm at full
width, concurrency 20, goal 16, seq_len 64, client batch 16, 8 client
steps, int8 uplink), whose clients train as one batched local step a
step, replayed from a CUDA graph: one warm-up round, then one round timed
by phase with the device synchronised at each phase's end, with its graph
replays and peak device memory, then one round under ``torch.profiler``,
whose device events give the kernel time by kind and the device's busy
share of the round. Prints one JSON object as its last line. Needs a CUDA
device.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api import ExperimentSpec
from repro_torch.configs import FederatedConfig, RunConfig, get_config
from repro_torch.data import FederatedDataset
from repro_torch.federated import RealLearner, client
from repro_torch.federated.runtime import _POPULATION, _select_cohort


def kernel_kind(name: str) -> str:
    n = name.lower()
    if "int8_" in n:
        return "int8 codec (K1/K2)"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "cublas", "sm90_",
                            "splitk", "gemv")):
        return "matmul (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if any(s in n for s in ("reduce", "sum", "norm", "softmax", "max")):
        return "reductions"
    return "elementwise and other"


def main() -> int:
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("paper-charlm")
    fed = FederatedConfig(mode="sync", concurrency=20, aggregation_goal=16,
                          client_lr=0.3, server_lr=0.02, client_batch_size=16,
                          compression="int8", seed=0)
    ds = FederatedDataset(vocab_size=cfg.vocab_size, seq_len=64,
                          char_vocab=cfg.char_vocab,
                          max_word_len=cfg.max_word_len)
    learner = RealLearner(cfg, fed, RunConfig(), ds,
                          max_client_steps=ExperimentSpec().max_client_steps,
                          device=dev)
    rng = np.random.default_rng(fed.seed)

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    def one_round():
        cohort = _select_cohort(rng, fed.concurrency, _POPULATION)
        ids = cohort[:fed.aggregation_goal].tolist()
        phases = {}
        batches, phases["host data (measured apart)"] = timed(
            lambda: [ds.client_batches(c, fed.client_batch_size) for c in ids])
        steps = [min(len(b), learner.max_steps) for b in batches]
        client.reset_graph_counts()
        (d, w), phases["client_deltas"] = timed(
            lambda: learner.client_deltas(ids))
        replays = client.GRAPH_COUNTS["replays"]
        _, phases["apply (FedAdam)"] = timed(lambda: learner.apply(d, w))
        _, phases["eval_perplexity"] = timed(learner.eval_perplexity)
        return phases, steps, replays

    one_round()                                     # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    phases, steps, replays = one_round()
    peak = torch.cuda.max_memory_allocated(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, prof_steps, prof_replays = one_round()
        torch.cuda.synchronize(dev)
        prof_wall = time.perf_counter() - t0
    by_kind, by_name, launches = defaultdict(float), defaultdict(float), 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.device_time_total
            by_kind[kernel_kind(e.name)] += us / 1e6
            by_name[e.name] += us / 1e6
            launches += 1
    busy = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    result = {
        "device": torch.cuda.get_device_name(dev),
        "round_phases_s": phases,
        "round_wall_s": sum(v for k, v in phases.items()
                            if k != "host data (measured apart)"),
        "client_steps_in_round": sum(steps),
        "graph_replays_in_round": replays,
        "largest_client_steps": max(steps),
        "peak_memory_bytes": peak,
        "profiled_round": {
            "wall_s": prof_wall, "client_steps": sum(prof_steps),
            "graph_replays": prof_replays,
            "device_events": launches,
            "device_busy_s": busy if busy > 0 else "not measured",
            "device_idle_share": 1 - busy / prof_wall if busy > 0
            else "not measured",
            "device_s_by_kind": dict(by_kind),
            "top_device_events_s": top},
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
