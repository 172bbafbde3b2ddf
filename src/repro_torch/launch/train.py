"""Trainer entry point of the port: synchronous FedAvg rounds of its learner.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-charlm \\
      --concurrency 20 --aggregation-goal 16 --rounds 3 --compression int8 \\
      --seq-len 64 --batch-size 16
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --concurrency 4 --aggregation-goal 2 --rounds 2 --seq-len 8
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import FederatedConfig, RunConfig, get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.data import FederatedDataset
from repro_torch.federated import RealLearner, client

_POPULATION = 5_000_000  # eligible-device pool the coordinator selects from
MAX_CLIENT_STEPS = 8

_HELP = """Runs synchronous FedAvg rounds of the paper's CharLM on the port's
learner: each round draws a cohort of `concurrency` clients, the first
`aggregation-goal` of them train and upload their deltas (through the int8
codec with --compression int8), and the server takes a FedAdam step and
evaluates perplexity. Session timing, dropout and carbon accounting belong
to the reference's event engine, which a later slice of the port brings
over; here every selected client up to the goal contributes."""


def _select_cohort(rng: np.random.Generator, k: int,
                   population: int) -> np.ndarray:
    """Coordinator client selection: unique per round, without replacement
    (the reference engine's rule)."""
    return rng.choice(population, size=k, replace=False).astype(np.int64)


def reduced_config(arch: str) -> ModelConfig:
    """The reference trainer's CPU-trainable shrink recipe for charlm."""
    cfg = reduced(get_config(arch), layers=2, d_model=128, d_ff=256, vocab=512)
    return dataclasses.replace(cfg, lstm_hidden=128, max_context=16)


@dataclasses.dataclass
class RoundRecord:
    round: int
    perplexity: float
    wall_s: float
    contributors: List[int]
    graph_replays: int            # cohort-step CUDA graph replays (card)
    graph_captures: int


def run(cfg: ModelConfig, fed: FederatedConfig, rounds: int, seq_len: int,
        device: torch.device | str = "cuda") -> List[RoundRecord]:
    """`rounds` sync rounds; returns one record per round. Each round's wall
    time ends with the device synchronised after the eval. The records
    count the round's cohort-step graph replays and captures from
    ``client.GRAPH_COUNTS``, which they do not reset."""
    dev = resolve_device(device)
    ds = FederatedDataset(vocab_size=cfg.vocab_size, seq_len=seq_len,
                          char_vocab=cfg.char_vocab,
                          max_word_len=cfg.max_word_len)
    learner = RealLearner(cfg, fed, RunConfig(max_rounds=rounds), ds,
                          max_client_steps=MAX_CLIENT_STEPS, seed=fed.seed,
                          device=dev)
    print(f"[train] {cfg.name}: {cfg.param_count():,} params on {dev}; "
          f"initial perplexity {learner.eval_perplexity():.3f}")
    rng = np.random.default_rng(fed.seed)
    out = []
    for r in range(1, rounds + 1):
        t0 = time.perf_counter()
        graphs0 = dict(client.GRAPH_COUNTS)
        cohort = _select_cohort(rng, fed.concurrency, _POPULATION)
        contributors = cohort[:fed.aggregation_goal].tolist()
        deltas, weights = learner.client_deltas(contributors)
        learner.apply(deltas, weights, n_contributors=len(contributors))
        ppl = learner.eval_perplexity()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec = RoundRecord(
            r, ppl, time.perf_counter() - t0, contributors,
            client.GRAPH_COUNTS["replays"] - graphs0["replays"],
            client.GRAPH_COUNTS["captures"] - graphs0["captures"])
        print(f"[train] round {r}: perplexity {ppl:.3f} wall {rec.wall_s:.3f} "
              f"s, {rec.graph_replays} graph replays, {rec.graph_captures} "
              f"captures")
        out.append(rec)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=_HELP)
    p.add_argument("--arch", default="paper-charlm")
    p.add_argument("--reduced", action="store_true",
                   help="tiny same-family variant (CPU-trainable)")
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--aggregation-goal", type=int, default=0,
                   help="contributors per round (default 80%% of concurrency)")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--compression", default="none", choices=("none", "int8"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    fed = FederatedConfig(
        mode="sync", concurrency=args.concurrency,
        aggregation_goal=args.aggregation_goal
        or max(1, int(args.concurrency * 0.8)),
        client_lr=0.3, server_lr=0.02, client_batch_size=args.batch_size,
        compression=args.compression)
    run(cfg, fed, args.rounds, args.seq_len, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
