"""Quickstart on the PyTorch port: train the paper's char-CNN-LSTM
federatedly for a few rounds and read its carbon bill — the reference's
``examples/quickstart.py`` on ``repro_torch``, one declarative
`repro_torch.api.ExperimentSpec`.

  PYTHONPATH=src python examples/torch/quickstart.py                # the card
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu   # the CPU
"""
import argparse

from repro_torch.api import Experiment, ExperimentSpec, ModelRef
from repro_torch.configs import FederatedConfig, RunConfig


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="where the real learner runs (cuda or cpu)")
    args = p.parse_args(argv)

    # 1. one spec describes the whole run: the paper's workload shrunk so a
    #    laptop CPU trains it in ~1 min, a PAPAYA-shaped synchronous task
    #    (8 users/round, 4-min timeout, FedAdam server / client SGD, §3.3),
    #    and the port's real learner on non-IID power-law federated data
    spec = ExperimentSpec(
        model=ModelRef("paper-charlm", reduced=True,
                       reduced_kw=dict(layers=1, d_model=64, d_ff=64,
                                       vocab=256),
                       overrides=dict(lstm_hidden=64, max_context=16)),
        federated=FederatedConfig(mode="sync", concurrency=8,
                                  aggregation_goal=6, client_lr=0.3,
                                  server_lr=0.02, client_batch_size=8),
        run=RunConfig(target_perplexity=5.0, max_rounds=10, max_hours=1e6),
        learner="real", seq_len=16)

    # 2. specs are shareable artifacts: JSON out == JSON in
    assert ExperimentSpec.from_json(spec.to_json()) == spec

    # 3. run it, streaming per-round progress
    exp = Experiment(spec, device=args.device)
    print(f"initial perplexity: {exp.build_learner().eval_perplexity():8.1f}")
    result = exp.run(on_round=lambda ev: print(
        f"  round {ev.round_idx:2d} ppl={ev.perplexity:8.1f}"))
    print(f"final perplexity:   {result.final_perplexity:8.1f} "
          f"after {result.rounds} rounds")

    # 4. the carbon bill, by component (paper Fig. 5)
    print(f"\ncarbon: {result.carbon.total_kg * 1000:.3f} g CO2e "
          f"across {result.log.n_sessions} client sessions")
    for k, v in result.carbon.shares().items():
        print(f"  {k:16s} {v * 100:5.1f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
