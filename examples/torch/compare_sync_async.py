"""Reproduce the paper's Figure 5 story on the PyTorch port: sync vs async
FL at equal tuning — async converges faster in wall-clock but burns more
carbon. Both arms are the same `repro_torch.api.ExperimentSpec` with the
strategy key swapped (the reference's ``examples/compare_sync_async.py``).

  PYTHONPATH=src python examples/torch/compare_sync_async.py

Both arms run the surrogate learner, which touches no device, so this
example takes no ``--device``.
"""
from repro_torch.api import Experiment, ExperimentSpec, ModelRef
from repro_torch.configs import FederatedConfig, RunConfig


def main() -> int:
    base = ExperimentSpec(model=ModelRef("paper-charlm"),
                          run=RunConfig(target_perplexity=175.0),
                          learner="surrogate")

    print(f"{'mode':6s} {'rounds':>7s} {'hours':>7s} {'kgCO2e':>8s} "
          f"{'sessions':>9s} {'staleness':>9s}")
    for mode in ("sync", "async"):
        spec = base.replace(federated=FederatedConfig(
            mode=mode, concurrency=1000, aggregation_goal=1000))
        res = Experiment(spec).run()
        print(f"{mode:6s} {res.rounds:7d} {res.duration_h:7.1f} "
              f"{res.carbon.total_kg:8.2f} {res.log.n_sessions:9d} "
              f"{res.log.mean_staleness():9.2f}")

    print("\npaper finding: async advances the model faster (stragglers "
          "never block)\nbut keeps `concurrency` devices busy the whole time "
          "-> more sessions -> more CO2e.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
