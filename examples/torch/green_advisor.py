"""Pre-deployment carbon planning on the PyTorch port (paper §5.3 + C4):
search the config space with the surrogate, print the (time, carbon)
Pareto frontier and the greenest config that meets a deadline, then fit
the carbon predictor (the reference's ``examples/green_advisor.py``).

  PYTHONPATH=src python examples/torch/green_advisor.py

The advisor simulates surrogate specs only, which touch no device, so this
example takes no ``--device``.
"""
from repro_torch.configs import FederatedConfig, RunConfig, get_config
from repro_torch.core.advisor import GreenAdvisor
from repro_torch.core.predictor import CarbonPredictor


def main() -> int:
    cfg = get_config("paper-charlm")
    advisor = GreenAdvisor(cfg, RunConfig(target_perplexity=175.0,
                                          max_hours=24.0))

    grid = dict(mode=("sync",), concurrency=(50, 100, 200, 800),
                local_epochs=(1, 3), compression=("none", "int8"))
    recs = advisor.search(grid=grid)

    print("(time, carbon) Pareto frontier:")
    for r in GreenAdvisor.pareto(recs):
        print("  " + r.why())

    best = recs[0]
    print("\ngreenest feasible config:\n  " + best.why())
    deadline = advisor.search(grid=grid, max_hours=18.0)[0]
    # recommendations carry a `feasible` flag: an impossible deadline
    # returns the least-bad candidates explicitly marked [INFEASIBLE]
    print("greenest under an 18h deadline:\n  " + deadline.why())
    impossible = advisor.search(grid=grid, max_hours=0.01)[0]
    print("under an impossible 36s deadline:\n  " + impossible.why())

    # the paper's predictor: carbon ≈ a (concurrency x rounds) + b, fit on
    # a dedicated calibration set (one wire format, tuned lrs, E=1 — the
    # paper fits one line per task/format since int8 halves the slope)
    calib = [advisor.evaluate(FederatedConfig(
        mode="sync", concurrency=c, aggregation_goal=int(c * 0.8)))
        for c in (50, 100, 200, 400, 800)]
    pred = CarbonPredictor.from_measurements(
        "sync", [r.fed.concurrency for r in calib],
        [r.rounds for r in calib], [r.carbon_kg for r in calib])
    print(f"\npredictor fit: slope={pred.fit.slope:.3e} kg per "
          f"client-round, R^2={pred.fit.r2:.3f}")
    print(f"forecast for concurrency=1000 x 250 rounds: "
          f"{pred.predict_kg(1000, 250):.1f} kg CO2e")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
