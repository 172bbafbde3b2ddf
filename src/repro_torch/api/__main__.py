"""Run an ExperimentSpec JSON from the command line.

  PYTHONPATH=src python -m repro_torch.api examples/specs/charlm_sync_small.json
  PYTHONPATH=src python -m repro_torch.api spec.json --roundtrip-check --out r.json
  PYTHONPATH=src python -m repro_torch.api spec.json --device cpu

--roundtrip-check re-serializes the loaded spec, reloads it and re-runs,
asserting both runs produce an identical Result.summary() — the
reproducibility contract CI smoke relies on. --device (default cuda) is
where a real learner runs; a surrogate spec needs no device.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.api import Experiment, ExperimentSpec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.api")
    p.add_argument("spec", help="path to an ExperimentSpec JSON file")
    p.add_argument("--out", default="", help="write Result.to_dict() JSON")
    p.add_argument("--roundtrip-check", action="store_true",
                   help="serialize->reload->rerun and compare summaries")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where a real learner runs (cuda or cpu)")
    args = p.parse_args(argv)

    spec = ExperimentSpec.load(args.spec)
    on_round = None
    if not args.quiet:
        on_round = lambda ev: print(  # noqa: E731
            f"[api] round {ev.round_idx:5d} t={ev.t_s/3600.0:7.2f}h "
            f"ppl={ev.perplexity:8.1f} sessions={ev.n_sessions}")
    res = Experiment(spec, device=args.device).run(on_round=on_round)
    s = res.summary()
    print(f"[api] {spec.federated.mode} rounds={s['rounds']:.0f} "
          f"ppl={s['perplexity']:.1f} duration={s['duration_h']:.2f}h "
          f"carbon={s['carbon_total_kg']*1000:.2f} gCO2e "
          f"sessions={s['sessions']:.0f} (wall {res.wall_s:.1f}s)")

    if args.roundtrip_check:
        respec = ExperimentSpec.from_json(spec.to_json())
        s2 = Experiment(respec, device=args.device).run().summary()
        assert s == s2, f"round-trip mismatch:\n{s}\n{s2}"
        print("[api] roundtrip-check OK: reloaded spec reproduced the "
              "identical summary")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(res.to_dict(), f, indent=1)
        print(f"[api] result -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
