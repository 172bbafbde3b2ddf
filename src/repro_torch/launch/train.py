"""Production train driver: run a federated task end-to-end with full
carbon telemetry — a thin CLI over `repro_torch.api.Experiment`, a copy of
the reference package's ``launch/train.py``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-charlm \\
      --reduced --mode sync --concurrency 8 --rounds 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --mode async \\
      --concurrency 20 --aggregation-goal 16 --rounds 3 --seq-len 64 \\
      --batch-size 16 --compression int8 --ckpt ck      # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --mode async --concurrency 6 --rounds 20 --ckpt ck \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --spec exp.json   # replay one

``--device`` (default ``cuda``) is where the real learner runs; without a
card it raises unless ``--device cpu``. ``--surrogate`` runs need no
device. The real learner trains the CharLM (``paper-charlm``) and the
dense transformers (``smollm-135m``; on the card at full width without
``--reduced``); RWKV6's ``loss`` is not ported yet and raises. ``--ckpt``
writes the learner's final params through ``repro_torch.checkpoint``, in
the reference package's format.
"""
from __future__ import annotations

import json
import time

import argparse

from repro_torch.api import Experiment, ExperimentSpec, ModelRef
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import FederatedConfig, RunConfig, get_config


def reduced_model_ref(arch: str) -> ModelRef:
    """The driver's CPU-trainable shrink recipe, recorded declaratively."""
    family = get_config(arch).family
    overrides = {}
    if family == "charlm":
        overrides = dict(lstm_hidden=128, max_context=16)
    return ModelRef(arch=arch, reduced=True,
                    reduced_kw=dict(layers=3 if family == "hybrid" else 2,
                                    d_model=128, d_ff=256, vocab=512),
                    overrides=overrides)


def spec_from_args(args) -> ExperimentSpec:
    model = reduced_model_ref(args.arch) if args.reduced \
        else ModelRef(arch=args.arch)
    fed = FederatedConfig(
        mode=args.mode, concurrency=args.concurrency,
        aggregation_goal=args.aggregation_goal or
        max(1, int(args.concurrency * 0.8)),
        client_lr=args.client_lr, server_lr=args.server_lr,
        local_epochs=args.local_epochs, client_batch_size=args.batch_size,
        compression=args.compression)
    run = RunConfig(target_perplexity=args.target_ppl,
                    max_rounds=args.rounds, max_hours=1e9)
    return ExperimentSpec(
        model=model, federated=fed, run=run,
        learner="surrogate" if args.surrogate else "real",
        seq_len=args.seq_len)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="paper-charlm")
    p.add_argument("--mode", default="sync", choices=("sync", "async"))
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--aggregation-goal", type=int, default=0)
    p.add_argument("--client-lr", type=float, default=0.3)
    p.add_argument("--server-lr", type=float, default=0.02)
    p.add_argument("--local-epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--rounds", type=int, default=50)
    p.add_argument("--target-ppl", type=float, default=1.0)
    p.add_argument("--seq-len", type=int, default=16)
    p.add_argument("--compression", default="none", choices=("none", "int8"))
    p.add_argument("--reduced", action="store_true",
                   help="tiny same-family variant (CPU-trainable)")
    p.add_argument("--surrogate", action="store_true",
                   help="carbon-only simulation, no real training")
    p.add_argument("--spec", default="",
                   help="load an ExperimentSpec JSON (overrides other args)")
    p.add_argument("--save-spec", default="",
                   help="write the assembled ExperimentSpec JSON and exit")
    p.add_argument("--ckpt", default="")
    p.add_argument("--checkpoint", default="",
                   help="engine-snapshot path: checkpoint the mid-run "
                        "engine state there (surrogate learner only)")
    p.add_argument("--checkpoint-every", type=int, default=50,
                   help="rounds between engine snapshots (with "
                        "--checkpoint)")
    p.add_argument("--resume", default="",
                   help="resume from an engine snapshot (the spec "
                        "travels inside it; other args are ignored)")
    p.add_argument("--json", default="")
    p.add_argument("--device", default="cuda",
                   help="where the real learner runs (cuda or cpu)")
    args = p.parse_args(argv)

    if args.resume:
        t0 = time.time()
        res = Experiment.resume(
            args.resume,
            checkpoint_path=args.checkpoint or None,
            checkpoint_every_rounds=args.checkpoint_every
            if args.checkpoint else 0)
        s = res.summary()
        print(f"[train] resumed {args.resume} -> rounds={s['rounds']:.0f} "
              f"ppl={s['perplexity']:.1f} "
              f"carbon={s['carbon_total_kg']*1000:.2f} gCO2e "
              f"(wall {time.time()-t0:.0f}s)")
        if args.json:
            with open(args.json, "w") as f:
                json.dump(s, f, indent=1)
        return 0

    spec = ExperimentSpec.load(args.spec) if args.spec else \
        spec_from_args(args)
    if args.save_spec:
        spec.save(args.save_spec)
        print(f"[train] spec -> {args.save_spec}")
        return 0

    exp = Experiment(spec, device=args.device)
    if spec.learner == "real":
        print(f"[train] initial perplexity "
              f"{exp.build_learner().eval_perplexity():.1f}")
    t0 = time.time()
    res = exp.run(checkpoint_path=args.checkpoint or None,
                  checkpoint_every_rounds=args.checkpoint_every
                  if args.checkpoint else 0)
    s = res.summary()
    arch = spec.model.arch or exp.model_config.name
    print(f"[train] {arch} {spec.federated.mode} rounds={s['rounds']:.0f} "
          f"ppl={s['perplexity']:.1f} simulated={s['duration_h']:.2f}h "
          f"carbon={s['carbon_total_kg']*1000:.2f} gCO2e "
          f"(wall {time.time()-t0:.0f}s)")
    print(f"[train] carbon shares: "
          + " ".join(f"{k}={v:.2f}" for k, v in res.carbon.shares().items()))
    if args.ckpt and spec.learner == "real":
        save_checkpoint(args.ckpt, {"params": exp.learner.params},
                        meta={"rounds": res.rounds, "arch": arch})
        print(f"[train] checkpoint -> {args.ckpt}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(s, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
