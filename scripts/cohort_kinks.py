"""Where the batched cohort step and the per-client step part at full
width, on the card:

    PYTHONPATH=src python scripts/cohort_kinks.py

Builds chip_smoke.py's phase 3b cohort (paper-charlm at full width, 16
clients with 1 to 8 local steps, client batch 16, seq_len 64, client_lr
0.3) and prints one JSON line with:
  * ``noise_by_steps``: for the first 8-step client, how far the
    per-client step's delta after k steps moves when the base params get a
    relative noise of 1e-7 (one f32 rounding), k = 1..8;
  * ``steps``: every local step of every client taken from the base
    params, batched (the graph-replayed cohort step) against per client
    (``make_client_update``), the largest difference of each;
  * ``parted``: for each step where the two differ by more than 1e-5, both
    against the per-client step in float64 on the card and in float32 on
    the CPU, and the count of the MLP's ReLU inputs within 1e-6 of 0 on
    that batch.
Needs a CUDA device.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402
from repro_torch.configs import (FederatedConfig, RunConfig,  # noqa: E402
                                 get_config)
from repro_torch.data import FederatedDataset  # noqa: E402
from repro_torch.federated import RealLearner  # noqa: E402
from repro_torch.federated.client import (make_client_update,  # noqa: E402
                                          make_cohort_update, stack_batches,
                                          to_device)

STEPS = 8


def max_abs(a, b):
    return max(float((a[k].double() - b[k].double().to(a[k].device))
                     .abs().max()) for k in a)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config("paper-charlm")
    fed = FederatedConfig(client_lr=0.3, client_batch_size=C.BATCH,
                          compression="none", seed=C.SEED)
    ds = FederatedDataset(vocab_size=cfg.vocab_size, seq_len=C.SEQ_LEN,
                          char_vocab=cfg.char_vocab,
                          max_word_len=cfg.max_word_len)
    learner = RealLearner(cfg, fed, RunConfig(), ds, max_client_steps=STEPS,
                          seed=C.SEED, device=dev)
    base, model = learner.params, learner.model
    ids = C.ragged_cohort(ds, fed, STEPS)
    stacked = [stack_batches(ds.client_batches(c, C.BATCH), STEPS)
               for c in ids]
    inputs = to_device({k: np.stack([s[k] for s, _ in stacked])
                        for k in stacked[0][0]}, dev)
    masks = np.stack([m for _, m in stacked])
    looped = make_client_update(model.loss, fed.client_lr)
    batched = make_cohort_update(model.loss, fed.client_lr)

    g = torch.Generator(device=dev).manual_seed(C.SEED + 2)
    noisy = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=g,
                                            device=dev))
             for k, v in base.items()}
    first = {k: v[0] for k, v in inputs.items()}
    noise_by_steps = []
    for k in range(1, STEPS + 1):
        m = np.zeros(STEPS, np.float32)
        m[:k] = 1.0
        noise_by_steps.append(max_abs(looped(noisy, first, m)[0],
                                      looped(base, first, m)[0]))

    def one(i, k):
        return {n: v[i, k:k + 1] for n, v in inputs.items()}

    steps, parted = [], []
    base64 = {k: v.double() for k, v in base.items()}
    base_cpu = {k: v.cpu() for k, v in base.items()}
    unit = np.ones(1, np.float32)
    for k in range(STEPS):
        only = np.zeros_like(masks)
        only[:, k] = masks[:, k]
        cur, _ = batched(base, inputs, only)
        for i in range(len(ids)):
            if masks[i, k] == 0:
                continue
            got = {n: v[i] for n, v in cur.items()}
            d32 = looped(base, one(i, k), unit)[0]
            err = max_abs(got, d32)
            steps.append({"client": i, "step": k, "max_abs_err": err})
            if err <= 1e-5:
                continue
            d64 = looped(base64, one(i, k), unit)[0]
            d_cpu = looped(base_cpu, {n: v.cpu() for n, v in
                                      one(i, k).items()}, unit)[0]
            with torch.no_grad():
                chars = one(i, k)["chars"][0]
                x = model.word_embed(base, chars)
                x, _ = model._stack(base, x,
                                    model._zero_states(chars.shape[0], x))
                z = x @ base["mlp/w1"] + base["mlp/b1"]
            parted.append({
                "client": i, "step": k, "batched_vs_per_client": err,
                "batched_vs_f64": max_abs(got, d64),
                "per_client_vs_f64": max_abs(d32, d64),
                "per_client_cpu_vs_f64": max_abs(d_cpu, d64),
                "relu_inputs_within_1e-6_of_0": int((z.abs() < 1e-6).sum()),
                "relu_inputs": z.numel()})
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "noise_by_steps": noise_by_steps,
                      "steps_within_1e-5": sum(s["max_abs_err"] <= 1e-5
                                               for s in steps),
                      "steps": steps, "parted": parted}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
