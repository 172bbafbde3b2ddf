#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:
  1. build every CUDA kernel of the port from the sources in this checkout
     (one nvcc per source, all started together);
  2. print the card's name and power limit (nvidia-smi);
  3. hold each kernel against its plain PyTorch version on the card, at
     every leaf shape of a full-width paper-charlm client delta and at the
     stacked cohort shapes (16, ...) the sync round gives it;
  4. time each kernel and its plain version with CUDA events, in turns
     (plain, kernel, kernel, plain), at the cohort shapes of one round;
  5. drive the port's main path, ``repro_torch.launch.train``: 3 sync
     FedAvg rounds of paper-charlm at full width (15,560,704 params),
     concurrency 20, goal 16, seq_len 64, client batch 16, 8 client steps,
     int8 uplink; the kernels' launch counts are reset just before and read
     just after, and every kernel must have run there;
  6. check the outputs: finite perplexities, and on a small config one
     round on the card agrees with the same round on the CPU (plain
     versions of the kernels).

Before the last line it prints the kernels as one JSON object and the card's
name and power limit; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
ROUNDS, CONCURRENCY, GOAL, SEQ_LEN, BATCH = 3, 20, 16, 64, 16
BLOCK = 256                    # FederatedConfig.quant_block
SEED = 0
TPU_KERNELS = {                # kernel -> the TPU function it replaces
    "int8_quantize": "src/repro/kernels/int8_quant/kernel.py:32",
    "int8_dequant_accumulate": "src/repro/kernels/int8_quant/kernel.py:68",
}
CHECKS = {                     # what phase 3 held each kernel to (passed)
    "int8_quantize": "q bit-equal, scales rtol 1e-6; 24 leaf shapes alone "
                     "and stacked x16, bf16 input, an all-zero block",
    "int8_dequant_accumulate": "atol 1e-5 with an accumulator, bit-equal "
                               "as dequantize; 24 leaf shapes alone and "
                               "stacked x16",
}
CU_SOURCE = "src/repro_torch/kernels/int8_quant/csrc/int8_quant.cu"


def fail(msg: str) -> int:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr)
    return 1


def phase(name: str) -> None:
    print(f"[chip_smoke] --- {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, after one warm-up."""
    import torch
    fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(plain, kernel, reps: int):
    """plain, kernel, kernel, plain -> (kernel ms, plain ms), each the mean
    of its two turns."""
    p1 = cuda_time_ms(plain, reps)
    k1 = cuda_time_ms(kernel, reps)
    k2 = cuda_time_ms(kernel, reps)
    p2 = cuda_time_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        return fail(f"no port package under {SRC}: run from a checkout")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import FederatedConfig, get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.int8_quant import kernel as K
    from repro_torch.kernels.int8_quant import ref as R
    from repro_torch.launch import train
    from repro_torch.models import get_model

    dev = torch.device("cuda", 0)

    phase("1. build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[chip_smoke] built {sorted(libs)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())

    phase("2. card")
    card = card_line()
    print(f"[chip_smoke] card: {card}")

    phase("3. kernels against their plain versions")
    cfg = get_config("paper-charlm")
    shapes, _ = get_model(cfg).init(device="meta")
    leaf_shapes = {k: tuple(v.shape) for k, v in shapes.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = {"int8_quantize": 0.0, "int8_dequant_accumulate": 0.0}
    for stack in (None, GOAL):
        for k, shp in leaf_shapes.items():
            full = shp if stack is None else (stack,) + shp
            x = torch.randn(full, generator=gen, device=dev) * 1e-3
            q, s = K.quantize(x, BLOCK)
            q0, s0 = R.quantize_ref(x, BLOCK)
            if not torch.equal(q, q0):
                return fail(f"int8_quantize q differs at {k} {full}: "
                            f"{int((q != q0).sum())} elements")
            if not torch.allclose(s, s0, rtol=1e-6, atol=0):
                return fail(f"int8_quantize scales differ at {k} {full}")
            err["int8_quantize"] = max(err["int8_quantize"],
                                       float((s - s0).abs().max()))
            deq = K.dequant_accumulate(None, q, s, 1.0, x.numel(), BLOCK)
            if not torch.equal(deq, R.dequantize_ref(q, s, (x.numel(),),
                                                     BLOCK)):
                return fail(f"dequantize (K2, no accumulator) differs at {k}")
            acc = torch.randn(x.numel(), generator=gen, device=dev)
            got = K.dequant_accumulate(acc, q, s, 0.37, x.numel(), BLOCK)
            e = float((got - R.dequant_accumulate_ref(acc, q, s, 0.37,
                                                      BLOCK)).abs().max())
            if not e <= 1e-5:
                return fail(f"int8_dequant_accumulate differs at {k}: {e}")
            err["int8_dequant_accumulate"] = max(
                err["int8_dequant_accumulate"], e)
    # bf16 input is cast to f32 first; an all-zero block gets scale 1
    xb = torch.randn(3, 1000, generator=gen, device=dev).to(torch.bfloat16)
    xb[0] = 0
    q, s = K.quantize(xb, BLOCK)
    q0, s0 = R.quantize_ref(xb, BLOCK)
    if not (torch.equal(q, q0) and torch.equal(s, s0) and float(s[0]) == 1.0):
        return fail("int8_quantize differs on bf16 / all-zero input")
    torch.cuda.synchronize()
    print(f"[chip_smoke] checked {len(leaf_shapes)} leaf shapes, alone and "
          f"stacked x{GOAL}: q bit-equal, scales rtol 1e-6, "
          f"accumulate max abs err {err['int8_dequant_accumulate']:.3g}")

    phase("4. timing at the cohort shapes of one round")
    cohort = [torch.randn((GOAL,) + shp, generator=gen, device=dev) * 1e-3
              for shp in leaf_shapes.values()]
    quant = [K.quantize(x, BLOCK) for x in cohort]
    accs = [torch.randn(x.numel(), generator=gen, device=dev) for x in cohort]
    ns = [x.numel() for x in cohort]
    nbs = [-(-n // BLOCK) for n in ns]
    bytes_k1 = sum(4 * n + nb * BLOCK + 4 * nb for n, nb in zip(ns, nbs))
    # the main path runs K2 with no accumulator (the dequantize): q and the
    # scales in, f32 out
    bytes_k2 = sum(n + 4 * nb + 4 * n for n, nb in zip(ns, nbs))
    bytes_k2_acc = bytes_k2 + 4 * sum(ns)
    reps = 10
    k1_ms, k1_plain = in_turns(
        lambda: [R.quantize_ref(x, BLOCK) for x in cohort],
        lambda: [K.quantize(x, BLOCK) for x in cohort], reps)
    k2_ms, k2_plain = in_turns(
        lambda: [R.dequantize_ref(q, s, (n,), BLOCK)
                 for (q, s), n in zip(quant, ns)],
        lambda: [K.dequant_accumulate(None, q, s, 1.0, n, BLOCK)
                 for (q, s), n in zip(quant, ns)], reps)
    k2a_ms, k2a_plain = in_turns(
        lambda: [R.dequant_accumulate_ref(a, q, s, 0.37, BLOCK)
                 for (q, s), a in zip(quant, accs)],
        lambda: [K.dequant_accumulate(a, q, s, 0.37, n, BLOCK)
                 for (q, s), a, n in zip(quant, accs, ns)], reps)
    big = max(range(len(cohort)), key=lambda i: ns[i])
    xbig, (qbig, sbig), nbig = cohort[big], quant[big], ns[big]
    big_k1 = cuda_time_ms(lambda: K.quantize(xbig, BLOCK), 20)
    big_k2 = cuda_time_ms(
        lambda: K.dequant_accumulate(None, qbig, sbig, 1.0, nbig, BLOCK), 20)
    nbigb = -(-nbig // BLOCK)
    timing = {
        "int8_quantize": dict(
            ms=k1_ms, plain_ms=k1_plain,
            bound_ms=bytes_k1 / HBM_BYTES_PER_S * 1e3,
            largest_leaf={"shape": list(xbig.shape), "ms": big_k1,
                          "bound_ms": (4 * nbig + nbigb * BLOCK + 4 * nbigb)
                          / HBM_BYTES_PER_S * 1e3}),
        "int8_dequant_accumulate": dict(
            ms=k2_ms, plain_ms=k2_plain,
            bound_ms=bytes_k2 / HBM_BYTES_PER_S * 1e3,
            with_accumulator={"ms": k2a_ms, "plain_ms": k2a_plain,
                              "bound_ms": bytes_k2_acc / HBM_BYTES_PER_S * 1e3},
            largest_leaf={"shape": list(xbig.shape), "ms": big_k2,
                          "bound_ms": (5 * nbig + 4 * nbigb)
                          / HBM_BYTES_PER_S * 1e3}),
    }
    for name, t in timing.items():
        print(f"[chip_smoke] {name}: {t['ms']:.4f} ms per round's "
              f"{len(cohort)} launches (plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms)")
    del cohort, quant, accs, xbig, qbig, sbig

    phase("5. main path: repro_torch.launch.train at full width")
    fed = FederatedConfig(
        mode="sync", concurrency=CONCURRENCY, aggregation_goal=GOAL,
        client_lr=0.3, server_lr=0.02, client_batch_size=BATCH,
        compression="int8", seed=SEED)
    if train.MAX_CLIENT_STEPS != 8 or cfg.param_count() != 15_560_704:
        return fail("main path is not at the paper's full width")
    K.reset_launches()
    records = train.run(cfg, fed, ROUNDS, SEQ_LEN, device=dev)
    launches = dict(K.LAUNCHES)
    print(f"[chip_smoke] launches on the main path: {launches}")
    for name in TPU_KERNELS:
        if launches[name] == 0:
            return fail(f"{name} never ran on the main path")
    # one launch per leaf for each cohort compress
    if launches["int8_quantize"] != len(leaf_shapes) * ROUNDS:
        return fail(f"expected {len(leaf_shapes) * ROUNDS} int8_quantize "
                    f"launches, got {launches['int8_quantize']}")
    ppl = [r.perplexity for r in records]
    if len(records) != ROUNDS or not all(math.isfinite(p) for p in ppl):
        return fail(f"main path perplexities {ppl}")

    phase("6. a small round on the card against the same round on the CPU")
    from repro_torch.configs import RunConfig
    from repro_torch.data import FederatedDataset
    from repro_torch.federated import RealLearner
    from repro_torch.weights import params_to_numpy
    small = train.reduced_config("paper-charlm")
    ds = FederatedDataset(vocab_size=small.vocab_size, seq_len=16,
                          char_vocab=small.char_vocab,
                          max_word_len=small.max_word_len)
    cpu = RealLearner(small, fed, RunConfig(), ds, device="cpu")
    gpu = RealLearner(small, fed, RunConfig(), ds, device=dev,
                      init_params=params_to_numpy(cpu.params))
    cohort_ids = [3, 141, 5926]
    for lr in (cpu, gpu):
        d, w = lr.client_deltas(cohort_ids)
        lr.apply(d, w)
    p_cpu, p_gpu = cpu.eval_perplexity(), gpu.eval_perplexity()
    # int8 rounding of a delta whose last bit differs can flip one step
    if not math.isclose(p_gpu, p_cpu, rel_tol=1e-3):
        return fail(f"small round: card perplexity {p_gpu} vs CPU {p_cpu}")
    print(f"[chip_smoke] small round perplexity: card {p_gpu:.6f}, "
          f"CPU {p_cpu:.6f}")

    kernels = []
    for name, src in TPU_KERNELS.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": CU_SOURCE,
            "replaces": src, "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "check": CHECKS[name],
            **{k: v for k, v in t.items()
               if k not in ("ms", "plain_ms", "bound_ms")}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"rounds": [{"round": r.round, "perplexity": r.perplexity,
                                  "wall_s": r.wall_s} for r in records]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
