#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:
  1. build every CUDA kernel of the port from the sources in this checkout
     (one nvcc per source, all started together);
  2. print the card's name and power limit (nvidia-smi);
  3. hold each kernel against its plain PyTorch version on the card: K1/K2
     (int8 codec) at every leaf shape of a full-width paper-charlm client
     delta and at the stacked cohort shapes (16, ...) the sync round gives
     them, each leaf alone and all 24 as one table (K1 bit-equal to the
     per-leaf plain version), a ragged table and one longer than a launch
     takes; K3 (flash attention) at the serving shape (8, 1024, 9/3 heads,
     64) and the reference's kernel test cases (windows, non-causal, bf16, a
     ragged S, strided inputs); K4 (decode attention) at the serving shape
     (8 x 1088 slots, ragged valid lengths 1025..1088) and the reference's
     cases (valid_len 1, ragged, bf16), also replayed from a CUDA graph;
     K5 (WKV) at the prefill shape (8, 1024, 64 heads, 64) with model-scale
     inputs, at the decode shape (T 1, the state updated in place), the
     reference's 4 kernel cases in f32 and bf16, ragged T 1000 and 37,
     strided views of one fused tensor with one u per panel, 3 replays of a
     CUDA graph; K3's training kernels (f32): the forward with LSE (o
     bit-equal to the forward without it) and the dQ and dK/dV backward
     kernels against ``attention_bwd_ref`` (within 1e-4 of max(1, its
     largest entry)) at the training shapes (48 and 8 x 64 tokens, 9/3
     heads, 64), the serving length (8 x 1024), the forward's cases, 9
     query heads on one kv head and strided views; the folded launch of a
     6-client cohort and the autograd Function under vmap(grad) bit-equal
     to per-client launches;
  3b. hold the learner's cohort step (one batched local step over the
     stacked clients, replayed from a CUDA graph) at full width against the
     plain per-client step: a ragged 16-client cohort with 1 to 8 local
     steps (2 clients each), batch 16, seq_len 64, every client from the
     same base params: each local step from the base params against
     ``make_client_update``'s step on the same batch (loss within rel 1e-5,
     delta within atol 1e-4: see ``check_cohort``), the deltas bit-equal
     to the same vmapped step run eagerly, exactly 8 replays and 1
     capture, and the whole deltas printed beside the per-client step's
     own change under one f32 rounding of its inputs; the same for one
     ``client_delta`` (N = 1, 8 steps), whose whole delta is held within
     atol 1e-5 of the per-client step's;
  4. time each kernel, its plain version and (K3/K4) the one PyTorch call
     that computes the same function, with CUDA events, in turns (plain,
     kernel, kernel, plain), at the shapes of the main paths: K3 in f32 and
     bf16, each beside the bound of its tensor-core route (3xTF32, bf16
     mma) and the old f32 SIMT bound; K4 and its library call over 30
     distinct caches, one per layer as a decode step holds them (about
     400 MB, cold in L2), eagerly and inside a CUDA graph (device time, no
     host), and once on one cache warm in L2; K5 also inside a CUDA graph,
     and at the decode shape over 32 states, one per layer (cold in L2);
     K1 over a round's table of 24 leaves eagerly and in a CUDA graph,
     beside the per-leaf loop timed the same two ways, and the host wall
     of ``compress_roundtrip`` for one round; K3's training kernels at the
     sync training shape (48 x 64) and the serving length (8 x 1024),
     eagerly and in a CUDA graph: the forward with LSE, each backward kernel
     and the two together, beside the plain backward, SDPA's backward
     through autograd (``enable_gqa``, f32) and their bounds (10 D
     operations an attended pair for the whole backward at the 3xTF32 rate
     of their route, or the bytes at the HBM rate);
  5. drive the port's main paths, each with the kernels' launch counts
     reset just before and read just after:
     a. the train CLI, ``repro_torch.launch.train.main(["--spec", S,
        "--json", J, "--ckpt", D])``, on 5d's full-width sync spec S
        (written with ``spec.save``): 3 sync rounds of paper-charlm at full
        width (15,560,704 params), concurrency 20, goal 16, seq_len 64,
        client batch 16, 8 client steps, int8 uplink; the K1/K2 launches
        the engine's record implies (one of each a round) and, for each
        learner call, as many cohort-step graph replays as its longest
        client has local steps; after 5d, its JSON summary equals 5d's
        sync summary and every leaf of the checkpoint D equals 5d's sync
        learner's final params, bit for bit;
     b. ``repro_torch.launch.serve``: smollm-135m at full width (30 layers,
        134,515,008 params, f32), 8 requests of 1024 prompt tokens, then 64
        greedy tokens each; exactly 30 K3 and 30 x 64 K4 launches;
     c. ``repro_torch.launch.serve``: rwkv6-7b at full width (32 layers,
        7,576,621,056 params, f32), the same 8 requests and 64 tokens;
        exactly 32 + 32 x 64 K5 launches and no K3/K4;
     d. ``repro_torch.api.Experiment(spec).run()`` with the real learner on
        paper-charlm at full width, in sync, async and carbon-aware mode
        (3 server updates each, 5a's settings, the default Environment):
        the port's event engine and carbon accounting drive the learner;
        exactly the K1 and K2 launches the engine's record implies (one of
        each a sync round that is not starved, one of each a client of an
        async or carbon-aware update), and for each learner call the
        engine made as many graph replays as its longest client has local
        steps (a sync cohort) or as its one client has (async), with one
        capture for each cohort size;
     e. the spec CLI, ``repro_torch.api.__main__.main([S_async,
        "--roundtrip-check", "--out", R])`` on 5d's async spec (its two
        runs equal, as its own assertion holds, and equal to 5d's async
        run), then ``sweep([S_sync, S_async])`` with ``workers=1`` (in this
        process) and ``workers=2`` (two spawned worker processes on this
        card, which load phase 1's kernel builds): every summary equals
        5d's in its mode bit for bit; each wall and the card's peak memory
        while the sweep runs are printed, and what the two in-process runs
        hold on the card (graph pools, the default pool by stream, beyond
        the reserved segments);
     f. the reference train CLI's smollm-135m example at full width
        (134,515,008 params, f32): ``repro_torch.launch.train.main(["--arch",
        "smollm-135m", "--mode", "async", "--concurrency", "6", "--rounds",
        "3", "--seq-len", "64", "--compression", "int8", "--json", J,
        "--ckpt", D])``, then ``Experiment(spec).run()`` on its spec (saved
        with ``--save-spec``; summary and checkpoint bit-equal to the
        CLI's), then a sync spec through ``Experiment`` (concurrency 8,
        goal 6, batch 8); each run held as 5d's (K1/K2 from the engine's
        record, graph replays from the clients' batch counts, one capture
        a cohort size), with 30 launches of each K3 training kernel (the
        forward with LSE, dQ, dK/dV) at each capture and nothing else, one
        replay of the cohort graph under torch.profiler showing those 30
        of each, finite perplexities, update walls and peak memory;
  6. check the outputs: finite perplexities, and on a small config one
     round on the card agrees with the same round on the CPU (plain
     versions of the kernels); the three modes of 5d at a small size give
     the CPU's summary, participation and mean staleness (perplexity
     within rel 1e-3), and so do a sync and an async run of the reduced
     smollm-135m (wq/wk/wv rescaled: see ``small_experiments``); at full
     width and 2 layers one smollm cohort step on the card gives the CPU's
     delta (within 1e-4 of max(1, its largest entry)); 5d's summaries are
     finite with 3 rounds,
     sessions and carbon; generated tokens in the vocabulary and
     finite logits; at full width prefill(t[:-1]) + decode(t[-1]) equals
     the full forward's last logits (atol 2e-3 + rtol 2e-3, with wq/wk/wv
     at 1/sqrt(d_model): see ``serve_consistency``), and for rwkv6-7b (at
     full width, 4 layers, under the reference's init and a rescaled one)
     also the carried states equal the full prompt's (see
     ``rwkv_consistency``); a small serve of each model on the card gives
     the CPU's tokens.

Before the last line it prints the kernels as one JSON object and the card's
name and power limit; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.

    python3 chip_smoke.py --time-only [--src CHECKOUT/src]

runs phases 1, 2 and 4 only, on the port under ``--src`` (this checkout's
by default; its kernels build into that checkout's ``build/kernels``), and
prints the timings as one JSON line: the same yardstick for two checkouts,
to be run in turns (A, B, B, A) in one call on one card.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 rate without tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM dense TF32 tensor-core rate
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate
# K3's route: how many products of the route's type one f32 product costs,
# at which rate (3xTF32 splits each f32 product into three TF32 ones)
K3_ROUTE = {"float32": ("3xtf32", 3, TF32_FLOPS_PER_S),
            "bfloat16": ("bf16 mma", 1, BF16_FLOPS_PER_S)}
ROUNDS, CONCURRENCY, GOAL, SEQ_LEN, BATCH = 3, 20, 16, 64, 16
BLOCK = 256                    # FederatedConfig.quant_block
SERVE_ARCH, SERVE_BATCH, PROMPT_LEN, GEN = "smollm-135m", 8, 1024, 64
LAYERS = 30                    # smollm-135m: one K4 call a layer a step
RWKV_ARCH, RWKV_CHECK_LAYERS = "rwkv6-7b", 4
RWKV_LAYERS = 32               # rwkv6-7b: one K5 call a layer a step
SEED = 0
MODES = ("sync", "async", "carbon-aware")   # phase 5d: the engine's modes
TPU_KERNELS = {                # kernel -> the TPU function it replaces
    "int8_quantize": "src/repro/kernels/int8_quant/kernel.py:32",
    "int8_dequant_accumulate": "src/repro/kernels/int8_quant/kernel.py:68",
    "swa_attention": "src/repro/kernels/swa_attention/kernel.py:78",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:55",
    "wkv": "src/repro/kernels/wkv/kernel.py:49",
    "swa_attention_lse": "src/repro/kernels/swa_attention/kernel.py:78",
    "swa_attention_bwd_dq": "no Pallas counterpart: the gradient of "
                            "src/repro/models/common.py:137 flash_attention "
                            "(jax.checkpoint recompute)",
    "swa_attention_bwd_dkdv": "no Pallas counterpart: the gradient of "
                              "src/repro/models/common.py:137 "
                              "flash_attention (jax.checkpoint recompute)",
}
CU_SOURCES = {
    "int8_quantize": "src/repro_torch/kernels/int8_quant/csrc/int8_quant.cu",
    "int8_dequant_accumulate":
        "src/repro_torch/kernels/int8_quant/csrc/int8_quant.cu",
    "swa_attention":
        "src/repro_torch/kernels/swa_attention/csrc/swa_attention.cu",
    "decode_attention":
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
    "wkv": "src/repro_torch/kernels/wkv/csrc/wkv.cu",
    "swa_attention_lse":
        "src/repro_torch/kernels/swa_attention/csrc/swa_attention.cu",
    "swa_attention_bwd_dq":
        "src/repro_torch/kernels/swa_attention/csrc/swa_attention_bwd.cu",
    "swa_attention_bwd_dkdv":
        "src/repro_torch/kernels/swa_attention/csrc/swa_attention_bwd.cu",
}
CHECKS = {                     # what phase 3 held each kernel to (passed)
    "int8_quantize": "q and scales bit-equal to the per-leaf plain version; "
                     "24 leaf shapes alone and stacked x16, each alone and "
                     "all 24 as one table, a ragged table (also at blocks "
                     "96 and 1280), a table of 150 leaves (3 launches), "
                     "bf16 input, an all-zero block",
    "int8_dequant_accumulate": "atol 1e-5 with an accumulator, bit-equal "
                               "as dequantize; 24 leaf shapes alone and "
                               "stacked x16",
    "swa_attention": "f32 atol 2e-5, bf16 2e-2; serving shape, the "
                     "reference's 5 cases (windows 16/32/96) in f32 and "
                     "bf16, non-causal, ragged S 1000 and 37, strided q/k/v",
    "decode_attention": "f32 atol 1e-5, bf16 3e-2; serving shape with "
                        "ragged valid 1025..1088 in f32 and bf16, the "
                        "reference's 3 cases (full, ragged, valid 1), a "
                        "scalar valid_len, C 100, 3 replays of a CUDA "
                        "graph; arrival counters left at 0",
    "wkv": "o and S_T within 3e-5 (f32) / 3e-2 (bf16) times max(1, the "
           "plain version's largest entry); prefill shape at model scale "
           "(r/k/v std 8), decode shape T 1 with the state in place, the "
           "reference's 4 cases in f32 and bf16, ragged T 1000 and 37, "
           "strided views with one u per panel, 3 replays of a CUDA graph",
    "swa_attention_lse": "o bit-equal to the forward without LSE, lse within "
                         "1e-5 x max(1, |ref|) (f32); the shapes of "
                         "swa_attention_bwd_dq",
    "swa_attention_bwd_dq": "within 1e-4 x max(1, |ref|) in f32 at "
                            "(48, 64, 9/3, 64) and (8, 64, 9/3, 64) causal, "
                            "(8, 1024, 9/3, 64), the forward's cases "
                            "(windows, non-causal, ragged S, D "
                            "16/32/64/128), 9 query heads on one kv head "
                            "and strided views; the folded "
                            "6 x 8 launch and vmap(grad) bit-equal to "
                            "per-client launches; bf16 raises",
    "swa_attention_bwd_dkdv": "as swa_attention_bwd_dq, dk and dv",
}
# K3 cases: B, S, Hq, Hkv, D, window, causal (the reference's kernel tests,
# non-causal, then ragged S)
ATTN_CASES = [(1, 64, 2, 2, 32, 0, True), (2, 128, 4, 2, 64, 0, True),
              (2, 128, 4, 1, 64, 32, True), (1, 256, 6, 3, 32, 96, True),
              (2, 64, 8, 8, 16, 16, True), (2, 64, 4, 4, 32, 0, False),
              (2, 1000, 9, 3, 64, 0, True), (2, 1000, 9, 3, 64, 96, True),
              (1, 37, 4, 2, 128, 16, True)]
# K4 cases: B, C, Hq, Hkv, D, valid ("full", "ragged", "one")
DECODE_CASES = [(2, 128, 4, 2, 64, "full"), (3, 256, 8, 1, 32, "ragged"),
                (1, 64, 2, 2, 128, "one"), (2, 100, 9, 3, 64, "ragged")]
# K5 cases: BH, T, D (the reference's kernel tests), then B, T, H, D ragged
WKV_CASES = [(1, 32, 16), (2, 64, 32), (3, 128, 64), (2, 96, 32)]
WKV_RAGGED = [(2, 1000, 8, 64), (2, 37, 4, 32)]
WKV_HEADS, WKV_D = 64, 64          # rwkv6-7b: 64 heads of 64
# K3's training kernels: the training shapes (the sync cohort of 6 x batch 8
# folded, one async client), then the serving length; B, S, Hq, Hkv, D,
# window, causal
BWD_CASES = [(6 * 8, 64, 9, 3, 64, 0, True), (8, 64, 9, 3, 64, 0, True),
             (SERVE_BATCH, PROMPT_LEN, 9, 3, 64, 0, True)]
BWD_TOL = 1e-4                  # times max(1, the plain version's largest)
ATTN_TRAIN_KERNELS = ("swa_attention_lse", "swa_attention_bwd_dq",
                      "swa_attention_bwd_dkdv")
# phase 5f: the reference train CLI's smollm example at full width
SMOLLM, SMOLLM_LAYERS, SMOLLM_PARAMS = "smollm-135m", 30, 134_515_008
SMOLLM_TRAIN = ["--arch", SMOLLM, "--mode", "async", "--concurrency", "6",
                "--rounds", str(ROUNDS), "--seq-len", "64", "--compression",
                "int8"]


def fail(msg: str) -> int:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr)
    return 1


class Failed(Exception):
    pass


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


def graph_time_ms(fn, reps: int) -> float:
    """Device time of one fn() with no host in the way: `reps` calls
    captured in one CUDA graph, replayed after a warm-up."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, flops_per_s: float = F32_FLOPS_PER_S):
    """(least ms, what bounds it): `flops` at the rate of the route the
    kernel takes (the f32 SIMT rate unless given), `nbytes` at the HBM
    rate."""
    t_ops, t_bytes = flops / flops_per_s, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


# --------------------------------------------------------------- int8 codec
def check_int8(dev, gen, leaf_shapes):
    import torch
    from repro_torch.kernels.int8_quant import kernel as K
    from repro_torch.kernels.int8_quant import ref as R
    err = {"int8_quantize": 0.0, "int8_dequant_accumulate": 0.0}
    for stack in (None, GOAL):
        for k, shp in leaf_shapes.items():
            full = shp if stack is None else (stack,) + shp
            x = torch.randn(full, generator=gen, device=dev) * 1e-3
            q, s = K.quantize(x, BLOCK)
            q0, s0 = R.quantize_ref(x, BLOCK)
            if not torch.equal(q, q0):
                raise Failed(f"int8_quantize q differs at {k} {full}: "
                             f"{int((q != q0).sum())} elements")
            if not torch.allclose(s, s0, rtol=1e-6, atol=0):
                raise Failed(f"int8_quantize scales differ at {k} {full}")
            err["int8_quantize"] = max(err["int8_quantize"],
                                       float((s - s0).abs().max()))
            deq = K.dequant_accumulate(None, q, s, 1.0, x.numel(), BLOCK)
            if not torch.equal(deq, R.dequantize_ref(q, s, (x.numel(),),
                                                     BLOCK)):
                raise Failed(f"dequantize (K2, no accumulator) differs at {k}")
            acc = torch.randn(x.numel(), generator=gen, device=dev)
            got = K.dequant_accumulate(acc, q, s, 0.37, x.numel(), BLOCK)
            e = float((got - R.dequant_accumulate_ref(acc, q, s, 0.37,
                                                      BLOCK)).abs().max())
            if not e <= 1e-5:
                raise Failed(f"int8_dequant_accumulate differs at {k}: {e}")
            err["int8_dequant_accumulate"] = max(
                err["int8_dequant_accumulate"], e)
    # bf16 input is cast to f32 first; an all-zero block gets scale 1
    xb = torch.randn(3, 1000, generator=gen, device=dev).to(torch.bfloat16)
    xb[0] = 0
    q, s = K.quantize(xb, BLOCK)
    q0, s0 = R.quantize_ref(xb, BLOCK)
    if not (torch.equal(q, q0) and torch.equal(s, s0) and float(s[0]) == 1.0):
        raise Failed("int8_quantize differs on bf16 / all-zero input")
    # K1 over a table of leaves: the 24 leaves of one client and of the
    # stacked cohort, a ragged table (sizes off the block, an empty leaf,
    # a leaf whose data starts off 16 bytes, bf16) and one of 150 leaves
    sizes = torch.randint(1, 3000, (150,), generator=gen, device=dev)
    tables = {
        "24 leaves": [torch.randn(shp, generator=gen, device=dev) * 1e-3
                      for shp in leaf_shapes.values()],
        f"24 leaves x{GOAL}": [
            torch.randn((GOAL,) + shp, generator=gen, device=dev) * 1e-3
            for shp in leaf_shapes.values()],
        "ragged": [torch.randn(n, generator=gen, device=dev)
                   for n in (1, 255, 257, 0, 1000)]
        + [torch.randn(301, generator=gen, device=dev)[1:],
           torch.randn(7, 77, generator=gen, device=dev).to(torch.bfloat16)],
        "150 leaves": [torch.randn(int(n), generator=gen, device=dev)
                       for n in sizes.tolist()],
    }
    for what, leaves in tables.items():
        before = K.LAUNCHES["int8_quantize"]
        q, s, views = K.quantize_many(leaves, BLOCK)
        launches = K.LAUNCHES["int8_quantize"] - before
        q0, s0, views0 = R.quantize_many_ref(leaves, BLOCK)
        if not (torch.equal(q, q0) and torch.equal(s, s0)):
            raise Failed(f"int8_quantize over a table ({what}) differs from "
                         f"the per-leaf plain version: "
                         f"{int((q != q0).sum())} q elements, "
                         f"{int((s != s0).sum())} scales")
        for (qi, si), (qi0, si0) in zip(views, views0):
            if qi.shape != qi0.shape or si.shape != si0.shape:
                raise Failed(f"int8_quantize's leaf views ({what}) differ")
        want = -(-sum(1 for x in leaves if x.numel()) // K.MAX_LEAVES)
        if launches != want:
            raise Failed(f"int8_quantize over {what}: {launches} launches, "
                         f"expected {want}")
    # blocks that are not a multiple of 128, or longer than 1024, take the
    # kernel's other route
    for blk in (96, 1280):
        q, s, _ = K.quantize_many(tables["ragged"], blk)
        q0, s0, _ = R.quantize_many_ref(tables["ragged"], blk)
        if not (torch.equal(q, q0) and torch.equal(s, s0)):
            raise Failed(f"int8_quantize over the ragged table differs at "
                         f"block {blk}")
    torch.cuda.synchronize()
    print(f"[chip_smoke] int8: checked {len(leaf_shapes)} leaf shapes, alone "
          f"and stacked x{GOAL}, and tables {list(tables)}: q and scales "
          f"bit-equal, accumulate max abs err "
          f"{err['int8_dequant_accumulate']:.3g}")
    return err


def time_int8(dev, gen, leaf_shapes):
    """K1 and K2 as the sync round runs them: K1 over the table of the 24
    stacked cohort leaves in one launch, K2 as one dequantize of the whole
    layout; each eagerly in turns with its plain version and in a CUDA
    graph, beside the per-leaf loops (24 launches each) timed the same two
    ways and each kernel on the largest leaf alone; and the host wall of
    ``compress_roundtrip`` for one round. A port from before the leaf table
    (no ``quantize_many``) is timed by its per-leaf loop, so that this
    yardstick times both sides of that change (``--time-only --src``)."""
    import statistics
    import torch
    from repro_torch.federated import aggregation
    from repro_torch.kernels.int8_quant import kernel as K
    from repro_torch.kernels.int8_quant import ref as R
    cohort = [torch.randn((GOAL,) + shp, generator=gen, device=dev) * 1e-3
              for shp in leaf_shapes.values()]
    many = getattr(K, "quantize_many", None)
    per_leaf = lambda: [K.quantize(x, BLOCK) for x in cohort]  # noqa: E731
    if many is None:
        views = per_leaf()
        q, s = torch.cat([a for a, _ in views]), torch.cat([b for _, b in views])
        table = per_leaf
        plain = lambda: [R.quantize_ref(x, BLOCK) for x in cohort]  # noqa
    else:
        q, s, views = many(cohort, BLOCK)
        table = lambda: many(cohort, BLOCK)                      # noqa: E731
        plain = lambda: R.quantize_many_ref(cohort, BLOCK)       # noqa: E731
    acc = torch.randn(q.numel(), generator=gen, device=dev)
    ns = [x.numel() for x in cohort]
    nbs = [-(-n // BLOCK) for n in ns]
    nb, n_lay = sum(nbs), q.numel()
    bytes_k1 = sum(4 * n + nb_ * BLOCK + 4 * nb_ for n, nb_ in zip(ns, nbs))
    # the main path runs K2 with no accumulator (the dequantize) over the
    # whole layout: q and the scales in, f32 out
    bytes_k2 = n_lay + 4 * nb + 4 * n_lay
    bytes_k2_acc = bytes_k2 + 4 * n_lay
    reps = 10
    k1_ms, k1_plain = in_turns(plain, table, reps)
    k1_graph = graph_time_ms(table, reps)
    k1_leaf = cuda_time_ms(per_leaf, reps)
    k1_leaf_graph = graph_time_ms(per_leaf, reps)
    deq = lambda: K.dequant_accumulate(None, q, s, 1.0, n_lay, BLOCK)  # noqa
    deq_leaf = lambda: [K.dequant_accumulate(None, qi, si, 1.0, qi.numel(),  # noqa
                                             BLOCK) for qi, si in views]
    k2_ms, k2_plain = in_turns(
        lambda: R.dequantize_ref(q, s, (n_lay,), BLOCK), deq, reps)
    k2_graph = graph_time_ms(deq, reps)
    k2_leaf = cuda_time_ms(deq_leaf, reps)
    k2a_ms, k2a_plain = in_turns(
        lambda: R.dequant_accumulate_ref(acc, q, s, 0.37, BLOCK),
        lambda: K.dequant_accumulate(acc, q, s, 0.37, n_lay, BLOCK), reps)
    big = max(range(len(cohort)), key=lambda i: ns[i])
    xbig, (qbig, sbig), nbig, nbigb = cohort[big], views[big], ns[big], nbs[big]
    big_k1 = cuda_time_ms(lambda: K.quantize(xbig, BLOCK), 20)
    big_k2 = cuda_time_ms(
        lambda: K.dequant_accumulate(None, qbig, sbig, 1.0, nbig, BLOCK), 20)
    delta = dict(zip(leaf_shapes, cohort))
    walls = []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aggregation.compress_roundtrip(delta, BLOCK)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {
        "int8_quantize": dict(
            ms=k1_ms, plain_ms=k1_plain,
            bound_ms=bytes_k1 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None, graph_ms=k1_graph, leaves=len(cohort),
            leaf_table=many is not None,
            per_leaf_loop={"ms": k1_leaf, "graph_ms": k1_leaf_graph,
                           "launches": len(cohort)},
            largest_leaf={"shape": list(xbig.shape), "ms": big_k1,
                          "bound_ms": (4 * nbig + nbigb * BLOCK + 4 * nbigb)
                          / HBM_BYTES_PER_S * 1e3},
            compress_roundtrip_wall_ms={"median": statistics.median(walls[1:]),
                                        "min": min(walls[1:]),
                                        "runs": len(walls) - 1}),
        "int8_dequant_accumulate": dict(
            ms=k2_ms, plain_ms=k2_plain,
            bound_ms=bytes_k2 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None, graph_ms=k2_graph, layout_elements=n_lay,
            per_leaf_loop={"ms": k2_leaf, "launches": len(cohort)},
            largest_leaf={"shape": list(xbig.shape), "ms": big_k2,
                          "bound_ms": (5 * nbig + 4 * nbigb)
                          / HBM_BYTES_PER_S * 1e3},
            with_accumulator={"ms": k2a_ms, "plain_ms": k2a_plain,
                              "bound_ms": bytes_k2_acc / HBM_BYTES_PER_S
                              * 1e3}),
    }


# ---------------------------------------------------------------- attention
def _valid_lens(kind, B, C, dev):
    import torch
    if kind == "full":
        return C
    if kind == "one":
        return 1
    return (torch.arange(B, device=dev) * (C // 2) + 1).to(torch.int32)


def _serving_valid(dev):
    """Ragged valid lengths 1025..1088 over the 8 requests: the range the
    64 decode steps of a 1024-token prompt cover."""
    import torch
    i = torch.arange(SERVE_BATCH, device=dev)
    return (PROMPT_LEN + 1 + i * (GEN - 1) // max(1, SERVE_BATCH - 1)).to(
        torch.int32)


def check_attention(dev, gen):
    """K3 and K4 against their plain versions; returns the max abs errors,
    f32 and bf16 apart."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    from repro_torch.kernels.swa_attention import kernel as AK
    from repro_torch.kernels.swa_attention import ref as AR
    err = {}

    def record(name, dtype, got, want, tol, what):
        e = float((got.float() - want.float()).abs().max())
        if not (got.dtype == want.dtype and e <= tol):
            raise Failed(f"{name} differs at {what} ({dtype}): max abs err "
                         f"{e} > {tol}")
        key = name if dtype == torch.float32 else f"{name}_bf16"
        err[key] = max(err.get(key, 0.0), e)

    Hq, Hkv = 9, 3
    serving = (SERVE_BATCH, PROMPT_LEN, Hq, Hkv, 64, 0, True)
    for B, S, hq, hkv, D, window, causal in [serving] + ATTN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, S, hq, D, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, S, hkv, D, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, S, hkv, D, generator=gen, device=dev).to(dtype)
            got = AK.attention(q, k, v, causal=causal, window=window)
            want = AR.attention_ref(q, k, v, causal=causal, window=window)
            record("swa_attention", dtype, got, want,
                   2e-5 if dtype == torch.float32 else 2e-2,
                   (B, S, hq, hkv, D, window, causal))
    # q, k, v as strided views of one fused (B, S, Hq + 2 Hkv, D) tensor
    qkv = torch.randn(2, 300, Hq + 2 * Hkv, 64, generator=gen, device=dev)
    q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
    record("swa_attention", torch.float32, AK.attention(q, k, v, window=50),
           AR.attention_ref(q, k, v, window=50), 2e-5, "strided views")

    C = PROMPT_LEN + GEN
    cases = [(SERVE_BATCH, C, Hq, Hkv, 64, "serving")] + DECODE_CASES
    for B, C_, hq, hkv, D, kind in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, hq, D, generator=gen, device=dev).to(dtype)
            kc = torch.randn(B, C_, hkv, D, generator=gen, device=dev).to(dtype)
            vc = torch.randn(B, C_, hkv, D, generator=gen, device=dev).to(dtype)
            vl = _serving_valid(dev) if kind == "serving" else \
                _valid_lens(kind, B, C_, dev)
            got = DK.decode_attention(q, kc, vc, vl)
            want = DR.decode_attention_ref(q, kc, vc, vl)
            record("decode_attention", dtype, got, want,
                   1e-5 if dtype == torch.float32 else 3e-2,
                   (B, C_, hq, hkv, D, kind))
            if kind == "serving" and dtype == torch.float32:
                # a Python int, as the decode step passes it
                record("decode_attention", dtype,
                       DK.decode_attention(q, kc, vc, 1000),
                       DR.decode_attention_ref(q, kc, vc, 1000), 1e-5,
                       "scalar valid_len 1000")
                # replayed from a CUDA graph: the arrival counters are reset
                # by every launch, so replays agree
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    got = DK.decode_attention(q, kc, vc, vl)
                for _ in range(3):
                    got.zero_()
                    g.replay()
                    record("decode_attention", dtype, got, want, 1e-5,
                           "a CUDA graph's replay")
    torch.cuda.synchronize()
    if any(int(c.abs().sum()) for c in DK._COUNTERS.values()):
        raise Failed("decode_attention left an arrival counter non-zero")
    print(f"[chip_smoke] attention: K3 {1 + len(ATTN_CASES)} shapes x "
          f"(f32, bf16) + strided views, K4 {len(cases)} shapes x (f32, "
          f"bf16) + a scalar valid_len; max abs err {err}")
    return err


def per_call_ms(fn, calls: int, reps: int, graph: bool) -> float:
    """Time of one call when fn() makes `calls` calls: eager (CUDA events
    around `reps` runs of fn) or its device time in a CUDA graph."""
    t = graph_time_ms(fn, reps) if graph else cuda_time_ms(fn, reps)
    return t / calls


def time_attention(dev, gen):
    """K3 and K4 at the serving shapes: kernel, plain version and the
    library call (scaled_dot_product_attention, timed here only).

    K3 is timed in f32 (the serve's type) and bf16, its bound at the rate
    of the route it takes for that type (``K3_ROUTE``). K4 is timed as a
    decode step meets it: over LAYERS distinct (k_cache, v_cache) pairs,
    one per layer (about 400 MB at the serving shape, so each call finds its
    cache cold in the 50 MB L2), eagerly and in a CUDA graph; the library
    call the same way."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    from repro_torch.kernels.swa_attention import kernel as AK
    from repro_torch.kernels.swa_attention import ref as AR
    B, S, Hq, Hkv, D = SERVE_BATCH, PROMPT_LEN, 9, 3, 64
    pairs = B * Hq * S * (S + 1) // 2
    k3 = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype)

        def sdpa3():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True).transpose(1, 2)

        lib_err = float((sdpa3().float() - AR.attention_ref(q, k, v).float())
                        .abs().max())
        ms, plain = in_turns(lambda: AR.attention_ref(q, k, v),
                             lambda: AK.attention(q, k, v), 5)
        route, mult, rate = K3_ROUTE[str(dtype).split(".")[-1]]
        nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
        b, by = bound(mult * 4 * D * pairs, nbytes, rate)
        k3[dtype] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                         library_ms=cuda_time_ms(sdpa3, 5), math=route,
                         bound_f32_simt_ms=bound(4 * D * pairs, nbytes)[0],
                         library_max_abs_err=lib_err)

    C = S + GEN
    caches = [(torch.randn(B, C, Hkv, D, generator=gen, device=dev),
               torch.randn(B, C, Hkv, D, generator=gen, device=dev))
              for _ in range(LAYERS)]
    qd = torch.randn(B, Hq, D, generator=gen, device=dev)
    vl = _serving_valid(dev)
    mask = (torch.arange(C, device=dev)[None, :] < vl[:, None])[:, None, None]

    def sdpa4(kc, vc):
        return F.scaled_dot_product_attention(
            qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]

    kc0, vc0 = caches[0]
    lib_err4 = float((sdpa4(kc0, vc0) - DR.decode_attention_ref(
        qd, kc0, vc0, vl)).abs().max())

    def step(fn):
        return lambda: [fn(kc, vc) for kc, vc in caches]

    kernel4 = step(lambda kc, vc: DK.decode_attention(qd, kc, vc, vl))
    plain4 = step(lambda kc, vc: DR.decode_attention_ref(qd, kc, vc, vl))
    k4_ms, k4_plain = in_turns(plain4, kernel4, 5)
    k4_ms, k4_plain = k4_ms / LAYERS, k4_plain / LAYERS
    k4_lib = per_call_ms(step(sdpa4), LAYERS, 5, graph=False)
    k4_graph = per_call_ms(kernel4, LAYERS, 3, graph=True)
    try:
        k4_lib_graph = per_call_ms(step(sdpa4), LAYERS, 3, graph=True)
    except RuntimeError as e:           # the library call did not capture
        print(f"[chip_smoke] SDPA in a CUDA graph: not measured ({e})")
        k4_lib_graph = None
    # the old yardstick: one cache, warm in L2, for comparison only
    k4_warm = graph_time_ms(lambda: DK.decode_attention(qd, kc0, vc0, vl), 50)
    # what no byte pays for: every block launched, none reading (valid 0),
    # and one block reading one tile (C 32, one group, no combine)
    k4_empty = graph_time_ms(lambda: DK.decode_attention(qd, kc0, vc0, 0), 50)
    q1, kc1, vc1 = qd[:1, :Hq // Hkv], kc0[:1, :32, :1], vc0[:1, :32, :1]
    k4_one = graph_time_ms(lambda: DK.decode_attention(q1, kc1, vc1, 32), 50)
    slots = int(vl.sum())
    b4, by4 = bound(4 * D * Hq * slots,
                    4 * (2 * qd.numel() + 2 * slots * Hkv * D) + 4 * B)
    out = {
        "swa_attention": dict(
            **k3[torch.float32], shape=[B, S, Hq, Hkv, D],
            library="scaled_dot_product_attention(is_causal, enable_gqa)",
            bf16={k: v for k, v in k3[torch.bfloat16].items()
                  if k != "bound_f32_simt_ms"}),
        "decode_attention": dict(
            ms=k4_ms, plain_ms=k4_plain, bound_ms=b4, bound_by=by4,
            library_ms=k4_lib, graph_ms=k4_graph,
            library_graph_ms=k4_lib_graph, warm_l2_graph_ms=k4_warm,
            valid_0_graph_ms=k4_empty, one_tile_graph_ms=k4_one,
            caches=LAYERS, shape=[B, C, Hq, Hkv, D], valid=vl.tolist(),
            library="scaled_dot_product_attention(bool mask, enable_gqa)",
            library_max_abs_err=lib_err4),
    }
    for dtype, t in k3.items():
        print(f"[chip_smoke] swa_attention {dtype}: {t['ms']:.4f} ms (plain "
              f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound "
              f"{t['bound_ms']:.4f} by {t['bound_by']} on {t['math']}; "
              f"f32 SIMT bound {t['bound_f32_simt_ms']:.4f})")
    lg = "not measured" if k4_lib_graph is None else f"{k4_lib_graph:.4f}"
    print(f"[chip_smoke] decode_attention over {LAYERS} caches (cold in L2): "
          f"{k4_ms:.4f} ms eager, {k4_graph:.4f} ms in a CUDA graph (plain "
          f"{k4_plain:.4f}; library {k4_lib:.4f} eager, {lg} in a graph; "
          f"bound {b4:.4f} by {by4}); one cache warm in L2, graph: "
          f"{k4_warm:.4f}; valid_len 0 (no bytes read), graph: "
          f"{k4_empty:.4f}; one block of one 32-slot tile, graph: "
          f"{k4_one:.4f}")
    return out


def check_attention_bwd(dev, gen):
    """Phase 3, K3's training kernels against their plain versions (f32):
    the forward with LSE (o bit-equal to ``attention``'s, lse within 1e-5 of
    max(1, its largest entry) of ``attention_fwd_ref``'s) and the dQ and
    dK/dV kernels against ``attention_bwd_ref`` on the same q, k, v, o,
    lse and dO (within BWD_TOL of max(1, the plain gradient's largest
    entry)), at the training shapes, the serving length, the forward's
    cases (windows, non-causal, ragged S, D 16/32/128), 9 query heads on
    one kv head and strided views;
    the folded cohort launch (N B) bit-equal to N launches of B; the
    autograd Function under vmap(grad_and_value) giving a per-client loop's
    outputs and gradients bit for bit; a bf16 backward raises. Returns the
    max abs errors by kernel and the largest error relative to max(1,
    |ref|) reached."""
    import torch
    from repro_torch.kernels.swa_attention import autograd as AG
    from repro_torch.kernels.swa_attention import kernel as AK
    from repro_torch.kernels.swa_attention import ref as AR
    err = {"swa_attention_lse": 0.0, "swa_attention_bwd_dq": 0.0,
           "swa_attention_bwd_dkdv": 0.0}
    rel = dict(err)

    def held(name, got, want, tol, what):
        scale = max(1.0, float(want.abs().max()))
        e = float((got - want).abs().max())
        if not (got.dtype == want.dtype and e <= tol * scale):
            raise Failed(f"{name} differs at {what}: max abs err {e} > "
                         f"{tol} x {scale}")
        err[name] = max(err[name], e)
        rel[name] = max(rel[name], e / scale)

    def one(q, k, v, do, causal, window, what):
        o0 = AK.attention(q, k, v, causal=causal, window=window)
        o, lse = AK.attention_fwd(q, k, v, causal=causal, window=window)
        ro, rlse = AR.attention_fwd_ref(q, k, v, causal=causal,
                                        window=window)
        if not torch.equal(o, o0):
            raise Failed(f"swa_attention with LSE: o is not bit-equal to "
                         f"the forward without it at {what}")
        held("swa_attention_lse", lse, rlse, 1e-5, what)
        want = AR.attention_bwd_ref(q, k, v, ro, rlse, do, causal=causal,
                                    window=window)
        dq, delta = AK.attention_bwd_dq(q, k, v, ro, rlse, do, causal=causal,
                                        window=window)
        dk, dv = AK.attention_bwd_dkdv(q, k, v, rlse, do, delta,
                                       causal=causal, window=window)
        held("swa_attention_bwd_dq", dq, want[0], BWD_TOL, what)
        held("swa_attention_bwd_dkdv", dk, want[1], BWD_TOL, what)
        held("swa_attention_bwd_dkdv", dv, want[2], BWD_TOL, what)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # and a group of 9 query heads on one kv head (three a cluster rank)
    cases = BWD_CASES + ATTN_CASES + [(2, 70, 4, 2, 128, 0, False),
                                      (1, 50, 4, 4, 16, 8, False),
                                      (2, 80, 9, 1, 32, 0, True)]
    for B, S, hq, hkv, D, window, causal in cases:
        one(randn(B, S, hq, D), randn(B, S, hkv, D), randn(B, S, hkv, D),
            randn(B, S, hq, D), causal, window,
            (B, S, hq, hkv, D, window, causal))
    # q, k, v as strided views of one fused tensor, dO a view of a wider one
    Hq, Hkv = 9, 3
    qkv = randn(2, 300, Hq + 2 * Hkv, 64)
    do = randn(2, 300, Hq + 1, 64)[:, :, :Hq]
    one(qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:], do,
        True, 50, "strided views")

    # the folded cohort launch against one launch a client, bit for bit
    N, B, S, D = 6, 8, 64, 64
    q, k, v, do = randn(N * B, S, Hq, D), randn(N * B, S, Hkv, D), \
        randn(N * B, S, Hkv, D), randn(N * B, S, Hq, D)
    o, lse = AK.attention_fwd(q, k, v)
    full = (o, lse, *AK.attention_bwd(q, k, v, o, lse, do))
    for i in range(N):
        c = slice(i * B, (i + 1) * B)
        oi, li = AK.attention_fwd(q[c], k[c], v[c])
        part = (oi, li, *AK.attention_bwd(q[c], k[c], v[c], o[c], lse[c],
                                          do[c]))
        if not all(torch.equal(a[c], b) for a, b in zip(full, part)):
            raise Failed(f"the folded launch of {N} x {B} differs from "
                         f"client {i}'s launch of {B}")
    # the Function under vmap(grad_and_value), as the cohort step takes it
    qs, ks, vs = (x.reshape(N, B, *x.shape[1:]) for x in (q, k, v))
    w = do[:B]

    def loss(p):
        o = AG.attention(p["q"], p["k"], p["v"])
        return (o * w).sum(), o

    grad_fn = torch.func.grad_and_value(loss, has_aux=True)
    grads, (_, outs) = torch.func.vmap(grad_fn)({"q": qs, "k": ks, "v": vs})
    for i in range(N):
        # (the loss's own sum may add in another order under vmap)
        g, (_, o) = grad_fn({"q": qs[i], "k": ks[i], "v": vs[i]})
        if not (torch.equal(o, outs[i]) and
                all(torch.equal(g[n], grads[n][i]) for n in "qkv")):
            raise Failed(f"vmap(grad) of the attention Function differs "
                         f"from client {i}'s own output or gradient")
    qb = q[:B].bfloat16()
    try:
        AK.attention_bwd(qb, qb[..., :Hkv, :], qb[..., :Hkv, :], qb,
                         lse[:B], qb)
    except NotImplementedError:
        pass
    else:
        raise Failed("a bf16 attention backward ran; it is not ported")
    torch.cuda.synchronize()
    print(f"[chip_smoke] K3 training kernels: {len(cases) + 1} shapes, the "
          f"forward with LSE (o bit-equal), dQ and dK/dV within {BWD_TOL} of "
          f"max(1, |ref|); reached, relative to max(1, |ref|): {rel}; max "
          f"abs err {err}; the folded {N} x {B} launch and vmap(grad) "
          f"bit-equal to per-client launches")
    return err, rel


def time_attention_bwd(dev, gen):
    """Phase 4, K3's training kernels at the sync training shape (the
    cohort of 6 folded: 48 x 64 tokens, 9/3 heads, D 64, causal), their
    main path, and at the serving length (8 x 1024): the forward with LSE
    against its plain version and SDPA's forward; each backward kernel, and
    the two together, against the plain backward and SDPA's backward
    through autograd (``enable_gqa``, f32), in turns; each kernel also in a
    CUDA graph (``graph_ms``), as the cohort step replays them. Bounds: 10 D
    operations an attended pair for the whole backward (6 D for dQ: S, dP,
    dQ; 8 D for dK/dV: S, dP, dV, dK; 4 D for the forward) at the rate of
    their f32 route (``K3_ROUTE``: 3xTF32, three TF32 products each), or
    the bytes each must read once and write once at the HBM rate, if
    larger."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.swa_attention import kernel as AK
    from repro_torch.kernels.swa_attention import ref as AR
    out = {}
    for B, S, Hq, Hkv, D, _, _ in (BWD_CASES[0], BWD_CASES[2]):
        q = torch.randn(B, S, Hq, D, generator=gen, device=dev)
        k = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
        v = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
        do = torch.randn(B, S, Hq, D, generator=gen, device=dev)
        o, lse = AK.attention_fwd(q, k, v)
        _, delta = AK.attention_bwd_dq(q, k, v, o, lse, do)
        pairs = B * Hq * S * (S + 1) // 2
        big, small = 4 * q.numel(), 4 * k.numel()      # bytes
        rows = 4 * lse.numel()
        lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))
        lib_o = F.scaled_dot_product_attention(
            lq.transpose(1, 2), lk.transpose(1, 2), lv.transpose(1, 2),
            is_causal=True, enable_gqa=True)
        lib_do = do.transpose(1, 2)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)

        def sdpa_bwd():
            return torch.autograd.grad(lib_o, (lq, lk, lv), lib_do,
                                       retain_graph=True)

        lse_ms, lse_plain = in_turns(lambda: AR.attention_fwd_ref(q, k, v),
                                     lambda: AK.attention_fwd(q, k, v), 5)
        dq_ms, bwd_plain1 = in_turns(
            lambda: AR.attention_bwd_ref(q, k, v, o, lse, do),
            lambda: AK.attention_bwd_dq(q, k, v, o, lse, do), 5)
        dkdv_ms, bwd_plain2 = in_turns(
            lambda: AR.attention_bwd_ref(q, k, v, o, lse, do),
            lambda: AK.attention_bwd_dkdv(q, k, v, lse, do, delta), 5)
        both_ms = cuda_time_ms(lambda: AK.attention_bwd(q, k, v, o, lse, do),
                               5)
        # device time with no host in the way, as the cohort's graph runs them
        graph_ms = {
            "swa_attention_lse": graph_time_ms(
                lambda: AK.attention_fwd(q, k, v), 20),
            "swa_attention_bwd_dq": graph_time_ms(
                lambda: AK.attention_bwd_dq(q, k, v, o, lse, do), 20),
            "swa_attention_bwd_dkdv": graph_time_ms(
                lambda: AK.attention_bwd_dkdv(q, k, v, lse, do, delta), 20),
            "backward_both_kernels": graph_time_ms(
                lambda: AK.attention_bwd(q, k, v, o, lse, do), 20)}
        lib_bwd = cuda_time_ms(sdpa_bwd, 5)
        lib_fwd = cuda_time_ms(sdpa_fwd, 5)
        plain = (bwd_plain1 + bwd_plain2) / 2
        route, mult, rate = K3_ROUTE["float32"]
        key = "training" if S == 64 else "serving"
        out[key] = {
            "shape": [B, S, Hq, Hkv, D], "route": route,
            "swa_attention_lse": dict(
                ms=lse_ms, plain_ms=lse_plain, library_ms=lib_fwd,
                **dict(zip(("bound_ms", "bound_by"), bound(
                    mult * 4 * D * pairs, 2 * big + 2 * small + rows,
                    rate)))),
            "swa_attention_bwd_dq": dict(
                ms=dq_ms, plain_ms=plain, library_ms=lib_bwd,
                **dict(zip(("bound_ms", "bound_by"), bound(
                    mult * 6 * D * pairs, 4 * big + 2 * small + 2 * rows,
                    rate)))),
            "swa_attention_bwd_dkdv": dict(
                ms=dkdv_ms, plain_ms=plain, library_ms=lib_bwd,
                **dict(zip(("bound_ms", "bound_by"), bound(
                    mult * 8 * D * pairs, 2 * big + 4 * small + 2 * rows,
                    rate)))),
            "backward_both_kernels": dict(
                ms=both_ms, plain_ms=plain, library_ms=lib_bwd,
                **dict(zip(("bound_ms", "bound_by"), bound(
                    mult * 10 * D * pairs, 4 * big + 4 * small + rows,
                    rate)))),
        }
        for name, t in out[key].items():
            if name not in ("shape", "route"):
                t["graph_ms"] = graph_ms[name]
                print(f"[chip_smoke] {name} at {key} {out[key]['shape']}, "
                      f"{route}: {t['ms']:.4f} ms, {t['graph_ms']:.4f} ms in "
                      f"a CUDA graph (plain "
                      f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}, "
                      f"bound {t['bound_ms']:.4f} by {t['bound_by']})")
    return out


# ---------------------------------------------------------------------- WKV
def _wkv_model_scale(B, T, dev, gen):
    """Inputs at the scale the reference's init gives the model: r, k, v
    with standard deviation 8 (wr/wk/wv at 1/sqrt(heads)), w =
    exp(-exp(normal)) as ``_decay`` makes it, u normal (zero at init, drawn
    here so that the bonus term is checked)."""
    import torch
    H, D = WKV_HEADS, WKV_D
    r, k, v = (torch.randn(B, T, H, D, generator=gen, device=dev) * 8
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, T, H, D, generator=gen,
                                         device=dev)))
    return r, k, v, w, torch.randn(H, D, generator=gen, device=dev)


def _wkv_unit_scale(shape, u_shape, dtype, dev, gen):
    """tests/test_kernels_wkv.py's draws: r, k, v at 0.3, w =
    sigmoid(normal), u at 0.1, a state at 0.1."""
    import torch
    r, k, v = ((torch.randn(shape, generator=gen, device=dev) * 0.3)
               .to(dtype) for _ in range(3))
    w = torch.sigmoid(torch.randn(shape, generator=gen, device=dev)).to(dtype)
    u = (torch.randn(u_shape, generator=gen, device=dev) * 0.1).to(dtype)
    B, _, H, D = shape
    s0 = torch.randn(B, H, D, D, generator=gen, device=dev) * 0.1
    return r, k, v, w, u, s0


def check_wkv(dev, gen):
    """K5 against its plain version: o and the final state each within
    tol x max(1, the plain version's largest entry), so that the
    tolerance follows the tensors' scale; returns the max abs errors, f32
    and bf16 apart, and the same over the scale."""
    import torch
    from repro_torch.kernels.wkv import kernel as WK
    from repro_torch.kernels.wkv import ref as WR
    f32, bf16 = torch.float32, torch.bfloat16
    err = {}

    def check(args, tol, what):
        r, s0 = args[0], args[5]
        o0, sT0 = WR.wkv_batched_ref(*args)
        state = s0.clone()
        o, out = WK.wkv(*args[:5], state)
        if out is not state:
            raise Failed("wkv did not return the state it was given")
        e_o = float((o.float() - o0.float()).abs().max())
        e_s = float((state - sT0).abs().max())
        sc_o = max(1.0, float(o0.float().abs().max()))
        sc_s = max(1.0, float(sT0.abs().max()))
        if not (o.dtype == r.dtype and e_o <= tol * sc_o
                and e_s <= tol * sc_s):
            raise Failed(f"wkv differs at {what} ({r.dtype}): max abs err "
                         f"o {e_o} (scale {sc_o}), state {e_s} (scale "
                         f"{sc_s}), tolerance {tol} x scale")
        key = "wkv" if r.dtype == f32 else "wkv_bf16"
        err[key] = max(err.get(key, 0.0), e_o, e_s)
        err[f"{key}_over_scale"] = max(err.get(f"{key}_over_scale", 0.0),
                                       e_o / sc_o, e_s / sc_s)
        return sT0

    B, T, H, D = SERVE_BATCH, PROMPT_LEN, WKV_HEADS, WKV_D
    r, k, v, w, u = _wkv_model_scale(B, T, dev, gen)
    sT = check((r, k, v, w, u, torch.zeros(B, H, D, D, device=dev)), 3e-5,
               "the prefill shape")
    # a decode step from the prefill's state, written in place
    rd, kd, vd, wd, _ = _wkv_model_scale(B, 1, dev, gen)
    check((rd, kd, vd, wd, u, sT), 3e-5, "the decode shape")
    for BH, T_, D_ in WKV_CASES:        # (BH, T, D) as B = BH, H = 1
        for dtype in (f32, bf16):
            check(_wkv_unit_scale((BH, T_, 1, D_), (BH, 1, D_), dtype, dev,
                                  gen), 3e-5 if dtype == f32 else 3e-2,
                  (BH, T_, D_))
    for B_, T_, H_, D_ in WKV_RAGGED:
        check(_wkv_unit_scale((B_, T_, H_, D_), (H_, D_), f32, dev, gen),
              3e-5, (B_, T_, H_, D_))
    # r, k, v, w as strided views of one fused tensor, one u per panel
    fused = torch.randn(2, 300, 8, 4, 64, generator=gen, device=dev) * 0.3
    r, k, v, wl = fused.unbind(3)
    u = torch.randn(2, 8, 64, generator=gen, device=dev) * 0.1
    s0 = torch.randn(2, 8, 64, 64, generator=gen, device=dev) * 0.1
    check((r, k, v, torch.sigmoid(wl), u, s0), 3e-5, "strided views")
    # replayed from a CUDA graph: the state is updated in place, so each
    # replay starts from a fresh copy of s0
    r, k, v, w, u = _wkv_model_scale(2, 100, dev, gen)
    s0 = torch.randn(2, WKV_HEADS, WKV_D, WKV_D, generator=gen, device=dev)
    o0, sT0 = WR.wkv_batched_ref(r, k, v, w, u, s0)
    state = s0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        WK.wkv(r, k, v, w, u, state)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    state.copy_(s0)
    with torch.cuda.graph(g):
        o, _ = WK.wkv(r, k, v, w, u, state)
    sc_o = max(1.0, float(o0.abs().max()))
    sc_s = max(1.0, float(sT0.abs().max()))
    for i in range(3):
        state.copy_(s0)
        o.zero_()
        g.replay()
        e_o = float((o - o0).abs().max())
        e_s = float((state - sT0).abs().max())
        if not (e_o <= 3e-5 * sc_o and e_s <= 3e-5 * sc_s):
            raise Failed(f"wkv differs in a CUDA graph's replay {i}: max abs "
                         f"err o {e_o} (scale {sc_o}), state {e_s} (scale "
                         f"{sc_s})")
        err["wkv"] = max(err["wkv"], e_o, e_s)
    torch.cuda.synchronize()
    print(f"[chip_smoke] wkv: prefill and decode shapes at model scale, "
          f"{len(WKV_CASES)} reference cases x (f32, bf16), "
          f"{len(WKV_RAGGED)} ragged T, strided views, 3 graph replays; max "
          f"abs err {err}")
    return err


def time_wkv(dev, gen):
    """K5 at the prefill shape (8, 1024, 64, 64) and the decode shape (T 1):
    eager in turns with its plain version, and its device time in a CUDA
    graph; at the decode shape also over RWKV_LAYERS distinct states, one
    per layer as a decode step holds them (268 MB, cold in L2), in a CUDA
    graph. No single PyTorch call computes WKV."""
    import torch
    from repro_torch.kernels.wkv import kernel as WK
    from repro_torch.kernels.wkv import ref as WR
    out = {}
    for name, T, reps in (("prefill", PROMPT_LEN, 3), ("decode", 1, 50)):
        B, H, D = SERVE_BATCH, WKV_HEADS, WKV_D
        r, k, v, w, u = _wkv_model_scale(B, T, dev, gen)
        s_plain = torch.zeros(B, H, D, D, device=dev)
        s_kernel = torch.zeros(B, H, D, D, device=dev)
        ms, plain = in_turns(
            lambda: WR.wkv_batched_ref(r, k, v, w, u, s_plain),
            lambda: WK.wkv(r, k, v, w, u, s_kernel), reps)
        graph = graph_time_ms(lambda: WK.wkv(r, k, v, w, u, s_kernel),
                              10 if T > 1 else 50)
        nbytes = r.element_size() * 5 * r.numel() + 4 * (
            2 * s_kernel.numel() + u.numel())
        b, by = bound(4 * D * D * B * T * H, nbytes)
        out[name] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                         graph_ms=graph, shape=[B, T, H, D])
        if T == 1:
            states = [torch.zeros(B, H, D, D, device=dev)
                      for _ in range(RWKV_LAYERS)]
            out[name]["cold_graph_ms"] = per_call_ms(
                lambda: [WK.wkv(r, k, v, w, u, st) for st in states],
                RWKV_LAYERS, 3, graph=True)
            out[name]["states"] = RWKV_LAYERS
        cold = out[name].get("cold_graph_ms")
        print(f"[chip_smoke] wkv at the {name} shape {[B, T, H, D]}: "
              f"{ms:.4f} ms eager, {graph:.4f} ms in a CUDA graph (plain "
              f"{plain:.4f}, bound {b:.4f} by {by})"
              + ("" if cold is None else f"; over {RWKV_LAYERS} states "
                 f"cold in L2, graph: {cold:.4f} ms"))
    pre = out["prefill"]
    return {"wkv": dict(
        ms=pre["ms"], plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
        bound_by=pre["bound_by"], library_ms=None, graph_ms=pre["graph_ms"],
        shape=pre["shape"], decode=out["decode"])}


# ----------------------------------------------------------------- counters
def _counters():
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.int8_quant import kernel as K
    from repro_torch.kernels.swa_attention import kernel as AK
    from repro_torch.kernels.wkv import kernel as WK
    return (K, AK, DK, WK)


def reset_launches() -> None:
    for m in _counters():
        m.reset_launches()


def read_launches() -> dict:
    out = {}
    for m in _counters():
        out.update(m.LAUNCHES)
    return out


# ------------------------------------------------------------- cohort step
def local_steps(ds, fed, max_steps, cid) -> int:
    """The local steps a client trains: its batch count, capped."""
    return min(len(ds.client_batches(cid, fed.client_batch_size,
                                     fed.local_epochs)), max_steps)


def ragged_cohort(ds, fed, max_steps):
    """Client ids, two for each local step count from max_steps down to 1:
    the first such ids in order."""
    by_steps = {s: [] for s in range(1, max_steps + 1)}
    cid = 0
    while any(len(v) < 2 for v in by_steps.values()):
        n = local_steps(ds, fed, max_steps, cid)
        if len(by_steps[n]) < 2:
            by_steps[n].append(cid)
        cid += 1
    return [c for s in range(max_steps, 0, -1) for c in by_steps[s]]


def check_cohort(dev):
    """Phase 3b: the learner's graph-replayed cohort step at full width
    against make_client_update (the plain per-client step) and against the
    same vmapped step run eagerly; a ragged 16-client cohort (2 clients
    for each of 1 to 8 local steps), then one client_delta (8 steps). No
    codec, so the deltas are the steps' own.

    Held: the graph replay bit-equal to the eager vmapped step; at N = 1
    the whole 8-step delta within atol 1e-5 (the client-step tolerance) of
    the per-client one; at N = 16 every local step of every client, taken
    from the base params, with its loss within rel 1e-5 and its delta
    within atol 1e-4 of the per-client step on the same batch (the count
    within 1e-5 is printed). A batched product sums in another order than
    a per-client one, and where a ReLU input lies within a rounding of 0
    the two steps take different sides of the kink: that unit's gradient
    at that token then differs whole, which moves the step's delta by up to
    about 2e-5 at this width; the per-client step on the CPU differs from
    the one on the card in the same way (``scripts/cohort_kinks.py``
    shows both). Printed, not held: the whole multi-step deltas of the
    16-client cohort against the per-client ones, beside the per-client
    step's own change under a relative noise of 1e-7 in the base params
    (one f32 rounding), which local SGD at the paper's client_lr 0.3
    amplifies about 3e4-fold over 8 steps."""
    import numpy as np
    import torch
    from repro_torch.configs import FederatedConfig, RunConfig, get_config
    from repro_torch.data import FederatedDataset
    from repro_torch.federated import RealLearner, client
    from repro_torch.api import ExperimentSpec
    from repro_torch.federated.client import stack_batches, to_device
    cfg = get_config("paper-charlm")
    fed = FederatedConfig(
        mode="sync", concurrency=CONCURRENCY, aggregation_goal=GOAL,
        client_lr=0.3, server_lr=0.02, client_batch_size=BATCH,
        compression="none", seed=SEED)
    ds = FederatedDataset(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN,
                          char_vocab=cfg.char_vocab,
                          max_word_len=cfg.max_word_len)
    steps = ExperimentSpec().max_client_steps
    learner = RealLearner(cfg, fed, RunConfig(), ds, max_client_steps=steps,
                          seed=SEED, device=dev)
    if cfg.param_count() != 15_560_704 or steps != 8:
        raise Failed("the cohort check is not at the paper's full width")
    ids = ragged_cohort(ds, fed, steps)
    base = learner.params
    looped = client.make_client_update(learner.model.loss, fed.client_lr)
    eager = client.make_cohort_update(learner.model.loss, fed.client_lr,
                                      graph=False)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    noisy = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=g,
                                            device=dev))
             for k, v in base.items()}

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t0

    def max_err(a, b, err):
        for k in err:
            err[k] = max(err[k], float((a[k] - b[k]).abs().max()))

    out = {}
    for what, cohort in (("cohort of 16", ids), ("client_delta", ids[:1])):
        client.reset_graph_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        if what == "client_delta":
            (d, _), wall = timed(lambda: learner.client_delta(cohort[0]))
            got = [d]
        else:
            (got, _), wall = timed(lambda: learner.client_deltas(cohort))
        peak = torch.cuda.max_memory_allocated(dev)
        graphs = dict(client.GRAPH_COUNTS)
        n_steps = [local_steps(ds, fed, steps, c) for c in cohort]
        want = {"captures": 1, "replays": max(n_steps)}
        if graphs != want:
            raise Failed(f"cohort step, {what}: graph counts {graphs}, "
                         f"expected {want}")
        stacked = [stack_batches(ds.client_batches(c, BATCH,
                                                   fed.local_epochs), steps)
                   for c in cohort]
        inputs = to_device({k: np.stack([s[k] for s, _ in stacked])
                            for k in stacked[0][0]}, dev)
        masks = np.stack([m for _, m in stacked])
        ref, eager_wall = timed(lambda: eager(base, inputs, masks)[0])
        not_equal = [k for k in ref if not torch.equal(
            torch.stack([d[k] for d in got]), ref[k])]
        # the whole deltas against the per-client step, and that step's
        # own change under one f32 rounding of the base params
        err, noise, loop_wall = {k: 0.0 for k in base}, \
            {k: 0.0 for k in base}, 0.0
        for i, (d, (st, m)) in enumerate(zip(got, stacked)):
            one = to_device(st, dev)
            (want_d, _), w = timed(lambda: looped(base, one, m))
            loop_wall += w
            max_err(d, want_d, err)
            if n_steps[i] == steps:
                max_err(looped(noisy, one, m)[0], want_d, noise)
        # every local step of every client from the base params: the
        # cohort with only step k unmasked (the steps before it are no-ops)
        # against one per-client step on batch k
        graphed = client.make_cohort_update(learner.model.loss,
                                            fed.client_lr)
        step_err, pair_err, loss_rel = {k: 0.0 for k in base}, [], 0.0
        for k_step in range(max(n_steps)):
            only = np.zeros_like(masks)
            only[:, k_step] = masks[:, k_step]
            cur, cur_loss = graphed(base, inputs, only)
            for i in range(len(cohort)):
                if n_steps[i] <= k_step:
                    continue
                e = {k: 0.0 for k in base}
                d, loss = looped(base, {k: v[i, k_step:k_step + 1]
                                        for k, v in inputs.items()},
                                 np.ones(1, np.float32))
                max_err({k: v[i] for k, v in cur.items()}, d, e)
                for k in step_err:
                    step_err[k] = max(step_err[k], e[k])
                pair_err.append(max(e.values()))
                loss_rel = max(loss_rel, abs(float(cur_loss[i]) / float(loss)
                                             - 1.0))
        out[what] = {"clients": len(cohort), "local_steps": n_steps,
                     "graph_counts": graphs, "graph_wall_s": wall,
                     "eager_vmapped_wall_s": eager_wall,
                     "looped_wall_s": loop_wall, "peak_memory_bytes": peak,
                     "max_abs_err_per_step": step_err,
                     "steps_within_1e-5": sum(e <= 1e-5 for e in pair_err),
                     "steps": len(pair_err), "loss_max_rel_err": loss_rel,
                     "max_abs_err_whole_deltas": err,
                     "noise_1e-7_max_abs_change_8_steps": noise,
                     "leaves_not_bit_equal_to_eager": not_equal}
        print(f"[chip_smoke] cohort step, {what}: {graphs}; graph "
              f"{wall:.4f} s (the capture included), eager vmapped "
              f"{eager_wall:.4f} s, looped {loop_wall:.4f} s; peak memory "
              f"{peak / 2**30:.2f} GiB; against the per-client step, "
              f"each step from the base params: "
              f"{out[what]['steps_within_1e-5']} of {len(pair_err)} steps "
              f"within 1e-5, losses within rel {loss_rel:.3g}, largest "
              f"difference per leaf {step_err}; whole deltas {err}; the "
              f"per-client step's own change under a relative noise of "
              f"1e-7 in the base params over 8 steps {noise}")
        if not loss_rel <= 1e-5:
            raise Failed(f"cohort step, {what}: a step's loss differs from "
                         f"the per-client step's by rel {loss_rel}")
        # one step may cross a ReLU kink that the other does not: 1e-4
        # bounds that (lr times one token's share of a unit's gradient)
        held = step_err if what == "cohort of 16" else err
        tol = 1e-4 if what == "cohort of 16" else 1e-5
        bad = {k: e for k, e in held.items() if not e <= tol}
        if bad:
            raise Failed(f"cohort step, {what}: deltas differ from the "
                         f"per-client step by more than {tol}: {bad}")
        if not_equal:
            raise Failed(f"cohort step, {what}: the graph replay differs "
                         f"from the eager vmapped step in {not_equal}")
    return out


# --------------------------------------------------------------- main paths
def recorded_runs(module):
    """A context in which ``module.Experiment`` is a subclass whose ``run``
    records, for each run: the Experiment, its Result, its learner's
    training calls (``record_calls``), the marks (clock, cohort-step graph
    replays, captures) at its start and at each server update, and the
    kernel launches and graph counts the run added. Yields the list of
    records. The CLIs and the sweep build their Experiments by that name,
    so their own code runs unchanged."""
    import contextlib
    from repro_torch.federated import client

    @contextlib.contextmanager
    def swapped():
        base, runs = module.Experiment, []

        class Recorded(base):
            def run(self, on_round=None, **kw):
                if self.learner is None:
                    self.build_learner()
                marks, calls, evals = [], [], []
                if self.spec.learner == "real":
                    record_calls(self.learner, calls, marks, evals)

                def stamp(*_):
                    marks.append((time.perf_counter(),
                                  client.GRAPH_COUNTS["replays"],
                                  client.GRAPH_COUNTS["captures"]))

                def round_done(ev):
                    stamp()
                    if on_round is not None:
                        on_round(ev)

                launches0, graphs0 = read_launches(), dict(
                    client.GRAPH_COUNTS)
                res = super().run(on_round=round_done, on_start=stamp, **kw)
                runs.append({
                    "experiment": self, "result": res, "calls": calls,
                    "marks": marks, "evals": evals,
                    "launches": {k: v - launches0[k]
                                 for k, v in read_launches().items()},
                    "graphs": {k: v - graphs0[k]
                               for k, v in client.GRAPH_COUNTS.items()}})
                return res

        module.Experiment = Recorded
        try:
            yield runs
        finally:
            module.Experiment = base
    return swapped()


def write_spec(workdir: Path, mode: str) -> Path:
    """5d's full-width spec in ``mode``, written with ``spec.save``."""
    from repro_torch.api import ModelRef
    spec = experiment_spec(mode, ModelRef("paper-charlm"), SEQ_LEN,
                           CONCURRENCY, GOAL, BATCH)
    path = workdir / f"{mode}.json"
    spec.save(str(path))
    return path


def train_cli_path(dev, workdir: Path):
    """Phase 5a: ``repro_torch.launch.train.main(["--spec", S, "--json", J,
    "--ckpt", D])`` on 5d's full-width sync spec S. Held here: the run's
    K1/K2 launches against what the engine's record implies, its graph
    replays against its clients' batch counts (``held_run``); held after
    5d (``cli_equals_experiment``): the JSON summary and every leaf of the
    checkpoint bit-equal to 5d's sync run."""
    from repro_torch.launch import train
    spec_path = write_spec(workdir, "sync")
    out, ckpt = workdir / "train.json", workdir / "ckpt"
    reset_launches()
    with recorded_runs(train) as runs:
        rc = train.main(["--spec", str(spec_path), "--json", str(out),
                         "--ckpt", str(ckpt), "--device", str(dev)])
    launches = read_launches()
    if rc != 0 or len(runs) != 1:
        raise Failed(f"the train CLI returned {rc} after {len(runs)} runs")
    rec = runs[0]
    if rec["experiment"].model_config.param_count() != 15_560_704 or \
            rec["experiment"].spec.max_client_steps != 8:
        raise Failed("the train CLI's run is not at the paper's full width")
    if rec["launches"] != launches:
        raise Failed(f"train CLI: launches {launches} outside its run "
                     f"({rec['launches']})")
    held = held_run("sync", rec)
    held["json_summary"] = json.loads(out.read_text())
    held["checkpoint"] = str(ckpt)
    return held


def cli_equals_experiment(cli, experiment, params,
                          what="5a (the train CLI) equals 5d's sync run") \
        -> None:
    """A train CLI run's JSON summary equals an Experiment's summary (5a's
    and 5d's sync run), and every leaf of its checkpoint equals that
    Experiment's learner's final params, bit for bit."""
    import numpy as np
    from repro_torch.checkpoint import load_checkpoint
    if cli["json_summary"] != experiment["summary"] or \
            cli["summary"] != experiment["summary"]:
        raise Failed(f"{what}: no, the train CLI's summary "
                     f"{cli['json_summary']} is not {experiment['summary']}")
    tree, meta = load_checkpoint(cli["checkpoint"])
    got = tree["params"]
    if sorted(got) != sorted(params):
        raise Failed(f"checkpoint keys {sorted(got)} vs {sorted(params)}")
    differ = [k for k, v in params.items()
              if not (got[k].dtype == np.float32 and
                      np.array_equal(got[k], v.cpu().numpy()))]
    if differ or meta.get("rounds") != ROUNDS:
        raise Failed(f"{what}: no, checkpoint leaves {differ} differ from "
                     f"the final params (meta {meta})")
    print(f"[chip_smoke] {what} bit for bit: summary, JSON and the "
          f"{len(params)} checkpoint leaves; update walls "
          f"{[round(w, 4) for w in cli['round_walls_s']]} s (CLI), "
          f"{[round(w, 4) for w in experiment['round_walls_s']]} s")


def serve_path(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config(SERVE_ARCH)
    if cfg.param_count() != 134_515_008 or cfg.num_layers != 30:
        raise Failed("serve path is not at smollm-135m's full width")
    reset_launches()
    res = serve.run(SERVE_ARCH, reduced=False, batch=SERVE_BATCH,
                    prompt_len=PROMPT_LEN, gen=GEN, device=dev, seed=SEED)
    launches = read_launches()
    print(f"[chip_smoke] launches on the serve path: {launches}")
    want = {"swa_attention": cfg.num_layers,
            "decode_attention": cfg.num_layers * GEN, "wkv": 0,
            **{k: 0 for k in ATTN_TRAIN_KERNELS}}
    check_served(res, cfg, launches, want)
    return res, launches


def check_served(res, cfg, launches, want) -> None:
    """Exact launch counts, tokens in the vocabulary and finite logits."""
    import torch
    for name, n in want.items():
        if launches[name] != n:
            raise Failed(f"expected {n} {name} launches serving {cfg.name}, "
                         f"got {launches[name]}")
    toks = res.tokens
    if tuple(toks.shape) != (SERVE_BATCH, GEN) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size:
        raise Failed(f"generated tokens {tuple(toks.shape)} outside "
                     f"[0, {cfg.vocab_size})")
    if not bool(torch.isfinite(res.logits).all()):
        raise Failed(f"{cfg.name} serve logits are not finite")
    print(f"[chip_smoke] serve {cfg.name}: prefill {res.prefill_s:.4f} s "
          f"({SERVE_BATCH} x {PROMPT_LEN} tokens), decode {res.decode_s:.4f} "
          f"s for {GEN} steps ({res.tokens_per_s:.1f} tokens/s); sample "
          f"{toks[0, :8].tolist()}")


def rwkv_serve_path(dev):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config(RWKV_ARCH)
    if cfg.param_count() != 7_576_621_056 or cfg.num_layers != RWKV_LAYERS:
        raise Failed("rwkv serve path is not at rwkv6-7b's full width")
    reset_launches()
    t0 = time.perf_counter()
    res = serve.run(RWKV_ARCH, reduced=False, batch=SERVE_BATCH,
                    prompt_len=PROMPT_LEN, gen=GEN, device=dev, seed=SEED)
    run_s = time.perf_counter() - t0
    launches = read_launches()
    print(f"[chip_smoke] launches on the rwkv serve path: {launches}; "
          f"serve.run took {run_s:.1f} s, the init included")
    want = {"wkv": cfg.num_layers * (1 + GEN), "swa_attention": 0,
            "decode_attention": 0, **{k: 0 for k in ATTN_TRAIN_KERNELS}}
    check_served(res, cfg, launches, want)
    return res, launches, run_s


def experiment_spec(mode, model, seq_len, concurrency, goal, batch):
    """5a's federated settings in ``mode``; a target perplexity of 1.0 is
    never reached, so every run takes its ROUNDS server updates."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.configs import FederatedConfig, RunConfig
    fed = FederatedConfig(
        mode=mode, concurrency=concurrency, aggregation_goal=goal,
        client_lr=0.3, server_lr=0.02, client_batch_size=batch,
        compression="int8", seed=SEED)
    return ExperimentSpec(model=model, federated=fed,
                          run=RunConfig(target_perplexity=1.0,
                                        max_rounds=ROUNDS),
                          learner="real", seq_len=seq_len)


def codec_launches_from_log(result, mode) -> int:
    """The K1 (and K2) launches the engine's record implies. A sync round
    that is not starved makes one ``client_deltas`` call, whose codec is one
    K1 and one K2 launch over the stacked cohort. An async or carbon-aware
    update calls ``client_delta`` once for each contributor, one K1 and one
    K2 launch each; the contributors are the log's completed sessions, as
    long as every window closed on an update (not on ``max_hours``)."""
    log = result.log
    if mode == "sync":
        return log.rounds - log.starved_rounds
    if result.duration_h >= result.spec.run.max_hours:
        raise Failed(f"{mode} run reached max_hours; its last window "
                     f"closed without an update")
    return log.completed_sessions()


def record_calls(learner, calls, marks, evals) -> None:
    """Wrap the learner's two training calls so that each records the round
    it falls in (the count of ``marks`` so far) and its client ids, and
    its ``eval_perplexity`` so that each call appends its value to
    ``evals``. The wrappers reach the learner through a weak reference and
    its class's functions, so they put it in no reference cycle: a dropped
    learner (and its graphs) is freed at once, not by a later
    collection."""
    import weakref
    ref = weakref.ref(learner)
    for name in ("client_deltas", "client_delta"):
        def spy(ids, *args, _call=getattr(type(learner), name),
                _one=name == "client_delta", **kw):
            calls.append((len(marks), [ids] if _one else list(ids)))
            return _call(ref(), ids, *args, **kw)
        setattr(learner, name, spy)

    def spy_eval(_call=type(learner).eval_perplexity):
        evals.append(_call(ref()))
        return evals[-1]
    learner.eval_perplexity = spy_eval


def experiment_path(dev, mode):
    """Phase 5d in one mode: the port's Experiment at full width. Returns
    what ``held_run`` held and the learner's final params."""
    from repro_torch.api import Experiment, ModelRef
    from repro_torch.federated import client
    spec = experiment_spec(mode, ModelRef("paper-charlm"), SEQ_LEN,
                           CONCURRENCY, GOAL, BATCH)
    exp = Experiment(spec, device=dev)
    if exp.model_config.param_count() != 15_560_704 or \
            spec.max_client_steps != 8:
        raise Failed("experiment path is not at the paper's full width")
    learner = exp.build_learner()
    if learner.device != dev:
        raise Failed(f"the learner runs on {learner.device}, not {dev}")
    marks, calls, evals = [], [], []
    record_calls(learner, calls, marks, evals)

    def mark(_):
        marks.append((time.perf_counter(), client.GRAPH_COUNTS["replays"],
                      client.GRAPH_COUNTS["captures"]))

    reset_launches()
    client.reset_graph_counts()
    result = exp.run(on_start=mark, on_round=mark)
    rec = {"experiment": exp, "result": result, "calls": calls,
           "marks": marks, "evals": evals, "launches": read_launches(),
           "graphs": dict(client.GRAPH_COUNTS)}
    return held_run(mode, rec), exp.learner.params


def attention_launches(layers, captures, evals):
    """The K3 launches a real run of a model with ``layers`` attention
    layers makes (0 for the CharLM): the forward with LSE and each backward
    kernel once a layer in each capture's eager warm-up and once in the
    capture (a replay makes no host call), the forward alone once a layer
    in each eval; no K4 or K5."""
    return {"swa_attention": layers * evals,
            "swa_attention_lse": 2 * layers * captures,
            "swa_attention_bwd_dq": 2 * layers * captures,
            "swa_attention_bwd_dkdv": 2 * layers * captures,
            "decode_attention": 0, "wkv": 0}


def held_run(mode, rec):
    """Holds one full-width run (a record of ``recorded_runs`` or of
    ``experiment_path``): its K1/K2 launches equal what the engine's
    record implies and the attention kernels' what its captures and evals
    imply (``attention_launches``); its summary is finite with ROUNDS
    rounds, sessions and carbon, and so is every perplexity it evaluated;
    each learner call made as many graph replays as its longest client has
    local steps, and one capture ran for each cohort size. Returns what it
    printed."""
    result, calls, marks = rec["result"], rec["calls"], rec["marks"]
    learner, launches, graphs = rec["experiment"].learner, rec["launches"], \
        rec["graphs"]
    want = codec_launches_from_log(result, mode)
    for name in ("int8_quantize", "int8_dequant_accumulate"):
        if launches[name] != want:
            raise Failed(f"{mode}: expected {want} {name} launches from the "
                         f"engine's record, got {launches[name]}")
    cfg = rec["experiment"].model_config
    want_attn = attention_launches(
        cfg.num_layers if cfg.family == "dense" else 0, graphs["captures"],
        len(rec["evals"]))
    got_attn = {k: launches[k] for k in want_attn}
    if got_attn != want_attn:
        raise Failed(f"{mode} ({cfg.name}): attention launches {got_attn}, "
                     f"expected {want_attn} from {graphs['captures']} "
                     f"captures and {len(rec['evals'])} evals")
    if not all(math.isfinite(p) for p in rec["evals"]):
        raise Failed(f"{mode} ({cfg.name}): perplexities {rec['evals']}")
    summary = result.summary()
    bad = [k for k, v in summary.items() if not math.isfinite(v)]
    if bad or summary["rounds"] != ROUNDS or summary["sessions"] <= 0 or \
            summary["carbon_total_kg"] <= 0:
        raise Failed(f"{mode} summary {summary} (not finite: {bad})")
    # replays each call should make, from its clients' batch counts
    fed, steps = learner.fed, learner.max_steps
    want_calls = [(r, max(local_steps(learner.dataset, fed, steps, c)
                          for c in ids)) for r, ids in calls]
    want_graphs = {"replays": sum(n for _, n in want_calls),
                   "captures": len({len(ids) for _, ids in calls})}
    walls = [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    replays = [b[1] - a[1] for a, b in zip(marks, marks[1:])]
    captures = [b[2] - a[2] for a, b in zip(marks, marks[1:])]
    want_replays = [sum(n for r, n in want_calls if r == i)
                    for i in range(1, len(marks))]
    print(f"[chip_smoke] experiment {mode}: update walls "
          f"{[round(w, 4) for w in walls]} s, graph replays {replays} "
          f"(from the clients' batch counts: {want_replays}), captures "
          f"{captures}; {len(calls)} learner calls of "
          f"{sorted({len(ids) for _, ids in calls})} clients")
    if graphs != want_graphs or replays != want_replays:
        raise Failed(f"{mode}: graph counts {graphs} and replays by update "
                     f"{replays}, expected {want_graphs} and {want_replays} "
                     f"from the clients' batch counts")
    out = {"mode": mode, "summary": summary, "wall_s": result.wall_s,
           "round_walls_s": walls, "graph_replays_by_update": replays,
           "graph_captures_by_update": captures,
           "learner_calls": len(calls), "launches": launches,
           "launches_from_log": want, "perplexities": rec["evals"],
           "participation": result.log.participation(),
           "mean_staleness": result.log.mean_staleness(),
           "launches_per_client": None if mode == "sync" else
           launches["int8_quantize"] / want}
    print(f"[chip_smoke] experiment {mode}: {ROUNDS} rounds in "
          f"{result.wall_s:.2f} s, round walls "
          f"{[round(w, 3) for w in walls]}, K1/K2 launches "
          f"{launches['int8_quantize']}/"
          f"{launches['int8_dequant_accumulate']} (engine's record: {want})")
    return out


def peak_device_memory(fn):
    """fn() while a thread polls the card's used memory (all processes,
    ``cudaMemGetInfo``) every 20 ms; returns (fn's value, the used bytes
    before, the peak used bytes). Earlier runs' learners (and their
    graphs' memory pools) are released first."""
    import gc
    import threading
    import torch

    def used():
        free, total = torch.cuda.mem_get_info(0)
        return total - free
    gc.collect()
    torch.cuda.empty_cache()
    before, peak, done = used(), [0], threading.Event()

    def poll():
        while not done.is_set():
            peak[0] = max(peak[0], used())
            done.wait(0.02)
    th = threading.Thread(target=poll, daemon=True)
    th.start()
    try:
        out = fn()
    finally:
        done.set()
        th.join()
    return out, before, max(peak[0], used())


def card_memory(dev):
    """What this process holds on the card, in bytes: the caching
    allocator's segments in its default pool (by stream) and in each CUDA
    graph's private pool, the bytes allocated in them, and the card's used
    memory beyond the reserved segments (with no other process on the
    card: the CUDA context, library workspaces and kernel images)."""
    import torch
    index = torch.device(dev).index
    index = torch.cuda.current_device() if index is None else index
    by_stream, graph_pools = {}, {}
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] != index:
            continue
        pool = tuple(seg.get("segment_pool_id", (0, 0)))
        if pool == (0, 0):
            key = str(seg["stream"])
            by_stream[key] = by_stream.get(key, 0) + seg["total_size"]
        else:
            graph_pools[str(pool)] = graph_pools.get(str(pool), 0) + \
                seg["total_size"]
    free, total = torch.cuda.mem_get_info(index)
    reserved = torch.cuda.memory_reserved(index)
    return {"allocated": torch.cuda.memory_allocated(index),
            "reserved": reserved,
            "default_pool_by_stream": sorted(by_stream.values(),
                                             reverse=True),
            "graph_pools": sorted(graph_pools.values(), reverse=True),
            "used_beyond_reserved": total - free - reserved}


def _gib(n):
    return round(n / 2**30, 3)


def spec_cli_and_sweep_path(dev, workdir: Path, experiments):
    """Phase 5e: ``repro_torch.api.__main__.main([S_async,
    "--roundtrip-check", "--out", R])`` on 5d's full-width async spec (its
    ``s == s2`` must hold), then ``sweep([S_sync, S_async])`` with
    ``workers=1`` (in this process) and ``workers=2`` (two spawned worker
    processes on this card). Every run's summary must equal 5d's in its
    mode bit for bit. The in-process runs are held as 5d's are
    (``held_run``); the spawned workers launch nothing in this process,
    and their Results must cross the pipe with float perplexities."""
    import gc
    import importlib
    import warnings
    import torch
    from repro_torch.api import ExperimentSpec
    from repro_torch.api import __main__ as api_cli
    # the submodule, not the same-named function the package exports
    sweep_mod = importlib.import_module("repro_torch.api.sweep")
    want = {e["mode"]: e["summary"] for e in experiments}
    paths = {m: write_spec(workdir, m) for m in ("sync", "async")}
    out = {}

    def same(mode, summary, what):
        if summary != want[mode]:
            raise Failed(f"{what}: {mode} summary {summary} is not 5d's "
                         f"{want[mode]}")

    # the spec CLI's round trip: two runs of the async spec
    result_path = workdir / "roundtrip.json"
    reset_launches()
    t0 = time.perf_counter()
    with recorded_runs(api_cli) as runs:
        rc = api_cli.main([str(paths["async"]), "--roundtrip-check", "--out",
                           str(result_path), "--quiet", "--device", str(dev)])
    wall = time.perf_counter() - t0
    launches = read_launches()
    if rc != 0 or len(runs) != 2:
        raise Failed(f"the spec CLI returned {rc} after {len(runs)} runs")
    if {k: sum(r["launches"][k] for r in runs) for k in launches} != launches:
        raise Failed(f"spec CLI: launches {launches} outside its runs")
    held = [held_run("async", r) for r in runs]
    for h in held:
        same("async", h["summary"], "the spec CLI --roundtrip-check")
    same("async", json.loads(result_path.read_text())["summary"],
         "the spec CLI's --out")
    out["roundtrip_check"] = {"wall_s": wall,
                              "run_walls_s": [h["wall_s"] for h in held],
                              "round_walls_s": [h["round_walls_s"]
                                                for h in held],
                              "launches": launches}
    print(f"[chip_smoke] spec CLI --roundtrip-check: both runs equal 5d's "
          f"async run; run walls {[round(h['wall_s'], 4) for h in held]} s, "
          f"call {wall:.2f} s")

    specs = [ExperimentSpec.load(str(paths[m])) for m in ("sync", "async")]
    from repro_torch.kernels import _build
    for workers in (1, 2):
        built = sorted((p.name, p.stat().st_mtime_ns)
                       for p in _build.BUILD_DIR.iterdir())
        reset_launches()
        with recorded_runs(sweep_mod) as runs, warnings.catch_warnings():
            # a pool that cannot start falls back in-process with a
            # RuntimeWarning: here that fails the phase
            warnings.simplefilter("error", RuntimeWarning)
            t0 = time.perf_counter()
            results, before, peak = peak_device_memory(
                lambda: sweep_mod.sweep(specs, workers=workers,
                                        device=str(dev)))
            wall = time.perf_counter() - t0
        launches = read_launches()
        if sorted((p.name, p.stat().st_mtime_ns)
                  for p in _build.BUILD_DIR.iterdir()) != built:
            raise Failed(f"sweep workers={workers} rebuilt kernels: the "
                         f"workers must load phase 1's builds")
        for spec, r in zip(specs, results):
            same(spec.federated.mode, r.summary(), f"sweep workers={workers}")
            if type(r.final_perplexity) is not float or \
                    type(r.smoothed_perplexity) is not float:
                raise Failed(f"sweep workers={workers}: a Result holds "
                             f"{type(r.final_perplexity)} perplexities")
        if workers == 1:
            if len(runs) != 2:
                raise Failed(f"sweep workers=1 made {len(runs)} runs here")
            for spec, rec in zip(specs, runs):
                held_run(spec.federated.mode, rec)
            if {k: sum(rec["launches"][k] for rec in runs)
                    for k in launches} != launches:
                raise Failed(f"sweep: launches {launches} outside its runs")
            captures = [rec["graphs"]["captures"] for rec in runs]
            # a record reaches every run's learner (through its class's
            # closure): drop them before the next memory probe, and read
            # what the two runs' learners held
            held = card_memory(dev)
            del rec
            runs.clear()
            gc.collect()
            torch.cuda.empty_cache()
            released = card_memory(dev)
            out["memory_of_two_runs"] = {"captures": captures,
                                         "held": held, "released": released}
            print(f"[chip_smoke] what the two in-process runs hold on the "
                  f"card ({captures} graph captures): "
                  f"{len(held['graph_pools'])} graph pools "
                  f"{[_gib(b) for b in held['graph_pools']]} GiB, the "
                  f"default pool by stream "
                  f"{[_gib(b) for b in held['default_pool_by_stream']]} GiB, "
                  f"allocated {_gib(held['allocated'])} of reserved "
                  f"{_gib(held['reserved'])} GiB, beyond reserved "
                  f"{_gib(held['used_beyond_reserved'])} GiB; after their "
                  f"release: reserved {_gib(released['reserved'])} GiB "
                  f"({len(released['graph_pools'])} graph pools), beyond "
                  f"reserved {_gib(released['used_beyond_reserved'])} GiB")
        elif runs or any(launches.values()):
            raise Failed(f"sweep workers=2 ran {len(runs)} runs and "
                         f"launched {launches} in this process, not in its "
                         f"workers")
        out[f"sweep_workers_{workers}"] = {
            "wall_s": wall, "run_walls_s": [r.wall_s for r in results],
            "device_used_bytes_before": before,
            "device_used_bytes_peak": peak,
            "device_bytes_added_at_peak": peak - before,
            "launches_here": launches}
        print(f"[chip_smoke] sweep workers={workers}: both summaries equal "
              f"5d's, the kernels loaded from phase 1's builds; call "
              f"{wall:.2f} s, run walls "
              f"{[round(r.wall_s, 3) for r in results]} s; card memory used "
              f"{before / 2**30:.2f} GiB before, peak {peak / 2**30:.2f} GiB "
              f"(+{(peak - before) / 2**30:.2f} GiB)")
    return out


def captured_graphs():
    """A context in which every ``torch.cuda.graph`` capture (the cohort
    step's, ``federated/client.py``) records the kernel launches made
    while it captured and the graph it made. Yields the list of
    (launches, CUDAGraph)."""
    import contextlib
    import torch

    @contextlib.contextmanager
    def swapped():
        base, records = torch.cuda.graph, []

        class Recorded(base):
            def __enter__(self):
                self._launches0 = read_launches()
                return super().__enter__()

            def __exit__(self, *exc):
                out = super().__exit__(*exc)
                after = read_launches()
                records.append(({k: v - self._launches0[k]
                                 for k, v in after.items()},
                                self.cuda_graph))
                return out

        torch.cuda.graph = Recorded
        try:
            yield records
        finally:
            torch.cuda.graph = base
    return swapped()


def replay_profiled(graph):
    """One replay of ``graph`` under torch.profiler: the count of its
    device events by K3 kernel (forward, dQ, dK/dV) and all its events."""
    import torch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"swa_attention_lse": sum("swa_attention_kernel" in n
                                     for n in names),
            "swa_attention_bwd_dq": sum("swa_attention_bwd_dq_kernel" in n
                                        for n in names),
            "swa_attention_bwd_dkdv": sum("swa_attention_bwd_dkdv_kernel" in n
                                          for n in names),
            "device_events": len(names)}


def held_smollm_run(mode, rec, graphs, dev, peak):
    """``held_run`` for a smollm-135m run, and: the run is at full width;
    each capture launched each K3 training kernel once a layer and nothing
    else; one replay of its last graph under torch.profiler shows each of
    those kernels once a layer. Returns what it printed."""
    cfg = rec["experiment"].model_config
    if cfg.param_count() != SMOLLM_PARAMS or cfg.num_layers != SMOLLM_LAYERS:
        raise Failed(f"{mode}: the smollm run is not at full width "
                     f"({cfg.param_count()} params)")
    held = held_run(mode, rec)
    want = {k: SMOLLM_LAYERS if k in ATTN_TRAIN_KERNELS else 0
            for k in read_launches()}
    per_capture = [launches for launches, _ in graphs]
    if len(graphs) != rec["graphs"]["captures"] or \
            any(c != want for c in per_capture):
        raise Failed(f"{mode}: launches at each capture {per_capture}, "
                     f"expected {len(graphs) and want} at each of "
                     f"{rec['graphs']['captures']}")
    seen = replay_profiled(graphs[-1][1])
    if any(seen[k] != SMOLLM_LAYERS for k in ATTN_TRAIN_KERNELS):
        raise Failed(f"{mode}: one replay of the cohort graph under "
                     f"torch.profiler shows {seen}, not {SMOLLM_LAYERS} of "
                     f"each K3 training kernel")
    held.update(launches_per_capture=per_capture[0],
                replay_under_profiler=seen, peak_memory_bytes=peak,
                params=cfg.param_count())
    print(f"[chip_smoke] smollm {mode}: each of {len(graphs)} captures "
          f"launched {SMOLLM_LAYERS} x (K3 with LSE, dQ, dK/dV); one replay "
          f"under torch.profiler: {seen}; perplexities "
          f"{[round(p, 4) for p in rec['evals']]}; peak memory "
          f"{peak / 2**30:.2f} GiB")
    return held


def smollm_train_path(dev, workdir: Path):
    """Phase 5f: the reference train CLI's smollm example at full width
    (``--arch smollm-135m --mode async --concurrency 6``, 3 rounds, seq_len
    64, int8): ``repro_torch.launch.train.main`` with ``--json`` and
    ``--ckpt``; ``Experiment(spec).run()`` on the same spec (saved with
    ``--save-spec``), whose summary must equal the CLI's and whose final
    params its checkpoint, bit for bit; then a sync spec through
    ``Experiment`` (concurrency 8, goal 6, batch 8, the same settings).
    Each run is held by ``held_smollm_run``."""
    import gc
    import torch
    from repro_torch.api import Experiment, ExperimentSpec, ModelRef
    from repro_torch.federated import client
    from repro_torch.launch import train
    spec_path = workdir / "smollm_async.json"
    if train.main(SMOLLM_TRAIN + ["--save-spec", str(spec_path)]) != 0:
        raise Failed("the train CLI did not save the smollm spec")

    def run(fn):
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        with captured_graphs() as graphs:
            res = fn()
        return res, graphs, read_launches(), \
            torch.cuda.max_memory_allocated(dev)

    j, ckpt = workdir / "smollm_train.json", workdir / "smollm_ckpt"

    def cli():
        with recorded_runs(train) as runs:
            rc = train.main(SMOLLM_TRAIN + ["--json", str(j), "--ckpt",
                                            str(ckpt), "--device", str(dev)])
        if rc != 0 or len(runs) != 1:
            raise Failed(f"the train CLI returned {rc} after {len(runs)} "
                         f"runs")
        return runs[0]
    rec, graphs, launches, peak = run(cli)
    # the CLI evaluates the initial perplexity before its run
    outside = {k: v - rec["launches"][k] for k, v in launches.items()}
    if outside != {k: SMOLLM_LAYERS if k == "swa_attention" else 0
                   for k in launches}:
        raise Failed(f"train CLI (smollm): launches outside its run "
                     f"{outside}")
    cli_out = held_smollm_run("async", rec, graphs, dev, peak)
    cli_out.update(json_summary=json.loads(j.read_text()),
                   checkpoint=str(ckpt), launches_with_initial_eval=launches)
    del rec, graphs
    gc.collect()

    def experiment(spec):
        def go():
            exp = Experiment(spec, device=dev)
            marks, calls, evals = [], [], []
            record_calls(exp.build_learner(), calls, marks, evals)

            def mark(_):
                marks.append((time.perf_counter(),
                              client.GRAPH_COUNTS["replays"],
                              client.GRAPH_COUNTS["captures"]))
            client.reset_graph_counts()
            result = exp.run(on_start=mark, on_round=mark)
            return {"experiment": exp, "result": result, "calls": calls,
                    "marks": marks, "evals": evals,
                    "launches": read_launches(),
                    "graphs": dict(client.GRAPH_COUNTS)}
        return run(go)

    rec, graphs, _, peak = experiment(ExperimentSpec.load(str(spec_path)))
    exp_async = held_smollm_run("async", rec, graphs, dev, peak)
    cli_equals_experiment(cli_out, exp_async, rec["experiment"].learner.params,
                          "5f: the train CLI's smollm example equals "
                          "Experiment(spec).run() on its spec")
    del rec, graphs
    gc.collect()
    sync = experiment_spec("sync", ModelRef(SMOLLM), 64, concurrency=8,
                           goal=6, batch=8)
    rec, graphs, _, peak = experiment(sync)
    exp_sync = held_smollm_run("sync", rec, graphs, dev, peak)
    del rec, graphs
    gc.collect()
    torch.cuda.empty_cache()
    return {"train_cli": cli_out, "experiment_async": exp_async,
            "experiment_sync": exp_sync}


# ------------------------------------------------------------------ outputs
def rescale_qkv(params) -> None:
    """wq, wk and wv of a transformer's params, in place, from the
    reference init's 1/sqrt(heads) to 1/sqrt(d_model) (see
    ``serve_consistency``)."""
    for w in ("wq", "wk", "wv"):
        t = params[f"blocks/{w}"]
        t *= math.sqrt(t.shape[-2] / t.shape[1])


def small_experiments(dev, arch="paper-charlm", modes=MODES):
    """The modes of 5d (5f) at a small size (the train CLI's
    ``reduced_model_ref``, seq_len 16), on the card and on the CPU from the
    same weights: equal summaries but for the perplexity (rel 1e-3, as in
    small_round), equal participation and mean staleness. A transformer
    starts from wq/wk/wv rescaled (``rescale_qkv``): under the reference's
    init the reduced smollm is chaotic in f32 (one f32 rounding of the init
    moves the JAX learner's own perplexity by 6.6% after 3 sync rounds,
    ``tests/test_torch_train_transformer.py``)."""
    from repro_torch.api import Experiment
    from repro_torch.federated import RealLearner
    from repro_torch.launch import train
    from repro_torch.weights import params_to_numpy
    ref = train.reduced_model_ref(arch)
    small = ref.resolve()
    for mode in modes:
        spec = experiment_spec(mode, ref, 16, concurrency=8, goal=6, batch=8)
        cpu_exp = Experiment(spec, device="cpu")
        cpu_learner = cpu_exp.build_learner()
        if small.family == "dense":
            rescale_qkv(cpu_learner.params)     # the history holds the same
        card_learner = RealLearner(
            small, spec.federated, spec.run, cpu_learner.dataset,
            max_client_steps=spec.max_client_steps, device=dev,
            init_params=params_to_numpy(cpu_learner.params))
        card = Experiment(spec, learner=card_learner).run()
        cpu = cpu_exp.run()
        got, want = card.summary(), cpu.summary()
        for k in want:
            same = math.isclose(got[k], want[k], rel_tol=1e-3) \
                if k == "perplexity" else got[k] == want[k]
            if not same:
                raise Failed(f"small {mode} experiment: {k} on the card "
                             f"{got[k]} vs CPU {want[k]}")
        for what in ("participation", "mean_staleness"):
            a, b = getattr(card.log, what)(), getattr(cpu.log, what)()
            if a != b:
                raise Failed(f"small {mode} experiment: {what} on the card "
                             f"{a} vs CPU {b}")
        print(f"[chip_smoke] small {arch} {mode} experiment: card equals "
              f"the CPU; "
              f"perplexity card {got['perplexity']:.6f}, CPU "
              f"{want['perplexity']:.6f}")


def smollm_step_against_cpu(dev):
    """smollm-135m at full width and 2 layers, wq/wk/wv rescaled
    (``rescale_qkv``): one local step of a cohort of 2 clients (batch 8,
    seq_len 64, the learner's cohort step, replayed from a CUDA graph on
    the card) gives the CPU's delta within 1e-4 x max(1, |CPU delta|) in
    each leaf."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import FederatedDataset
    from repro_torch.federated import client
    from repro_torch.federated.client import stack_batches, to_device
    from repro_torch.models import get_model
    cfg = dataclasses.replace(get_config(SMOLLM), num_layers=2)
    model = get_model(cfg)
    params, _ = model.init(torch.Generator().manual_seed(SEED))
    rescale_qkv(params)
    ds = FederatedDataset(vocab_size=cfg.vocab_size, seq_len=64)
    stacked = [stack_batches(ds.client_batches(c, 8), 1) for c in (0, 1)]
    batches = {k: np.stack([b[k] for b, _ in stacked]) for k in stacked[0][0]}
    masks = np.stack([m for _, m in stacked])
    want = client.make_cohort_update(model.loss, 0.3)(
        params, to_device(batches, "cpu"), masks)[0]
    got = client.make_cohort_update(model.loss, 0.3)(
        {k: v.to(dev) for k, v in params.items()}, to_device(batches, dev),
        masks)[0]
    rel = {k: float((got[k].cpu() - w).abs().max())
           / max(1.0, float(w.abs().max())) for k, w in want.items()}
    print(f"[chip_smoke] smollm-135m full width, 2 layers: one cohort step "
          f"on the card against the CPU, max abs err / max(1, |delta|) by "
          f"leaf {rel}")
    if not all(e <= 1e-4 for e in rel.values()):
        raise Failed(f"smollm cohort step: card differs from the CPU by "
                     f"{rel}")
    return rel


def small_round(dev):
    """One round of 5d's sync settings at a small size, on the card and on
    the CPU from the same weights: perplexity within rel 1e-3."""
    from repro_torch.api import ModelRef
    from repro_torch.configs import RunConfig
    from repro_torch.data import FederatedDataset
    from repro_torch.federated import RealLearner
    from repro_torch.launch import train
    from repro_torch.weights import params_to_numpy
    small = train.reduced_model_ref("paper-charlm").resolve()
    fed = experiment_spec("sync", ModelRef("paper-charlm"), SEQ_LEN,
                          CONCURRENCY, GOAL, BATCH).federated
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
        raise Failed(f"small round: card perplexity {p_gpu} vs CPU {p_cpu}")
    print(f"[chip_smoke] small round perplexity: card {p_gpu:.6f}, "
          f"CPU {p_cpu:.6f}")


def serve_consistency(dev):
    """The reference's decode check at full width: prefill(t[:-1]) +
    decode_step(t[-1]) against the full forward's last-position logits.

    The reference's init draws wq, wk and wv with scale 1/sqrt(heads) (its
    ParamBuilder's 1/sqrt(shape[-2]) on a (d, H, hd) weight), not
    1/sqrt(d_model), so attention scores have a standard deviation near 100
    and the softmax is almost one-hot: at 30 layers the model is chaotic in
    f32, and no two orders of summation agree. So the check is made with
    those three projections rescaled to 1/sqrt(d_model), and under the
    reference's init the error is printed but not held. For each init the
    logits' change under a relative input noise of 1e-7 (one f32 rounding)
    says how far any f32 implementation can agree."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = get_config(SERVE_ARCH)
    model = get_model(cfg)
    g = torch.Generator().manual_seed(SEED + 1)
    params, _ = model.init(g, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT_LEN),
                         generator=g).to(dev)
    noise = (1 + 1e-7 * torch.randn(SERVE_BATCH, PROMPT_LEN, cfg.d_model,
                                    generator=g)).to(dev)
    out = {}
    for init in ("reference", "rescaled"):
        if init == "rescaled":
            rescale_qkv(params)
        with torch.no_grad():
            e = model._embed(params, toks)
            full = model.logits(params, model._stack(params, e)[:, -1:])[:, 0]
            noisy = model.logits(params,
                                 model._stack(params, e * noise)[:, -1:])[:, 0]
            _, cache = model.prefill(params, toks[:, :-1], pad_to=PROMPT_LEN)
            dec, _ = model.decode_step(params, cache, toks[:, -1])
        out[init] = {"max_abs_err": float((dec - full).abs().max()),
                     "noise_1e-7_max_abs_change":
                         float((noisy - full).abs().max()),
                     "logits_max_abs": float(full.abs().max())}
        print(f"[chip_smoke] full width, {init} init: prefill(t[:-1]) + "
              f"decode(t[-1]) vs full forward {out[init]}")
    if not torch.allclose(dec, full, atol=2e-3, rtol=2e-3):
        raise Failed(f"prefill + decode differs from the full forward: max "
                     f"abs err {out['rescaled']['max_abs_err']}")
    return out


def rwkv_consistency(dev):
    """The reference's decode check for rwkv6-7b at full width (d_model
    4096, 64 heads, d_ff 14336, vocab 65536) and RWKV_CHECK_LAYERS layers
    (phase 5c runs all 32): prefill(t[:-1]) + decode_step(t[-1]) against
    the full forward's last-position logits, and the states it carries
    (WKV and both token shifts) against the full prompt's. The two paths
    run K5 over 1023 steps and then 1, against 1024 in one launch, and
    cuBLAS over other row counts.

    As for smollm-135m (``serve_consistency``), the reference's init draws
    the (d, H, hd) projections wr/wk/wv/wg at 1/sqrt(heads), not
    1/sqrt(d_model): r, k and v have standard deviations near 8. Both inits
    are run, printed and held (logits atol 2e-3 + rtol 2e-3, each state
    within 2e-3 of its largest entry), each beside the change of the logits
    under a relative input noise of 1e-7 (one f32 rounding), which says how
    far any two f32 implementations can agree: unlike smollm's, this model
    is not chaotic under the reference's init at this depth (the per-head
    group norm rescales o)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = dataclasses.replace(get_config(RWKV_ARCH),
                              num_layers=RWKV_CHECK_LAYERS)
    model = get_model(cfg)
    g = torch.Generator().manual_seed(SEED + 1)
    params, _ = model.init(g, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT_LEN),
                         generator=g).to(dev)
    noise = (1 + 1e-7 * torch.randn(SERVE_BATCH, PROMPT_LEN, cfg.d_model,
                                    generator=g)).to(dev)

    def forward(x):
        states, _ = model._zero_states(SERVE_BATCH, x.dtype, dev)
        x, states = model._stack(params, x, states)
        return model.logits(params, x[:, -1:])[:, 0], states

    out, held = {}, {}
    for init in ("reference", "rescaled"):
        if init == "rescaled":
            for w in ("wr", "wk", "wv", "wg"):
                t = params[f"blocks/{w}"]
                t *= math.sqrt(t.shape[-2] / t.shape[1])
        with torch.no_grad():
            e = params["embed"][toks]
            full, full_st = forward(e)
            noisy, _ = forward(e * noise)
            _, cache = model.prefill(params, toks[:, :-1])
            dec, cache = model.decode_step(params, cache, toks[:, -1])
        st_err = {k: float((cache[k] - full_st[k]).abs().max())
                  for k in ("wkv", "tm_tok", "cm_tok")}
        st_max = {k: float(full_st[k].abs().max()) for k in st_err}
        out[init] = {"max_abs_err": float((dec - full).abs().max()),
                     "noise_1e-7_max_abs_change":
                         float((noisy - full).abs().max()),
                     "logits_max_abs": float(full.abs().max()),
                     "state_max_abs_err": st_err, "state_max_abs": st_max}
        held[init] = bool(torch.allclose(dec, full, atol=2e-3, rtol=2e-3)) \
            and all(st_err[k] <= 2e-3 * max(1.0, st_max[k]) for k in st_err)
        print(f"[chip_smoke] rwkv6-7b at full width, {RWKV_CHECK_LAYERS} "
              f"layers, {init} init: prefill(t[:-1]) + decode(t[-1]) vs "
              f"full forward {out[init]}")
    for init, ok in held.items():
        if not ok:
            raise Failed(f"rwkv prefill + decode differs from the full "
                         f"forward under the {init} init: {out[init]}")
    return out


def small_serve(dev, arch):
    import torch
    from repro_torch.launch import serve
    kw = dict(reduced=True, batch=2, prompt_len=16, gen=8, seed=SEED)
    card = serve.run(arch, device=dev, **kw)
    cpu = serve.run(arch, device="cpu", **kw)
    if not torch.equal(card.tokens, cpu.tokens):
        raise Failed(f"small serve of {arch}: card tokens "
                     f"{card.tokens.tolist()} vs CPU {cpu.tokens.tolist()}")
    e = float((card.logits.cpu() - cpu.logits).abs().max())
    print(f"[chip_smoke] small serve of {arch}: card tokens equal the CPU's; "
          f"last logits max abs diff {e:.3g}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time-only", action="store_true",
                    help="run phases 1, 2 and 4 only")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the src directory whose repro_torch is run")
    args = ap.parse_args()
    src = args.src.resolve()
    if not (src / "repro_torch").is_dir():
        return fail(f"no port package under {src}: run from a checkout")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import get_model

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

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

    try:
        phase("3. kernels against their plain versions"
              + (" (skipped: --time-only)" if args.time_only else ""))
        cfg = get_config("paper-charlm")
        shapes, _ = get_model(cfg).init(device="meta")
        leaf_shapes = {k: tuple(v.shape) for k, v in shapes.items()}
        gen = torch.Generator(device=dev).manual_seed(SEED)
        if not args.time_only:
            err = check_int8(dev, gen, leaf_shapes)
            err.update(check_attention(dev, gen))
            err.update(check_wkv(dev, gen))
            bwd_err, bwd_rel = check_attention_bwd(dev, gen)
            phase("3b. the cohort step against the looped client step")
            cohort = check_cohort(dev)

        phase("4. timing at the main paths' shapes")
        timing = time_int8(dev, gen, leaf_shapes)
        timing.update(time_attention(dev, gen))
        timing.update(time_wkv(dev, gen))
        from repro_torch.kernels.swa_attention import kernel as AK
        if hasattr(AK, "attention_bwd"):        # a port from PR 20 on
            timing["attention_training"] = time_attention_bwd(dev, gen)
        if args.time_only:
            print(json.dumps({"src": str(src), "card": card,
                              "timing": timing}))
            return 0
        for name in ("int8_quantize", "int8_dequant_accumulate"):
            t = timing[name]
            print(f"[chip_smoke] {name}: {t['ms']:.4f} ms eager, "
                  f"{t['graph_ms']:.4f} ms in a CUDA graph, for a round's "
                  f"{len(leaf_shapes)} leaves in one launch (per-leaf loop "
                  f"{t['per_leaf_loop']['ms']:.4f} ms; plain "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms)")
        print(f"[chip_smoke] compress_roundtrip wall for one round: "
              f"{timing['int8_quantize']['compress_roundtrip_wall_ms']}")

        workdir = ROOT / "build" / "chip_smoke"
        shutil.rmtree(workdir, ignore_errors=True)
        workdir.mkdir(parents=True)
        phase("5a. main path: the train CLI (repro_torch.launch.train) at "
              "full width")
        cli = train_cli_path(dev, workdir)
        phase("5b. main path: repro_torch.launch.serve at full width")
        res, serve_launches = serve_path(dev)
        phase("5c. main path: repro_torch.launch.serve, rwkv6-7b at full "
              "width")
        rwkv_res, rwkv_launches, rwkv_run_s = rwkv_serve_path(dev)
        phase("5d. main path: repro_torch.api.Experiment at full width")
        experiments, final_params = [], {}
        for mode in MODES:
            e, final_params[mode] = experiment_path(dev, mode)
            experiments.append(e)
        cli_equals_experiment(cli, experiments[0], final_params["sync"])
        del final_params
        phase("5e. main path: the spec CLI (repro_torch.api) and sweep at "
              "full width")
        spec_cli_sweep = spec_cli_and_sweep_path(dev, workdir, experiments)
        phase("5f. main path: the train CLI's smollm-135m example at full "
              "width, then Experiment in async and sync mode")
        smollm = smollm_train_path(dev, workdir)

        phase("6. outputs")
        small_round(dev)
        small_experiments(dev)
        small_experiments(dev, SMOLLM, ("sync", "async"))
        smollm_step = smollm_step_against_cpu(dev)
        consistency = serve_consistency(dev)
        rwkv_consistent = rwkv_consistency(dev)
        small_serve(dev, SERVE_ARCH)
        small_serve(dev, RWKV_ARCH)
    except Failed as e:
        return fail(str(e))

    launches = {**{k: cli["launches"][k] for k in ("int8_quantize",
                                                  "int8_dequant_accumulate")},
                **{k: serve_launches[k] for k in ("swa_attention",
                                                  "decode_attention")},
                "wkv": rwkv_launches["wkv"]}
    kernels = []
    for name, tpu in TPU_KERNELS.items():
        if name in ATTN_TRAIN_KERNELS:
            continue                    # below, from 5f and their timing
        t = timing[name]
        extra = {k: v for k, v in t.items()
                 if k not in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}
        for suffix in ("_bf16", "_over_scale", "_bf16_over_scale"):
            if f"{name}{suffix}" in err:
                extra[f"max_abs_err{suffix}"] = err[f"{name}{suffix}"]
        if name.startswith("int8_"):
            extra["launches_experiment"] = {
                e["mode"]: e["launches"][name] for e in experiments}
            extra["launches_spec_cli_roundtrip"] = \
                spec_cli_sweep["roundtrip_check"]["launches"][name]
            extra["launches_sweep_workers_1"] = \
                spec_cli_sweep["sweep_workers_1"]["launches_here"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": CU_SOURCES[name],
            "replaces": tpu, "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "check": CHECKS[name], **extra})
    train_timing = timing["attention_training"]
    for name in ATTN_TRAIN_KERNELS:
        t = train_timing["training"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": CU_SOURCES[name],
            "replaces": TPU_KERNELS[name],
            "launches": smollm["train_cli"]["launches"][name],
            "max_abs_err": bwd_err[name], "ms": t["ms"],
            "graph_ms": t["graph_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "check": CHECKS[name], "max_rel_err": bwd_rel[name],
            "shape": train_timing["training"]["shape"],
            "serving_length": train_timing["serving"][name],
            "launches_per_capture":
                smollm["train_cli"]["launches_per_capture"][name],
            "launches_experiment": {
                k: smollm[k]["launches"][name]
                for k in ("experiment_async", "experiment_sync")}})
    print(json.dumps({"attention_training_timing": train_timing}))
    print(json.dumps({"smollm_training": smollm,
                      "smollm_step_card_vs_cpu": smollm_step}))
    print(json.dumps({"cohort_step": cohort}))
    print(json.dumps({"train_cli": cli}))
    print(json.dumps({"spec_cli_and_sweep": spec_cli_sweep}))
    print(json.dumps({"serve": {
        "arch": SERVE_ARCH, "batch": SERVE_BATCH, "prompt_len": PROMPT_LEN,
        "gen": GEN, "prefill_s": res.prefill_s, "decode_s": res.decode_s,
        "tokens_per_s": res.tokens_per_s,
        "prefill_plus_decode_vs_full_forward": consistency}}))
    print(json.dumps({"serve_rwkv": {
        "arch": RWKV_ARCH, "params": rwkv_res.config.param_count(),
        "batch": SERVE_BATCH, "prompt_len": PROMPT_LEN, "gen": GEN,
        "prefill_s": rwkv_res.prefill_s, "decode_s": rwkv_res.decode_s,
        "tokens_per_s": rwkv_res.tokens_per_s, "run_s": rwkv_run_s,
        "prefill_plus_decode_vs_full_forward": rwkv_consistent}}))
    for e in experiments:
        print(json.dumps({"experiment": e}))
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
