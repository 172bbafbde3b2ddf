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
     CUDA graph;
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
     of ``compress_roundtrip`` for one round;
  5. drive the port's three main paths, each with the kernels' launch counts
     reset just before and read just after:
     a. ``repro_torch.launch.train``: 3 sync FedAvg rounds of paper-charlm
        at full width (15,560,704 params), concurrency 20, goal 16, seq_len
        64, client batch 16, 8 client steps, int8 uplink; exactly one K1
        and one K2 launch a round;
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
        async or carbon-aware update);
  6. check the outputs: finite perplexities, and on a small config one
     round on the card agrees with the same round on the CPU (plain
     versions of the kernels); the three modes of 5d at a small size give
     the CPU's summary, participation and mean staleness (perplexity
     within rel 1e-3), and 5d's summaries are finite with 3 rounds,
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


# --------------------------------------------------------------- main paths
def train_path(dev, cfg):
    from repro_torch.configs import FederatedConfig
    from repro_torch.launch import train
    fed = FederatedConfig(
        mode="sync", concurrency=CONCURRENCY, aggregation_goal=GOAL,
        client_lr=0.3, server_lr=0.02, client_batch_size=BATCH,
        compression="int8", seed=SEED)
    if train.MAX_CLIENT_STEPS != 8 or cfg.param_count() != 15_560_704:
        raise Failed("train path is not at the paper's full width")
    reset_launches()
    records = train.run(cfg, fed, ROUNDS, SEQ_LEN, device=dev)
    launches = read_launches()
    print(f"[chip_smoke] launches on the train path: {launches}")
    for name in ("int8_quantize", "int8_dequant_accumulate"):
        if launches[name] == 0:
            raise Failed(f"{name} never ran on the train path")
    # one K1 launch over the cohort's table of leaves and one K2 launch
    # (the dequantize of the whole layout) for each round's compress
    for name in ("int8_quantize", "int8_dequant_accumulate"):
        if launches[name] != ROUNDS:
            raise Failed(f"expected {ROUNDS} {name} launches (one a round), "
                         f"got {launches[name]}")
    ppl = [r.perplexity for r in records]
    if len(records) != ROUNDS or not all(math.isfinite(p) for p in ppl):
        raise Failed(f"train path perplexities {ppl}")
    return records, launches, fed


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
            "decode_attention": cfg.num_layers * GEN, "wkv": 0}
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
            "decode_attention": 0}
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


def experiment_path(dev, mode):
    """Phase 5d in one mode: the port's Experiment at full width."""
    from repro_torch.api import Experiment, ModelRef
    spec = experiment_spec(mode, ModelRef("paper-charlm"), SEQ_LEN,
                           CONCURRENCY, GOAL, BATCH)
    exp = Experiment(spec, device=dev)
    if exp.model_config.param_count() != 15_560_704 or \
            spec.max_client_steps != 8:
        raise Failed("experiment path is not at the paper's full width")
    learner = exp.build_learner()
    if learner.device != dev:
        raise Failed(f"the learner runs on {learner.device}, not {dev}")
    marks = []
    reset_launches()
    result = exp.run(on_start=lambda _: marks.append(time.perf_counter()),
                     on_round=lambda _: marks.append(time.perf_counter()))
    launches = read_launches()
    want = codec_launches_from_log(result, mode)
    for name in ("int8_quantize", "int8_dequant_accumulate"):
        if launches[name] != want:
            raise Failed(f"{mode}: expected {want} {name} launches from the "
                         f"engine's record, got {launches[name]}")
    for name in ("swa_attention", "decode_attention", "wkv"):
        if launches[name]:
            raise Failed(f"{mode}: {name} ran on the experiment path")
    summary = result.summary()
    bad = [k for k, v in summary.items() if not math.isfinite(v)]
    if bad or summary["rounds"] != ROUNDS or summary["sessions"] <= 0 or \
            summary["carbon_total_kg"] <= 0:
        raise Failed(f"{mode} summary {summary} (not finite: {bad})")
    walls = [b - a for a, b in zip(marks, marks[1:])]
    out = {"mode": mode, "summary": summary, "wall_s": result.wall_s,
           "round_walls_s": walls, "launches": launches,
           "launches_from_log": want,
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


# ------------------------------------------------------------------ outputs
def small_experiments(dev):
    """The three modes of 5d at a small size (train.reduced_config,
    seq_len 16), on the card and on the CPU from the same weights: equal
    summaries but for the perplexity (rel 1e-3, as in small_round), equal
    participation and mean staleness."""
    from repro_torch.api import Experiment, ModelRef
    from repro_torch.federated import RealLearner
    from repro_torch.launch import train
    from repro_torch.weights import params_to_numpy
    small = train.reduced_config("paper-charlm")
    for mode in MODES:
        spec = experiment_spec(mode, ModelRef.from_config(small), 16,
                               concurrency=8, goal=6, batch=8)
        cpu_exp = Experiment(spec, device="cpu")
        cpu_learner = cpu_exp.build_learner()
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
        print(f"[chip_smoke] small {mode} experiment: card equals the CPU; "
              f"perplexity card {got['perplexity']:.6f}, CPU "
              f"{want['perplexity']:.6f}")


def small_round(dev, fed):
    from repro_torch.configs import RunConfig
    from repro_torch.data import FederatedDataset
    from repro_torch.federated import RealLearner
    from repro_torch.launch import train
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
            for w in ("wq", "wk", "wv"):
                t = params[f"blocks/{w}"]
                t *= math.sqrt(t.shape[-2] / t.shape[1])
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

        phase("4. timing at the main paths' shapes")
        timing = time_int8(dev, gen, leaf_shapes)
        timing.update(time_attention(dev, gen))
        timing.update(time_wkv(dev, gen))
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

        phase("5a. main path: repro_torch.launch.train at full width")
        records, train_launches, fed = train_path(dev, cfg)
        phase("5b. main path: repro_torch.launch.serve at full width")
        res, serve_launches = serve_path(dev)
        phase("5c. main path: repro_torch.launch.serve, rwkv6-7b at full "
              "width")
        rwkv_res, rwkv_launches, rwkv_run_s = rwkv_serve_path(dev)
        phase("5d. main path: repro_torch.api.Experiment at full width")
        experiments = [experiment_path(dev, mode) for mode in MODES]

        phase("6. outputs")
        small_round(dev, fed)
        small_experiments(dev)
        consistency = serve_consistency(dev)
        rwkv_consistent = rwkv_consistency(dev)
        small_serve(dev, SERVE_ARCH)
        small_serve(dev, RWKV_ARCH)
    except Failed as e:
        return fail(str(e))

    launches = {**{k: train_launches[k] for k in ("int8_quantize",
                                                  "int8_dequant_accumulate")},
                **{k: serve_launches[k] for k in ("swa_attention",
                                                  "decode_attention")},
                "wkv": rwkv_launches["wkv"]}
    kernels = []
    for name, tpu in TPU_KERNELS.items():
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
        kernels.append({
            "name": name, "route": "cuda", "source": CU_SOURCES[name],
            "replaces": tpu, "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "check": CHECKS[name], **extra})
    print(json.dumps({"rounds": [{"round": r.round, "perplexity": r.perplexity,
                                  "wall_s": r.wall_s} for r in records]}))
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
