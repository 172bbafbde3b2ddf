"""Where the time of serving a model at full width goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch rwkv6-7b

Runs the serving configuration of ``chip_smoke.py``'s main paths (f32, 8
prompts of 1024 tokens, 64 greedy tokens; smollm-135m by default, with a
cache of 1088 slots, or rwkv6-7b): one warm-up prefill and decode, then a
prefill and the 64 decode steps timed with the device synchronised at their
ends, then one prefill and 16 decode steps under ``torch.profiler``, whose
device events give the kernel time by kind, the device's busy share and the
device events per decode step. Prints one JSON object as its last line.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.profile_round import kernel_kind
from repro_torch.models import get_model

BATCH, PROMPT_LEN, GEN, PROFILED_STEPS = 8, 1024, 64, 16


def _serve_kind(name: str) -> str:
    if "wkv_fwd" in name:
        return "WKV (K5)"
    if "swa_attention" in name:
        return "flash attention (K3)"
    if "decode_partial" in name or "decode_combine" in name:
        return "decode attention (K4)"
    return kernel_kind(name)


def _device_time(prof, wall_s: float) -> dict:
    by_kind, events = defaultdict(float), 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kind[_serve_kind(e.name)] += e.device_time_total / 1e6
            events += 1
    busy = sum(by_kind.values())
    return {"wall_s": wall_s, "device_events": events,
            "device_busy_s": busy if busy > 0 else "not measured",
            "device_idle_share": 1 - busy / wall_s if busy > 0
            else "not measured",
            "device_s_by_kind": dict(by_kind)}


def main(argv: list | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="smollm-135m",
                   help="smollm-135m (default) or rwkv6-7b, at full width")
    arch = p.parse_args(argv).arch
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    model = get_model(cfg)
    g = torch.Generator().manual_seed(0)
    params, _ = model.init(g, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                         generator=g).to(dev)

    def prefill():
        return model.prefill(params, toks, pad_to=PROMPT_LEN + GEN)

    def decode(lg, cache, steps):
        for _ in range(steps):
            lg, cache = model.decode_step(params, cache,
                                          torch.argmax(lg, dim=-1))
        return lg, cache

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        decode(*prefill(), 2)                                   # warm-up
        (lg, cache), prefill_s = timed(prefill)
        _, decode_s = timed(lambda: decode(lg, cache, GEN))
        with torch.profiler.profile(activities=acts) as p_prefill:
            (lg, cache), p_prefill_s = timed(prefill)
        with torch.profiler.profile(activities=acts) as p_decode:
            _, p_decode_s = timed(lambda: decode(lg, cache, PROFILED_STEPS))
    dec = _device_time(p_decode, p_decode_s)
    dec["device_events_per_step"] = dec["device_events"] / PROFILED_STEPS
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev),
        "config": {"arch": arch, "batch": BATCH, "prompt_len": PROMPT_LEN,
                   "gen": GEN, "params": cfg.param_count()},
        "prefill_s": prefill_s, "decode_s": decode_s,
        "decode_ms_per_step": decode_s / GEN * 1e3,
        "tokens_per_s": BATCH * GEN / decode_s,
        "profiled_prefill": _device_time(p_prefill, p_prefill_s),
        "profiled_decode": {"steps": PROFILED_STEPS, **dec}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
