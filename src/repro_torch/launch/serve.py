"""Serving entry point of the port: batched prefill, then greedy
autoregressive decode, on a model the port builds (``smollm-135m``, the
default, ``rwkv6-7b`` or ``paper-charlm``). On the card, smollm-135m's
prefill attention runs through K3 and every decode step's attention
through K4; rwkv6-7b's WKV recurrence runs through K5 for the prompt and
for every decode step.

  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
      --batch 8 --prompt-len 1024 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --no-reduced --batch 8 --prompt-len 1024 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --batch 4 --prompt-len 12 --gen 8

Weights are random, drawn from ``--seed``, and so are the prompt tokens.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs import reduced as shrink
from repro_torch.configs.base import CHARLM, ModelConfig
from repro_torch.models import get_model


def serve_config(arch: str, reduced: bool) -> ModelConfig:
    """The reference's ``serve_model_ref`` recipe: the full config, or a
    2-layer reduced one (a charlm also gets lstm_hidden 256 and 16 words)."""
    cfg = get_config(arch)
    if not reduced:
        return cfg
    small = shrink(cfg, layers=2)
    if cfg.family == CHARLM:
        small = dataclasses.replace(small, lstm_hidden=256, max_context=16)
    return small


@dataclasses.dataclass
class ServeResult:
    config: ModelConfig
    tokens: torch.Tensor       # (B, gen) greedy tokens, int64 on the CPU
    logits: torch.Tensor       # (B, V) logits of the last decode step
    prefill_s: float
    decode_s: float

    @property
    def tokens_per_s(self) -> float:
        return self.tokens.numel() / self.decode_s


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(arch: str = "smollm-135m", *, reduced: bool = True, batch: int = 4,
        prompt_len: int = 12, gen: int = 8,
        device: torch.device | str = "cuda", seed: int = 0) -> ServeResult:
    """Prefill a batch of `batch` random prompts of `prompt_len` tokens,
    then decode `gen` tokens greedily. Walls are host clock around work
    that ends in a device synchronise."""
    dev = resolve_device(device)
    cfg = serve_config(arch, reduced)
    model = get_model(cfg)
    gen_ = torch.Generator().manual_seed(seed)
    params, _ = model.init(gen_, device=dev)
    B, S = batch, prompt_len
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen_).to(dev)
    chars = None
    if cfg.family == CHARLM:
        chars = torch.randint(0, cfg.char_vocab, (B, S, cfg.max_word_len),
                              generator=gen_).to(dev)

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        if chars is not None:
            lg, cache = model.prefill(params, toks, chars=chars)
        else:
            lg, cache = model.prefill(params, toks, pad_to=S + gen)
        _sync(dev)
        prefill_s = time.perf_counter() - t0

        out = []
        t0 = time.perf_counter()
        for _ in range(gen):
            nxt = torch.argmax(lg, dim=-1)
            out.append(nxt)
            # a charlm decodes word by word from the last word's chars
            step_in = chars[:, -1] if chars is not None else nxt
            lg, cache = model.decode_step(params, cache, step_in)
        _sync(dev)
        decode_s = time.perf_counter() - t0
    tokens = torch.stack(out, dim=1).cpu() if out else \
        torch.empty((B, 0), dtype=torch.int64)
    return ServeResult(cfg, tokens, lg, prefill_s, decode_s)


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="2-layer reduced config (default); --no-reduced "
                        "serves the full width")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=12)
    p.add_argument("--gen", type=int, default=8)
    p.add_argument("--greedy", action="store_true",
                   help="kept for the reference's CLI; decoding is always "
                        "greedy")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    res = run(args.arch, reduced=args.reduced, batch=args.batch,
              prompt_len=args.prompt_len, gen=args.gen, device=args.device,
              seed=args.seed)
    B, V = res.logits.shape
    print(f"[serve] {res.config.name} ({res.config.param_count():,} params) "
          f"on {args.device}: prefill B={B} S={args.prompt_len}: "
          f"{res.prefill_s:.4f}s logits ({B}, {V})")
    print(f"[serve] decoded {args.gen} tokens/seq in {res.decode_s:.4f}s "
          f"({res.tokens_per_s:.1f} tok/s); sample: "
          f"{res.tokens[0, :8].tolist()}")
    if not torch.isfinite(res.logits).all():
        raise RuntimeError("non-finite logits")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
