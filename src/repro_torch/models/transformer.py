"""Decoder-only transformer of the dense family (smollm-135m, ...), in
PyTorch: pre-norm RMSNorm blocks, RoPE GQA attention (full or
sliding-window) and a SwiGLU FFN, with the reference's flat param keys and
shapes (per-layer params stacked on a leading layers axis). Prefill and
training attention run through K3 (the training loss's gradient through its
backward kernels) and decode attention through K4 (``models/common.py``);
the layer stack is a Python loop over the stacked params.

Not ported yet: the MoE block (and with it the loss's router aux term), the
VLM frontend, the int8 KV cache (``kv_quant``) and the ``flash_decode``
mesh branch (which on one device reduces to the plain decode path).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import DENSE, ModelConfig
from repro_torch.models import common as cm

Cache = Dict[str, object]   # {"k": tensor, "v": tensor, "pos": int}


class DecoderLM:
    def __init__(self, cfg: ModelConfig, *, decode_window: int = 0):
        """decode_window > 0 makes the decode cache a ring buffer of that
        many slots (the reference's sliding-window decode variant)."""
        if cfg.family != DENSE or cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}): only the dense family of the "
                "transformer is ported yet (no MoE block, no VLM frontend)")
        self.cfg = cfg
        self.decode_window = decode_window or cfg.sliding_window
        # reference serving options the port does not have yet
        self.flash_decode = False
        self.kv_quant = False

    # ---------------------------------------------------------------- init
    def init(self, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32,
             device: torch.device | str = "cpu") -> Tuple[cm.Params, cm.Axes]:
        cfg = self.cfg
        b = cm.ParamBuilder(generator, dtype, device)
        d, hd = cfg.d_model, cfg.resolved_head_dim
        H, Hkv, L, f = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers, cfg.d_ff
        b.param("embed", (cfg.vocab_size, d), ("vocab", "embed"),
                scale=1.0 / math.sqrt(d))
        if not cfg.tie_embeddings:
            b.param("unembed", (d, cfg.vocab_size), ("embed", "vocab"))
        b.param("final_norm", (d,), ("embed",), init="ones")
        b.param("blocks/attn_norm", (L, d), ("layers", "embed"), init="ones")
        b.param("blocks/wq", (L, d, H, hd), ("layers", "embed", "heads", "head_dim"))
        b.param("blocks/wk", (L, d, Hkv, hd), ("layers", "embed", "kv_heads", "head_dim"))
        b.param("blocks/wv", (L, d, Hkv, hd), ("layers", "embed", "kv_heads", "head_dim"))
        b.param("blocks/wo", (L, H, hd, d), ("layers", "heads", "head_dim", "embed"),
                scale=1.0 / math.sqrt(H * hd))
        b.param("blocks/ffn_norm", (L, d), ("layers", "embed"), init="ones")
        b.param("blocks/w_gate", (L, d, f), ("layers", "embed", "ffn"))
        b.param("blocks/w_up", (L, d, f), ("layers", "embed", "ffn"))
        b.param("blocks/w_down", (L, f, d), ("layers", "ffn", "embed"))
        return b.build()

    # ------------------------------------------------------------- forward
    def _layer(self, lp: Dict[str, torch.Tensor], x: torch.Tensor,
               positions_offset: int = 0
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """One block on (B, S, d). Returns (x_out, (k, v)) (k/v for the
        cache)."""
        cfg = self.cfg
        h = cm.rms_norm(x, lp["attn_norm"])
        q, k, v = (cm.project_heads(h, lp[w]) for w in ("wq", "wk", "wv"))
        pos = positions_offset + torch.arange(x.shape[1], device=x.device)
        cos, sin = cm.rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta)
        q = cm.apply_rope(q, cos, sin)
        k = cm.apply_rope(k, cos, sin)
        attn = cm.flash_attention(q, k, v, causal=True,
                                  window=cfg.sliding_window)
        x = x + cm.merge_heads(attn, lp["wo"])
        h = cm.rms_norm(x, lp["ffn_norm"])
        x = x + cm.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
        return x, (k, v)

    def _stack(self, params: cm.Params, x: torch.Tensor,
               positions_offset: int = 0,
               kv_sink: Optional[Callable[[int, torch.Tensor, torch.Tensor],
                                          None]] = None) -> torch.Tensor:
        """Run the layer stack. Where the reference's scan returns every
        layer's (k, v) stacked, here ``kv_sink(layer, k, v)`` receives them
        (prefill writes them straight into the cache)."""
        for l, lp in enumerate(cm.layer_params(params)):
            x, (k, v) = self._layer(lp, x, positions_offset)
            if kv_sink is not None:
                kv_sink(l, k, v)
        return x

    def _embed(self, params: cm.Params, tokens: torch.Tensor) -> torch.Tensor:
        # the same rows either way; the lookup is the one whose backward
        # sums a row's gradients in one fixed order on that device (as the
        # CharLM's char lookup, models/charlm.py)
        table, ids = params["embed"], tokens.long()
        return F.embedding(ids, table) if table.device.type == "cpu" \
            else table[ids]

    def logits(self, params: cm.Params, x: torch.Tensor) -> torch.Tensor:
        x = cm.rms_norm(x, params["final_norm"])
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        return x @ w

    # ----------------------------------------------------------- train api
    def loss(self, params: cm.Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` over the optional (B, S-1) ``mask``: the stack
        with no kv sink (the reference's ``collect_kv=False``), the final
        norm and the tied or untied unembedding, through ``lm_loss``. A
        batch whose mask is all zero gives loss 0 and a zero gradient. The
        dense family has no router, so aux is 0 (MoE is ROADMAP queue 1
        item 8; ``get_model`` raises for it)."""
        x = self._stack(params, self._embed(params, batch["tokens"]))
        x = cm.rms_norm(x, params["final_norm"])
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        loss = cm.lm_loss(x, w, batch["labels"], batch.get("mask"))
        return loss, {"xent": loss, "aux": torch.zeros((), device=x.device)}

    # ----------------------------------------------------------- serve api
    def init_cache(self, B: int, cache_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | str = "cpu"):
        """An empty (zeroed) cache of ``cache_len`` slots (at most
        ``decode_window``) and its logical axes."""
        if self.kv_quant:
            raise NotImplementedError("kv_quant (int8 KV cache) is not "
                                      "ported yet")
        cfg = self.cfg
        C = min(cache_len, self.decode_window) if self.decode_window \
            else cache_len
        shape = (cfg.num_layers, B, C, cfg.num_kv_heads, cfg.resolved_head_dim)
        axes = ("layers", "batch", "cache", "kv_heads", "head_dim")
        cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device),
                 "pos": 0}
        return cache, {"k": axes, "v": axes, "pos": ()}

    def prefill(self, params: cm.Params, tokens: torch.Tensor,
                pad_to: int = 0) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt (B, S); return (last-position logits (B, V),
        cache). The cache holds the last ``decode_window`` positions (all S
        without a window), and pad_to > that reserves slots for
        decode_step. ``pos`` is a Python int."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        B, S = tokens.shape
        keep = min(S, self.decode_window) if self.decode_window else S
        shape = (cfg.num_layers, B, max(keep, pad_to), cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        cache = {"k": torch.zeros(shape, dtype=x.dtype, device=x.device),
                 "v": torch.zeros(shape, dtype=x.dtype, device=x.device),
                 "pos": S}

        def sink(l: int, k: torch.Tensor, v: torch.Tensor) -> None:
            cache["k"][l, :, :keep] = k[:, S - keep:]
            cache["v"][l, :, :keep] = v[:, S - keep:]

        x = self._stack(params, x, kv_sink=sink)
        return self.logits(params, x[:, -1:, :])[:, 0], cache

    def decode_step(self, params: cm.Params, cache: Cache,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """tokens: (B,) int. One autoregressive step.

        MUTATES the cache it is given: each layer's new k/v is written into
        ``cache["k"]`` / ``cache["v"]`` in place at ``min(pos, C - 1)``
        (``pos % C`` with a decode window), and ``cache["pos"]`` is advanced.
        Returns (logits (B, V), the same cache)."""
        if self.flash_decode or self.kv_quant:
            raise NotImplementedError("flash_decode and kv_quant are not "
                                      "ported yet")
        cfg = self.cfg
        x = self._embed(params, tokens)[:, None, :]           # (B, 1, d)
        pos = int(cache["pos"])
        C = cache["k"].shape[2]
        write_idx = pos % C if self.decode_window else min(pos, C - 1)
        valid = min(pos + 1, C)
        cos, sin = cm.rope_angles(
            torch.arange(pos, pos + 1, device=x.device)[None],
            cfg.resolved_head_dim, cfg.rope_theta)             # (1, 1, hd/2)
        for l, lp in enumerate(cm.layer_params(params)):
            h = cm.rms_norm(x, lp["attn_norm"])
            q, k, v = (cm.project_heads(h, lp[w]) for w in ("wq", "wk", "wv"))
            q = cm.apply_rope(q, cos, sin)
            k = cm.apply_rope(k, cos, sin)
            kc, vc = cache["k"][l], cache["v"][l]
            kc[:, write_idx] = k[:, 0].to(kc.dtype)
            vc[:, write_idx] = v[:, 0].to(vc.dtype)
            attn = cm.decode_attention(q[:, 0], kc, vc, valid)
            x = x + cm.merge_heads(attn, lp["wo"])[:, None, :]
            h = cm.rms_norm(x, lp["ffn_norm"])
            x = x + cm.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
        cache["pos"] = pos + 1
        return self.logits(params, x)[:, 0], cache
