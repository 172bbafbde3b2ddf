"""RWKV-6 "Finch" (arXiv:2404.05892) in PyTorch: an attention-free RNN
with data-dependent decay and token shift, with the reference's flat param
keys, shapes and logical axes (per-layer params stacked on a leading
layers axis).

Time-mix: r, k, v, g, w projections with a data-dependent token shift
(low-rank "ddlerp"), a per-channel data-dependent decay
w_t = exp(-exp(w0 + lora_w(x))), a bonus u and a per-head WKV state S in
R^{hd x hd}:
    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T);   S_t = diag(w_t) S_{t-1} + k_t v_t^T
Channel-mix: a squared-ReLU MLP with token shift.

The WKV recurrence runs through K5 (``kernels/wkv``) on the card, for the
prompt and for each decode step; the layer stack is a Python loop over the
stacked params. The decode state is O(1) per layer.

Not ported yet: the training loss (it needs a gradient through WKV).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv import ops as _wkv_ops
from repro_torch.models import common as cm

_DDLERP_RANK = 32
_DECAY_RANK = 64

States = Dict[str, object]   # {"wkv", "tm_tok", "cm_tok": tensors, "pos": int}


class RWKV6:
    def __init__(self, cfg: ModelConfig, **_):
        self.cfg = cfg
        assert cfg.d_model % cfg.resolved_head_dim == 0
        self.n_heads = cfg.d_model // cfg.resolved_head_dim

    # ---------------------------------------------------------------- init
    def init(self, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32,
             device: torch.device | str = "cpu") -> Tuple[cm.Params, cm.Axes]:
        cfg, H, hd = self.cfg, self.n_heads, self.cfg.resolved_head_dim
        d, L, f = cfg.d_model, cfg.num_layers, cfg.d_ff
        b = cm.ParamBuilder(generator, dtype, device)
        b.param("embed", (cfg.vocab_size, d), ("vocab", "embed"),
                scale=1.0 / math.sqrt(d))
        b.param("unembed", (d, cfg.vocab_size), ("embed", "vocab"))
        b.param("final_norm", (d,), ("embed",), init="ones")
        le = ("layers", "embed")
        b.param("blocks/tm_norm", (L, d), le, init="ones")
        b.param("blocks/cm_norm", (L, d), le, init="ones")
        # ddlerp token-shift mixers: base mu for x and per-target (r,k,v,w,g)
        b.param("blocks/mu_x", (L, d), le, init="zeros")
        b.param("blocks/mu_rkvwg", (L, 5, d), ("layers", None, "embed"),
                init="zeros")
        b.param("blocks/ddlerp_a", (L, d, 5 * _DDLERP_RANK),
                ("layers", "embed", None))
        b.param("blocks/ddlerp_b", (L, 5, _DDLERP_RANK, d),
                ("layers", None, None, "embed"))
        # time-mix projections
        for nm in ("wr", "wk", "wv", "wg"):
            b.param(f"blocks/{nm}", (L, d, H, hd),
                    ("layers", "embed", "heads", "head_dim"))
        b.param("blocks/wo", (L, H, hd, d),
                ("layers", "heads", "head_dim", "embed"),
                scale=1.0 / math.sqrt(d))
        # data-dependent decay (low-rank) + bonus
        b.param("blocks/w0", (L, H, hd), ("layers", "heads", "head_dim"),
                init="zeros")
        b.param("blocks/decay_a", (L, d, _DECAY_RANK), ("layers", "embed", None))
        b.param("blocks/decay_b", (L, _DECAY_RANK, H, hd),
                ("layers", None, "heads", "head_dim"))
        b.param("blocks/u", (L, H, hd), ("layers", "heads", "head_dim"),
                init="zeros")
        b.param("blocks/ln_out", (L, H, hd), ("layers", "heads", "head_dim"),
                init="ones")
        # channel-mix
        b.param("blocks/cm_mu_k", (L, d), le, init="zeros")
        b.param("blocks/cm_mu_r", (L, d), le, init="zeros")
        b.param("blocks/cm_wk", (L, d, f), ("layers", "embed", "ffn"))
        b.param("blocks/cm_wv", (L, f, d), ("layers", "ffn", "embed"))
        b.param("blocks/cm_wr", (L, d, d), ("layers", "embed", "embed_out"))
        return b.build()

    # ------------------------------------------------------------- pieces
    def _ddlerp(self, lp: Dict[str, torch.Tensor], x: torch.Tensor,
                x_prev: torch.Tensor) -> torch.Tensor:
        """Data-dependent token shift. x, x_prev: (B, S, d) -> five mixed
        streams (B, S, 5, d) for (r, k, v, w, g)."""
        dx = x_prev - x
        xx = x + dx * lp["mu_x"]
        low = torch.tanh(xx @ lp["ddlerp_a"])
        low = low.reshape(*low.shape[:-1], 5, _DDLERP_RANK)
        off = torch.einsum("bsfr,frd->bsfd", low, lp["ddlerp_b"])
        mix = lp["mu_rkvwg"] + off                       # (B, S, 5, d)
        return x[..., None, :] + dx[..., None, :] * mix

    def _decay(self, lp: Dict[str, torch.Tensor], xw: torch.Tensor
               ) -> torch.Tensor:
        """xw: (B, S, d) -> per-token decay w in (0, 1): (B, S, H, hd) f32."""
        low = torch.tanh(xw @ lp["decay_a"])
        wlog = lp["w0"] + cm.project_heads(low, lp["decay_b"])
        return torch.exp(-torch.exp(wlog.float()))

    def _wkv(self, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """r, k, v, w: (B, S, H, hd); u: (H, hd); state: (B, H, hd, hd) f32.
        Returns (out (B, S, H, hd) f32, state): the recurrence in f32, as
        the reference's scan takes it, through K5 on the card. The state
        given is UPDATED IN PLACE to the last step's."""
        return _wkv_ops.wkv(r.float(), k.float(), v.float(), w.float(),
                            u.float(), state)

    def _time_mix(self, lp: Dict[str, torch.Tensor], x: torch.Tensor,
                  x_prev_tok: torch.Tensor, state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, S, d). x_prev_tok: (B, d), the last token of the previous
        chunk. Returns (out, last token, state), the state updated in
        place."""
        xs = torch.cat([x_prev_tok[:, None, :], x[:, :-1, :]], dim=1)
        mixed = self._ddlerp(lp, x, xs)                 # (B, S, 5, d)
        xr, xk, xv, xw, xg = mixed.unbind(2)
        r = cm.project_heads(xr, lp["wr"])
        k = cm.project_heads(xk, lp["wk"])
        v = cm.project_heads(xv, lp["wv"])
        g = cm.swish(cm.project_heads(xg, lp["wg"]))
        w = self._decay(lp, xw)
        out, state = self._wkv(r, k, v, w, lp["u"], state)
        # per-head group norm (population variance, as jnp.var)
        mu = out.mean(dim=-1, keepdim=True)
        var = out.var(dim=-1, keepdim=True, correction=0)
        out = (out - mu) * torch.rsqrt(var + 1e-5) * lp["ln_out"]
        out = out.to(x.dtype) * g
        return cm.merge_heads(out, lp["wo"]), x[:, -1, :], state

    def _channel_mix(self, lp: Dict[str, torch.Tensor], x: torch.Tensor,
                     x_prev_tok: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        xs = torch.cat([x_prev_tok[:, None, :], x[:, :-1, :]], dim=1)
        dx = xs - x
        xk = x + dx * lp["cm_mu_k"]
        xr = x + dx * lp["cm_mu_r"]
        k = torch.square(torch.relu(xk @ lp["cm_wk"]))
        kv = k @ lp["cm_wv"]
        r = torch.sigmoid(xr @ lp["cm_wr"])
        return r * kv, x[:, -1, :]

    # ------------------------------------------------------------- forward
    def _stack(self, params: cm.Params, x: torch.Tensor, states: States
               ) -> Tuple[torch.Tensor, States]:
        """states: dict of stacked (L, ...) carries ``wkv``, ``tm_tok`` and
        ``cm_tok``, UPDATED IN PLACE layer by layer (where the reference's
        scan returns new ones); returns (x, states)."""
        for l, lp in enumerate(cm.layer_params(params)):
            h, tm_tok, _ = self._time_mix(
                lp, cm.rms_norm(x, lp["tm_norm"]), states["tm_tok"][l],
                states["wkv"][l])
            x = x + h
            h, cm_tok = self._channel_mix(
                lp, cm.rms_norm(x, lp["cm_norm"]), states["cm_tok"][l])
            x = x + h
            states["tm_tok"][l] = tm_tok
            states["cm_tok"][l] = cm_tok
        return x, states

    def _zero_states(self, B: int, dtype: torch.dtype,
                     device: torch.device | str = "cpu"):
        cfg, H, hd = self.cfg, self.n_heads, self.cfg.resolved_head_dim
        L, d = cfg.num_layers, cfg.d_model
        states = {
            "wkv": torch.zeros((L, B, H, hd, hd), dtype=torch.float32,
                               device=device),
            "tm_tok": torch.zeros((L, B, d), dtype=dtype, device=device),
            "cm_tok": torch.zeros((L, B, d), dtype=dtype, device=device),
        }
        axes = {
            "wkv": ("layers", "batch", "heads", "head_dim", "head_dim2"),
            "tm_tok": ("layers", "batch", "embed"),
            "cm_tok": ("layers", "batch", "embed"),
        }
        return states, axes

    def logits(self, params: cm.Params, x: torch.Tensor) -> torch.Tensor:
        return cm.rms_norm(x, params["final_norm"]) @ params["unembed"]

    def loss(self, params: cm.Params, batch):
        raise NotImplementedError("RWKV6.loss (training, with a gradient "
                                  "through WKV) is not ported yet")

    # ----------------------------------------------------------- serve api
    def init_cache(self, B: int, cache_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | str = "cpu"):
        """Zero recurrent states (``cache_len`` is unused: the state is
        O(1)) and their logical axes."""
        states, axes = self._zero_states(B, dtype, device)
        states["pos"] = 0
        axes["pos"] = ()
        return states, axes

    def prefill(self, params: cm.Params, tokens: torch.Tensor,
                pad_to: int = 0) -> Tuple[torch.Tensor, States]:
        """Run the prompt (B, S) from zero states; return (last-position
        logits (B, V), states). ``pad_to`` is taken and ignored, as in the
        reference: the state has no slots. ``pos`` is a Python int."""
        x = params["embed"][tokens.long()]
        states, _ = self._zero_states(tokens.shape[0], x.dtype, x.device)
        x, states = self._stack(params, x, states)
        states["pos"] = tokens.shape[1]
        return self.logits(params, x[:, -1:, :])[:, 0], states

    def decode_step(self, params: cm.Params, cache: States,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, States]:
        """tokens: (B,) int. One autoregressive step.

        MUTATES the cache it is given: each layer's WKV state and token-shift
        carries are written in place (the WKV state by K5 itself on the
        card), and ``cache["pos"]`` is advanced. Returns (logits (B, V), the
        same cache)."""
        x = params["embed"][tokens.long()][:, None, :]
        pos = int(cache["pos"])
        x, _ = self._stack(params, x, cache)
        cache["pos"] = pos + 1
        return self.logits(params, x)[:, 0], cache
