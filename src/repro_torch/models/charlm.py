"""The paper's FL workload: character-aware CNN-LSTM next-word LM
(Kim et al. 2016; Green Federated Learning §3.2), in plain PyTorch.

    e_i = CNN(chars of word i)          (multi-width char convs + max-pool)
    c_i, h_i = LSTM(h_{i-1}, c_{i-1}, e_i)
    p(w_{i+1} | w_{<=i}) = softmax(W^T h_i)        (MLP decoder + softmax)

Batch layout: tokens are WORDS; ``batch["chars"]`` is (B, S, W) char ids
per word (W = max_word_len). The reference has no custom kernel for the
char-CNN or the LSTM, so both are tensor code here. The char-CNN is written
as the reference writes it, a sum of shifted products (no cuDNN convolution,
so no TF32), and the LSTM cell is written by hand because it carries a +1.0
forget-gate offset that ``torch.nn.LSTM`` lacks.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm

States = Dict[str, torch.Tensor]


class CharLM:
    def __init__(self, cfg: ModelConfig, **_):
        self.cfg = cfg
        self.cnn_out = sum(n for _, n in cfg.cnn_filters)

    # ---------------------------------------------------------------- init
    def init(self, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32,
             device: torch.device | str = "cpu") -> Tuple[cm.Params, cm.Axes]:
        cfg = self.cfg
        b = cm.ParamBuilder(generator, dtype, device)
        b.param("char_embed", (cfg.char_vocab, cfg.char_emb), ("vocab", "embed"),
                scale=0.1)
        for w, n in cfg.cnn_filters:
            b.param(f"cnn/w{w}", (w, cfg.char_emb, n), (None, "embed", "ffn"))
            b.param(f"cnn/b{w}", (n,), ("ffn",), init="zeros")
        b.param("highway/wt", (self.cnn_out, self.cnn_out), ("ffn", "ffn_out"))
        b.param("highway/bt", (self.cnn_out,), ("ffn",), init="zeros")
        b.param("highway/wh", (self.cnn_out, self.cnn_out), ("ffn", "ffn_out"))
        b.param("highway/bh", (self.cnn_out,), ("ffn",), init="zeros")
        b.param("proj_in", (self.cnn_out, cfg.d_model), ("ffn", "embed"))
        L, d, Hd = cfg.num_layers, cfg.d_model, cfg.lstm_hidden
        # LSTM: input->gates and hidden->gates (i, f, g, o)
        b.param("lstm/wx", (L, d, 4 * Hd), ("layers", "embed", "ffn"))
        b.param("lstm/wh", (L, Hd, 4 * Hd), ("layers", "embed", "ffn"))
        b.param("lstm/bias", (L, 4 * Hd), ("layers", "ffn"), init="zeros")
        b.param("mlp/w1", (Hd, cfg.d_ff), ("embed", "ffn"))
        b.param("mlp/b1", (cfg.d_ff,), ("ffn",), init="zeros")
        b.param("unembed", (cfg.d_ff, cfg.vocab_size), ("embed", "vocab"))
        return b.build()

    # ------------------------------------------------------------- word enc
    def word_embed(self, params: cm.Params, chars: torch.Tensor) -> torch.Tensor:
        """chars: (..., W) int -> (..., d_model)."""
        x = params["char_embed"][chars.long()]              # (..., W, ce)
        W = x.shape[-2]
        feats = []
        for w, _ in self.cfg.cnn_filters:
            ker = params[f"cnn/w{w}"]                       # (w, ce, n)
            # valid cross-correlation over the W axis
            conv = sum(x[..., i:W - w + 1 + i, :] @ ker[i] for i in range(w))
            conv = torch.tanh(conv + params[f"cnn/b{w}"])
            # amax splits the gradient evenly over ties, as jnp.max does
            feats.append(torch.amax(conv, dim=-2))
        f = torch.cat(feats, dim=-1)                        # (..., cnn_out)
        t = torch.sigmoid(f @ params["highway/wt"] + params["highway/bt"])
        h = torch.relu(f @ params["highway/wh"] + params["highway/bh"])
        f = t * h + (1.0 - t) * f
        return f @ params["proj_in"]

    # ------------------------------------------------------------- lstm
    @staticmethod
    def _lstm_layer(wx, wh, bias, x, h, c):
        """x: (B, S, d); returns (out (B,S,Hd), h_last, c_last)."""
        xg = x @ wx + bias
        outs = []
        for t in range(x.shape[1]):
            i, f, gg, o = torch.chunk(xg[:, t] + h @ wh, 4, dim=-1)
            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1), h, c

    def _stack(self, params: cm.Params, x: torch.Tensor, states: States):
        """states: dict h/c (L, B, Hd)."""
        hs, cs = [], []
        for l in range(self.cfg.num_layers):
            x, h, c = self._lstm_layer(
                params["lstm/wx"][l], params["lstm/wh"][l],
                params["lstm/bias"][l], x, states["h"][l], states["c"][l])
            hs.append(h)
            cs.append(c)
        return x, {"h": torch.stack(hs), "c": torch.stack(cs)}

    def logits(self, params: cm.Params, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x @ params["mlp/w1"] + params["mlp/b1"])
        return h @ params["unembed"]

    def _zero_states(self, B: int, like: torch.Tensor) -> States:
        L, Hd = self.cfg.num_layers, self.cfg.lstm_hidden
        z = torch.zeros((L, B, Hd), dtype=like.dtype, device=like.device)
        return {"h": z, "c": z}

    # ----------------------------------------------------------- train api
    def loss(self, params: cm.Params, batch: Dict[str, torch.Tensor]):
        chars = batch["chars"]                              # (B, S, W)
        x = self.word_embed(params, chars)
        x, _ = self._stack(params, x, self._zero_states(chars.shape[0], x))
        h = torch.relu(x @ params["mlp/w1"] + params["mlp/b1"])
        loss = cm.lm_loss(h, params["unembed"], batch["labels"],
                          batch.get("mask"))
        return loss, {"xent": loss, "aux": torch.zeros((), device=loss.device),
                      "perplexity": torch.exp(loss)}

    # ----------------------------------------------------------- serve api
    def prefill(self, params: cm.Params, tokens: torch.Tensor, frontend=None,
                chars: Optional[torch.Tensor] = None, pad_to: int = 0):
        chars = chars if chars is not None else tokens
        x = self.word_embed(params, chars)
        x, states = self._stack(params, x, self._zero_states(chars.shape[0], x))
        lg = self.logits(params, x[:, -1])
        states["pos"] = torch.tensor(chars.shape[1], dtype=torch.int32,
                                     device=x.device)
        return lg, states

    def decode_step(self, params: cm.Params, cache: States,
                    chars: torch.Tensor):
        """chars: (B, W) — the chars of the latest word."""
        x = self.word_embed(params, chars)[:, None, :]
        states = {k: v for k, v in cache.items() if k != "pos"}
        x, states = self._stack(params, x, states)
        lg = self.logits(params, x[:, 0])
        states["pos"] = cache["pos"] + 1
        return lg, states
