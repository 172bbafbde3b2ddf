"""Plain PyTorch versions of the RWKV6 WKV recurrence.

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

``wkv_ref`` is the twin of the reference's ``kernels/wkv/ref.py::wkv_ref``
(one head panel). ``wkv_batched_ref`` is the same recurrence in the model's
layout, the reference model's per-step scan body (``RWKV6._wkv``) as a
Python loop over time; the CPU path of ``ops`` runs it, and the CUDA kernel
in ``csrc/wkv.cu`` is held to it.
"""
from __future__ import annotations

from typing import Tuple

import torch


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (T, D); u: (D,); state: (D, D) -> (o (T, D) f32,
    S_T (D, D) f32). The state given is not changed."""
    S = state.float()
    u = u.float()
    outs = []
    for rt, kt, vt, wt in zip(r.float(), k.float(), v.float(), w.float()):
        kv = torch.outer(kt, vt)
        outs.append(rt @ (S + u[:, None] * kv))
        S = wt[:, None] * S + kv
    o = torch.stack(outs) if outs else r.new_empty((0, r.shape[-1]),
                                                   dtype=torch.float32)
    return o, S


def wkv_batched_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (B, T, H, D); u: (H, D), or (B, H, D) for one u per
    panel; state: (B, H, D, D) -> (o (B, T, H, D) in r's dtype, S_T
    (B, H, D, D) f32). Sums in f32; the state given is not changed."""
    S = state.float()
    uf = u.float()[..., None]                            # (.., H, D, 1)
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]   # (B, H, D, D)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    o = torch.stack(outs, dim=1) if outs else r.new_empty(r.shape)
    return o.to(r.dtype), S
