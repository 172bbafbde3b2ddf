"""Plain PyTorch versions of the blockwise symmetric int8 codec.

The paper's compression lever (§6, Prasad et al. 2022): client update
tensors are flattened, padded to a multiple of `block`, and quantized per
block with a symmetric scale max|x|/127. These functions define the exact
semantics the CUDA kernels in ``csrc/int8_quant.cu`` are held to; the CPU
path of ``ops`` runs them.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def _blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)


def quantize_ref(x: torch.Tensor, block: int = 256
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (q int8 (nb, block), scales f32 (nb,))."""
    xb = _blocked(x.float(), block)
    amax = torch.amax(torch.abs(xb), dim=1)
    # a tensor divisor: PyTorch's CUDA path turns division by a Python
    # scalar into a product with its reciprocal, which is not IEEE division
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_many_ref(leaves: Sequence[torch.Tensor], block: int = 256
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 List[Tuple[torch.Tensor, torch.Tensor]]]:
    """``quantize_ref`` of each leaf, concatenated: (q int8 (total_nb,
    block), scales f32 (total_nb,), [(q_i, s_i)] views of them per
    leaf)."""
    if not leaves:
        raise ValueError("quantize_many needs at least one leaf")
    parts = [quantize_ref(x, block) for x in leaves]
    q = torch.cat([p[0] for p in parts])
    s = torch.cat([p[1] for p in parts])
    views, a = [], 0
    for pq, _ in parts:
        views.append((q[a:a + pq.shape[0]], s[a:a + pq.shape[0]]))
        a += pq.shape[0]
    return q, s, views


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor, shape,
                   block: int = 256) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def quant_dequant_ref(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    q, s = quantize_ref(x, block)
    return dequantize_ref(q, s, x.shape, block).to(x.dtype)


def dequant_accumulate_ref(acc: torch.Tensor, q: torch.Tensor,
                           scale: torch.Tensor, weight: float,
                           block: int = 256) -> torch.Tensor:
    """acc + weight * dequant(q): the FedBuff buffer update, fused."""
    upd = dequantize_ref(q, scale, acc.shape, block)
    return acc + torch.tensor(weight, dtype=acc.dtype) * upd.to(acc.dtype)
