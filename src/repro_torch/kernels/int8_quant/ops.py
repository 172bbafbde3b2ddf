"""Public int8-codec ops. Dispatch follows the tensor's device: a CUDA
tensor launches the hand-written kernel (or raises), a CPU tensor takes the
plain PyTorch version in ``ref``. There is no other fallback."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels._build import on_cuda
from repro_torch.kernels.int8_quant import kernel as K
from repro_torch.kernels.int8_quant import ref as R


def _on_cuda(t: torch.Tensor) -> bool:
    return on_cuda(t, "int8 codec")


def quantize(x: torch.Tensor, block: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_cuda(x):
        return K.quantize(x, block)
    return R.quantize_ref(x, block)


def quantize_many(leaves: Sequence[torch.Tensor], block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Every leaf quantized in its own blocks, laid out one after another:
    (q (total_nb, block), scales (total_nb,), [(q_i, s_i)] per leaf). On
    the card, one K1 launch for up to ``K.MAX_LEAVES`` leaves."""
    if not leaves:
        raise ValueError("quantize_many needs at least one leaf")
    if _on_cuda(leaves[0]):
        return K.quantize_many(leaves, block)
    return R.quantize_many_ref(leaves, block)


def dequantize(q: torch.Tensor, s: torch.Tensor, shape,
               block: int = 256) -> torch.Tensor:
    if _on_cuda(q):
        n = 1
        for d in shape:
            n *= d
        return K.dequant_accumulate(None, q, s, 1.0, n, block).reshape(shape)
    return R.dequantize_ref(q, s, shape, block)


def quant_dequant(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    q, s = quantize(x, block)
    return dequantize(q, s, x.shape, block).to(x.dtype)


def dequant_accumulate(acc: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                       weight: float, block: int = 256) -> torch.Tensor:
    if _on_cuda(acc):
        out = K.dequant_accumulate(acc.float().reshape(-1), q, s, weight,
                                   acc.numel(), block)
        return out.reshape(acc.shape).to(acc.dtype)
    return R.dequant_accumulate_ref(acc, q, s, weight, block)


def wire_bytes(x_size: int, block: int = 256) -> int:
    """Bytes on the wire for an int8-compressed tensor of x_size elements."""
    nb = -(-x_size // block)
    return x_size + 4 * nb  # int8 payload + f32 scale per block
