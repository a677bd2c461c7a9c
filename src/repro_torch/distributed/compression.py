"""Gradient compression — port of `repro.distributed.compression`.

Block-wise int8 quantization with a shared absmax scale per tensor:
  q = round(g / s * 127),  s = absmax(g)
The JAX package applies it to the gradients before the optimizer, where
XLA's data-parallel all-reduce would then move int8 (+ one float32 scale)
over the slowest links. The port's data-parallel mesh step (`train/
step.py`) sums the replicas' whole gradients on one device and compresses
the sum, as the JAX step compresses its global gradients, so here it is
the gradient transform alone: the tree enters the optimizer
int8-roundtripped, bit for bit as the JAX package's (round half to even,
float32 arithmetic). Error: at most half a
quantization step, absmax/254, per element.
"""

from __future__ import annotations

import torch

from repro_torch.params import tree_map


def int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize one tensor (absmax/127 scale); int32 leaves and
    scalars pass unchanged."""
    if g.dtype == torch.int32 or g.dim() == 0:
        return g
    g32 = g.float()
    s = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / s), -127, 127).to(torch.int8)
    return (q.float() * s).to(g.dtype)


def int8_compress_tree(grads):
    return tree_map(int8_roundtrip, grads)


def compression_error_bound(g: torch.Tensor) -> float:
    """Max elementwise error bound: absmax/254 (half a quant step)."""
    return float(g.abs().max() / 254.0)
