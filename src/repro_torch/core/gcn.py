"""Graph Convolutional Network core for batches of small padded graphs —
port of `repro.core.gcn`.

One GCN layer computes H^{l+1} = ReLU( A' · (H^l · W^l) + b^l ) in the
A'(HW) order of the paper (SPA-GCN §3.2). Everything is batched: adjacency
[B, N, N], features [B, N, F], node mask [B, N].

`normalized_adjacency` writes the inverse square root as `torch.rsqrt`,
which is correctly rounded on the CPU; XLA's CPU `lax.rsqrt` is not (it
differs by 1 ulp at 58 of the integer degrees 1..256, the first being 6, 7,
17 and 18), so A' entries agree with the JAX package within 2 ulp (one per
factor), not bit for bit.
"""

from __future__ import annotations

import torch


def normalized_adjacency(adj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """A' = D^-1/2 (A + I) D^-1/2 restricted to valid (masked) nodes.

    adj [B, N, N] 0/1 adjacency padded with zeros, mask [B, N]. Padding
    rows/cols of the result are exactly zero."""
    m = mask[..., :, None] * mask[..., None, :]
    eye = torch.eye(adj.shape[-1], dtype=adj.dtype, device=adj.device)
    a_tilde = (adj + eye) * m                  # self loops on real nodes only
    deg = a_tilde.sum(-1)
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)),
                           torch.zeros_like(deg))
    return a_tilde * inv_sqrt[..., :, None] * inv_sqrt[..., None, :]


def init_gcn_params(generator: torch.Generator, feature_dims, *,
                    dtype=torch.float32, device="cpu"):
    """Glorot-init a stack of GCN layers: dims (f0, f1, ..., fL)."""
    layers = []
    for fan_in, fan_out in zip(feature_dims[:-1], feature_dims[1:]):
        scale = (2.0 / (fan_in + fan_out)) ** 0.5
        w = torch.randn((fan_in, fan_out), generator=generator,
                        dtype=torch.float32) * scale
        layers.append({"w": w.to(device=device, dtype=dtype),
                       "b": torch.zeros(fan_out, dtype=dtype, device=device)})
    return layers


def gcn_layer(params, adj_norm, h, mask, *, activation: bool = True):
    """One GCN layer: adj_norm [B, N, N], h [B, N, Fin] -> [B, N, Fout]."""
    hw = torch.matmul(h, params["w"]) + params["b"]
    out = torch.matmul(adj_norm, hw)
    if activation:
        out = torch.relu(out)
    return out * mask[..., None]


def gcn_stack(layers, adj_norm, h, mask):
    """Full GCN with ReLU after every layer (as SimGNN does before
    attention pooling)."""
    for p in layers:
        h = gcn_layer(p, adj_norm, h, mask, activation=True)
    return h


def gcn_stack_from_labels(layers, adj_norm, labels, mask):
    """GCN stack whose input is int node labels [B, N] instead of one-hot
    features: the first H·W is the row gather W1[labels] (exactly equal to
    the one-hot product; its backward is `kernels.common.label_gather`'s
    one-hot contraction, deterministic on the card)."""
    from repro_torch.kernels.common import label_gather

    hw = label_gather(layers[0]["w"], labels) + layers[0]["b"]
    h = torch.relu(torch.matmul(adj_norm, hw)) * mask[..., None]
    for p in layers[1:]:
        h = gcn_layer(p, adj_norm, h, mask, activation=True)
    return h
