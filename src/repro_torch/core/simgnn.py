"""SimGNN (Bai et al., WSDM'19) — port of `repro.core.simgnn`.

Pipeline (paper §4.1): GCN x3 -> node embeddings; Att pooling -> graph
embedding h_G = sum_n sigmoid(h_n^T c) h_n with c = tanh(W_att mean_n h_n);
NTN -> K scores ReLU(h1^T W[k] h2 + V [h1; h2] + b); FCN -> one score in
(0, 1). Everything is batched over pairs, the two sides stacked into one
batch of 2B graphs.

Parameters are the JAX tree layout as tensors (`repro_torch.params`).
Leaves of any floating dtype are computed in float32 (bf16 params are
upcast on entry, as the JAX package's kernels upcast them in the kernel).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.gcn import (gcn_stack, gcn_stack_from_labels,
                                  init_gcn_params, normalized_adjacency)
from repro_torch.params import params_to


class SimGNNConfig(NamedTuple):
    """Defaults follow the released SimGNN reference used as the paper's
    CPU/GPU baseline: GCN filters 128/64/32, NTN K=16, FCN 16->8->4->1."""
    n_node_labels: int = 29           # AIDS one-hot node types
    gcn_dims: tuple = (128, 64, 32)
    ntn_k: int = 16
    fcn_dims: tuple = (8, 4)          # hidden dims; final scalar layer appended
    max_nodes: int = 64
    dtype: str = "float32"

    @property
    def feature_dims(self):
        return (self.n_node_labels,) + tuple(self.gcn_dims)


def init_simgnn_params(generator: torch.Generator, cfg: SimGNNConfig, *,
                       device="cpu"):
    """Random SimGNN params in the JAX tree layout, drawn from `generator`
    with the JAX package's scales (not its numbers: `jax.random` and
    `torch.Generator` differ)."""
    dtype = getattr(torch, cfg.dtype)
    f = cfg.gcn_dims[-1]

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    params = {
        "gcn": init_gcn_params(generator, cfg.feature_dims),
        "att": {"w": normal(f, f) / f ** 0.5},
        "ntn": {"w": normal(cfg.ntn_k, f, f) / f,
                "v": normal(cfg.ntn_k, 2 * f) / (2.0 * f) ** 0.5,
                "b": torch.zeros(cfg.ntn_k)},
        "fcn": [],
    }
    dims = (cfg.ntn_k,) + tuple(cfg.fcn_dims) + (1,)
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        scale = (2.0 / (fan_in + fan_out)) ** 0.5
        params["fcn"].append({"w": normal(fan_in, fan_out) * scale,
                              "b": torch.zeros(fan_out)})
    return params_to(params, device, dtype)


def attention_pooling(att_params, h, mask):
    """Global context-aware attention (paper Eq. 3): h [B, N, F] -> [B, F]."""
    n_valid = mask.sum(-1, keepdim=True).clamp_min(1.0)
    mean_h = (h * mask[..., None]).sum(-2) / n_valid
    c = torch.tanh(mean_h @ att_params["w"])
    a = torch.sigmoid(torch.einsum("bnf,bf->bn", h, c)) * mask
    return torch.einsum("bn,bnf->bf", a, h)


def ntn_scores(ntn_params, hg1, hg2):
    """Neural Tensor Network (paper Eq. 4): hg* [B, F] -> [B, K]."""
    bilinear = torch.einsum("bf,kfg,bg->bk", hg1, ntn_params["w"], hg2)
    linear = torch.cat([hg1, hg2], -1) @ ntn_params["v"].T
    return torch.relu(bilinear + linear + ntn_params["b"])


def fcn_head(fcn_params, s):
    """FCN reducing [B, K] -> [B] similarity in (0, 1)."""
    for i, p in enumerate(fcn_params):
        s = s @ p["w"] + p["b"]
        if i + 1 < len(fcn_params):
            s = torch.relu(s)
    return torch.sigmoid(s[..., 0])


def graph_embedding(params, adj, feats, mask):
    """Stages 1-2 from raw adjacency and one-hot feats: [B, F_last]."""
    a_norm = normalized_adjacency(adj, mask)
    h = gcn_stack(params["gcn"], a_norm, feats, mask)
    return attention_pooling(params["att"], h, mask)


def pair_score(params, adj1, feats1, mask1, adj2, feats2, mask2):
    """Full SimGNN pipeline for a batch of graph pairs -> [B] scores; the
    two sides run as one stacked batch of 2B graphs."""
    params = params_to(params, dtype=torch.float32)
    hg = graph_embedding(params, torch.cat([adj1, adj2]),
                         torch.cat([feats1, feats2]), torch.cat([mask1, mask2]))
    hg1, hg2 = hg.chunk(2)
    return fcn_head(params["fcn"], ntn_scores(params["ntn"], hg1, hg2))


def pair_score_from_labels(params, adj1, labels1, mask1,
                           adj2, labels2, mask2):
    """`pair_score` taking int node labels instead of one-hot feats — the
    plain reference for the packed kernels' first-layer W1 row gather."""
    params = params_to(params, dtype=torch.float32)
    mask = torch.cat([mask1, mask2])
    a_norm = normalized_adjacency(torch.cat([adj1, adj2]), mask)
    h = gcn_stack_from_labels(params["gcn"], a_norm,
                              torch.cat([labels1, labels2]), mask)
    hg1, hg2 = attention_pooling(params["att"], h, mask).chunk(2)
    return fcn_head(params["fcn"], ntn_scores(params["ntn"], hg1, hg2))


def simgnn_loss(params, batch):
    """MSE against exp(-normalised GED) targets (SimGNN's training
    objective). batch: a dict with adj1, feats1, mask1, adj2, feats2,
    mask2 and target [B] (a tensor or numpy)."""
    pred = pair_score(params, batch["adj1"], batch["feats1"], batch["mask1"],
                      batch["adj2"], batch["feats2"], batch["mask2"])
    target = torch.as_tensor(batch["target"], dtype=pred.dtype,
                             device=pred.device)
    return ((pred - target) ** 2).mean()
