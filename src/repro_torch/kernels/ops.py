"""Public wrappers around the port's SimGNN kernels — port of the SimGNN
part of `repro.kernels.ops`.

They take a params tree and batches, move both to `device` (None = the
card; raises without CUDA unless `device="cpu"`) and call the kernel
wrappers, which launch CUDA on the card and run their plain versions on
the CPU:

  * `pair_score_sparse` — packed-CSR tiles (`kernels/sparse_pair.py`), the
    engine's choice for sparse (AIDS-like) streams;
  * `pair_score_packed` — packed tiles with dense tile adjacency
    (`kernels/packed_pair.py`);
  * `pair_score_megakernel` — bucket-padded pairs (`kernels/fused_pair.py`);
  * `graph_embeddings_fused` — GCN stack + Att pooling per graph on the
    pre-normalised A' (`kernels/fused_gcn.py`), the embedding cache's and
    the search index's embed stage;
  * `pair_scores_fused` — the NTN+FCN head on embedding pairs
    (`kernels/simgnn_head.py`);
  * `simgnn_pair_score_kernel` — the two-kernel path: both sides through
    one embedding launch, then the head;
  * `blocked_topm`, `blocked_topm_ntn`, `collapse_query_ntn`,
    `retrieval_block_cols` — the retrieval prefilter scans
    (`kernels/retrieval.py`), re-exported;
  * `flash_attention` and `wkv6` — the LM substrate's attention and RWKV
    kernels (`kernels/flash_attn.py`, `kernels/wkv6.py`), re-exported as
    the JAX package's ops module does.

The CUDA kernels run one CTA per pair or tile and take any batch size, so
the JAX wrappers' block policies (`megakernel_block_pairs`,
`packed_tile_block`, `sparse_tile_block`, `quantize_tiles`, `_pad_batch`
with `block_graphs` / `block_pairs`), which size Pallas grid blocks and
XLA compile-cache shapes, have no counterpart here: batches go to the
kernels unpadded and the [T, P] / [B] results equal the JAX wrappers'. The sharded wrappers are not ported yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.fused_gcn import fused_gcn_att
from repro_torch.kernels.fused_pair import fused_pair_score
from repro_torch.kernels.packed_pair import packed_pair_score
from repro_torch.kernels.retrieval import (blocked_topm, blocked_topm_ntn,
                                           collapse_query_ntn,
                                           retrieval_block_cols)
from repro_torch.kernels.simgnn_head import simgnn_head
from repro_torch.kernels.sparse_pair import sparse_pair_score
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.params import params_to

__all__ = ["flash_attention", "wkv6", "graph_embeddings_fused", "pair_scores_fused",
           "simgnn_pair_score_kernel", "pair_score_megakernel",
           "pair_score_packed", "packed_node_budget", "pair_score_sparse",
           "packed_edge_budget", "blocked_topm", "blocked_topm_ntn",
           "collapse_query_ntn", "retrieval_block_cols"]


def _args(params, arrays, device):
    """Params tree and contiguous arrays on the resolved device."""
    device = resolve_device(device)
    return params_to(params, device), [a.to(device).contiguous()
                                       for a in arrays]


def _weights(params):
    return params["gcn"], params["att"]["w"], params["ntn"], params["fcn"]


def graph_embeddings_fused(params, adj_norm, feats, mask, *, device=None):
    """SimGNN stages 1-2 through the embedding kernel: pre-normalised A'
    [B, N, N], one-hot feats, mask -> [B, F_last] embeddings."""
    params, arrays = _args(params, (adj_norm, feats, mask), device)
    return fused_gcn_att(*arrays, params["gcn"], params["att"]["w"])


def pair_scores_fused(params, hg1, hg2, *, device=None):
    """SimGNN stages 3-4 through the head kernel: [B, F] embedding pairs
    -> [B] scores."""
    params, (h1, h2) = _args(params, (hg1, hg2), device)
    return simgnn_head(h1, h2, params["ntn"], params["fcn"])


def simgnn_pair_score_kernel(params, adj1, feats1, mask1, adj2, feats2,
                             mask2, *, device=None):
    """Full SimGNN pipeline on the two-kernel path: both graphs share one
    embedding launch (batch 2B), then the head; the embeddings round-trip
    through device memory between the two. Expects raw adjacency; A' is
    normalised here on the device (parity with `core.simgnn`)."""
    from repro_torch.core.gcn import normalized_adjacency

    params, arrays = _args(params, (adj1, feats1, mask1, adj2, feats2, mask2),
                           device)
    adj, feats, mask = (torch.cat([arrays[i], arrays[i + 3]])
                        for i in range(3))
    hg = fused_gcn_att(normalized_adjacency(adj, mask), feats, mask,
                       params["gcn"], params["att"]["w"])
    hg1, hg2 = hg.chunk(2)
    return simgnn_head(hg1, hg2, params["ntn"], params["fcn"])


def pair_score_megakernel(params, adj1, feats1, mask1, adj2, feats2, mask2,
                          *, device=None):
    """Full SimGNN pipeline in one kernel launch per bucket (DESIGN.md §7):
    raw adjacency in, [B] scores out."""
    params, arrays = _args(params, (adj1, feats1, mask1, adj2, feats2, mask2),
                           device)
    return fused_pair_score(*arrays, *_weights(params))


def packed_node_budget(max_nodes: int) -> int:
    """Node budget of packed tiles: one whole graph must fit, 64 at least."""
    return max(64, -(-max_nodes // 8) * 8)


def pair_score_packed(params, packed, *, device=None):
    """Score a `core.batching.PackedPairBatch` through the packed-dense
    kernel: [T, P] pair-slot scores, zero at pad slots (DESIGN.md §8)."""
    params, arrays = _args(
        params, (packed.adj1, packed.labels1, packed.mask1, packed.seg1,
                 packed.adj2, packed.labels2, packed.mask2, packed.seg2,
                 packed.pair_mask), device)
    return packed_pair_score(*arrays, *_weights(params))


def packed_edge_budget(node_budget: int, avg_degree: float | None = None) -> int:
    """Packed-CSR edge budget per tile side: node_budget rows times a
    per-node neighbour budget D from the ladder 4/6/8/12/16/... sized to
    ~p75 of the in-degree (self loop included). Half-way degrees round up
    (floor(d + 0.5), not Python's banker's round())."""
    d = 2.5 if avg_degree is None else avg_degree
    need = math.floor(d + 0.5) + 2
    for per_node in (4, 6, 8, 12, 16, 24, 32, 48, 64):
        if per_node >= need:
            return node_budget * per_node
    return node_budget * node_budget


def pair_score_sparse(params, packed, *, device=None):
    """Score a `core.batching.PackedPairBatch` through the packed-sparse
    kernel (DESIGN.md §9): the same [T, P] contract as `pair_score_packed`.
    Expects `packed.edges` (pack with `with_edges=True`); when absent they
    are extracted here at the default `packed_edge_budget`."""
    from repro_torch.core.batching import packed_pair_edges

    edges = packed.edges
    if edges is None:
        edges = packed_pair_edges(packed,
                                  packed_edge_budget(packed.node_budget))
    e1, e2 = edges.edges1, edges.edges2
    o1, o2 = edges.overflow1, edges.overflow2
    params, arrays = _args(
        params, (e1.senders, e1.weights, o1.senders, o1.receivers, o1.weights,
                 packed.labels1, packed.mask1, packed.seg1,
                 e2.senders, e2.weights, o2.senders, o2.receivers, o2.weights,
                 packed.labels2, packed.mask2, packed.seg2, packed.pair_mask),
        device)
    return sparse_pair_score(*arrays, *_weights(params))
