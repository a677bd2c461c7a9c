"""Public wrappers around the port's pair-scoring kernels — port of the
pair-scoring part of `repro.kernels.ops`.

They take a params tree and batches, move both to `device` (None = the
card; raises without CUDA unless `device="cpu"`) and call the kernel
wrappers, which launch CUDA on the card and run their plain versions on
the CPU:

  * `pair_score_sparse` — packed-CSR tiles (`kernels/sparse_pair.py`), the
    engine's choice for sparse (AIDS-like) streams;
  * `pair_score_packed` — packed tiles with dense tile adjacency
    (`kernels/packed_pair.py`);
  * `pair_score_megakernel` — bucket-padded pairs (`kernels/fused_pair.py`).

The CUDA kernels run one CTA per pair or tile and take any batch size, so
the JAX wrappers' block policies (`megakernel_block_pairs`,
`packed_tile_block`, `sparse_tile_block`, `quantize_tiles`), which size
Pallas grid blocks and XLA compile-cache shapes, have no counterpart here:
batches go to the kernels unpadded and the [T, P] / [B] results equal the
JAX wrappers'. The sharded wrappers are not ported yet.
"""

from __future__ import annotations

import math

from repro_torch.device import resolve_device
from repro_torch.kernels.fused_pair import fused_pair_score
from repro_torch.kernels.packed_pair import packed_pair_score
from repro_torch.kernels.sparse_pair import sparse_pair_score
from repro_torch.params import params_to

__all__ = ["pair_score_megakernel", "pair_score_packed", "packed_node_budget",
           "pair_score_sparse", "packed_edge_budget"]


def _args(params, arrays, device):
    """Params tree and contiguous arrays on the resolved device."""
    device = resolve_device(device)
    return params_to(params, device), [a.to(device).contiguous()
                                       for a in arrays]


def _weights(params):
    return params["gcn"], params["att"]["w"], params["ntn"], params["fcn"]


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
