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
the JAX wrappers' padding (`megakernel_block_pairs`, `quantize_tiles`,
`_pad_batch` with `block_graphs` / `block_pairs`), which sizes Pallas grid
blocks and XLA compile-cache shapes, has no counterpart here: batches go
to the kernels unpadded and the [T, P] / [B] results equal the JAX
wrappers'. The JAX tile-block policies (`packed_tile_block`,
`sparse_tile_block`) are kept as plain arithmetic, only as the numbers
the sharded plan is held to; the CUDA kernels keep their own launch plans.

Device-sharded scoring (DESIGN.md §16): `sharded_tile_plan` pads a call's
T live tiles to a power of two with a whole number of tile-block programs
a device, as the JAX package does, and `pair_score_packed_sharded` /
`pair_score_sparse_sharded` score the tile span `[d·span, min((d+1)·span,
T))` of mesh member d with the unchanged `packed_pair` / `sparse_pair`
wrapper, launched on that member's stream (`distributed/sharding.py`), and
gather the [T, P] scores in tile order. Pad tiles are never sent: a span
of pad tiles only launches nothing (JAX runs them and drops their
scores). The kernels score each tile alone, so a tile's scores do not
depend on the span it lands in.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import StreamFan
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.fused_gcn import fused_gcn_att
from repro_torch.kernels.fused_pair import fused_pair_score
from repro_torch.kernels.grad import packed_arrays
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
           "collapse_query_ntn", "retrieval_block_cols",
           "packed_tile_block", "sparse_tile_block", "sharded_tile_block",
           "sharded_tile_plan", "sharded_tile_target", "shard_spans",
           "pair_score_packed_sharded", "pair_score_sparse_sharded"]


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


def _kernel_arrays(packed, sparse: bool) -> tuple:
    """A PackedPairBatch's tensors in its kernel's order (`pair_mask`
    last). A sparse batch packed without `edges` gets them here at the
    default `packed_edge_budget`."""
    if sparse and packed.edges is None:
        from repro_torch.core.batching import packed_pair_edges

        packed = packed._replace(edges=packed_pair_edges(
            packed, packed_edge_budget(packed.node_budget)))
    return packed_arrays(packed, sparse=sparse)


def pair_score_packed(params, packed, *, device=None):
    """Score a `core.batching.PackedPairBatch` through the packed-dense
    kernel: [T, P] pair-slot scores, zero at pad slots (DESIGN.md §8)."""
    params, arrays = _args(params, _kernel_arrays(packed, False), device)
    return packed_pair_score(*arrays, *_weights(params))


def packed_tile_block(node_budget: int) -> int:
    """The JAX packed-dense megakernel's tiles a program (its VMEM policy:
    16 tiles at NB 64, 8 at NB 128)."""
    return max(1, min(16, 1024 // max(node_budget, 1)))


def sparse_tile_block(node_budget: int) -> int:
    """The JAX packed-sparse megakernel's tiles a program (twice
    `packed_tile_block`'s: 32 at NB 64)."""
    return max(1, min(32, 2048 // max(node_budget, 1)))


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
    params, arrays = _args(params, _kernel_arrays(packed, True), device)
    return sparse_pair_score(*arrays, *_weights(params))


# ------------------------------------- device-sharded scoring (§16)
#
# The shape policy is the JAX package's, all powers of two (tile block,
# padded tile count, device count), so every device's span is a whole
# number of identical tile-block programs.


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def sharded_tile_block(node_budget: int, *, sparse: bool = False) -> int:
    """Tiles-a-program ceiling of a sharded call: the single-device policy
    rounded down to a power of two."""
    tb = (sparse_tile_block if sparse else packed_tile_block)(node_budget)
    return _pow2_floor(tb)


def sharded_tile_plan(t: int, node_budget: int, n_devices: int, *,
                      sparse: bool = False) -> tuple[int, int]:
    """(padded tile count, tile block) of a sharded call over `t` live
    tiles: T pads to a power of two >= t with at least one program a
    device, and the tile block shrinks below the policy when the mesh has
    more devices than tiles to give them (20 tiles on 8 devices: 5 devices
    of one 4-tile program, not one device of a 32-tile program)."""
    tb = sharded_tile_block(node_budget, sparse=sparse)
    target = _pow2_ceil(max(t, 1))
    tb = min(tb, max(1, target // int(n_devices)))
    return max(target, int(n_devices) * tb), tb


def sharded_tile_target(t: int, tile_block: int, n_devices: int) -> int:
    """Padded tile count of a sharded call: a power of two >= t, and at
    least one tile-block program a device."""
    return max(_pow2_ceil(max(t, 1)), int(n_devices) * tile_block)


def shard_spans(t: int, target: int, n_devices: int) -> list:
    """Live tile span `(lo, hi)` of each device: device d owns padded
    tiles `[d·span, (d+1)·span)` with span = target / n_devices, clipped
    to the `t` live ones (lo == hi: pad tiles only)."""
    span = target // int(n_devices)
    return [(min(d * span, t), min((d + 1) * span, t))
            for d in range(int(n_devices))]


def shard_params(params, mesh) -> dict:
    """A float32 copy of `params` on each distinct device of `mesh` (the
    kernels read float32 weights), keyed by device, made on the device's
    current stream: the shards' streams wait on it before they launch.
    Leaves already float32 there are the caller's own tensors."""
    out = {}
    for dev in mesh.devices:
        if dev not in out:
            out[dev] = params_to(params, dev, torch.float32)
    return out


def score_tiles_sharded(kernel, arrays, params_by_device, mesh,
                        spans) -> torch.Tensor:
    """Score tile span `spans[d]` of `arrays` (in `kernel`'s order) on mesh
    member d and gather the [T, P] scores in tile order on the mesh's
    first device. On the card each shard is copied to its device and
    launched on its own stream through a `StreamFan`: the stream waits for
    the caller's first, the shard's inputs are marked used by it and its
    output by the caller's stream, which waits for every shard once all
    are launched, before the gather. An empty span launches nothing. A
    failing shard raises: no shard is retried here."""
    fan, parts = StreamFan(), []
    for d, (lo, hi) in enumerate(spans):
        if lo >= hi:
            continue
        dev = mesh.devices[d]
        weights = _weights(params_by_device[dev])
        with fan.member(mesh.streams[d]) as (reads, out):
            shard = [x[lo:hi].to(dev) for x in arrays]
            reads.extend(shard)   # inputs already on the card are views
            parts.append(kernel(*shard, *weights))
            out.append(parts[-1])
    fan.join()
    first = mesh.devices[0]
    return torch.cat([s.to(first) for s in parts])


def grad_tiles_sharded(fn, params, tgt, arrays, mesh) -> tuple:
    """The training twin of `score_tiles_sharded`: (loss, grads) of
    `fn(params, tgt, *arrays)` with the padded tile axis split evenly over
    `mesh` (device d owns tiles [d·span, (d+1)·span), span = T / size),
    each device running `fn` on its span and the devices' losses and grad
    trees added on the mesh's first device in device order: the port's
    `psum`, deterministic, so two identical calls give identical bits.

    Every call reads the `params` it is given: a device that holds them
    reads the caller's tensors, another card gets a float32 copy and sends
    its grads back. On the card each span is copied to its device and its
    forward and backward run on its own stream (autograd runs each
    backward op on its forward op's stream) through a `StreamFan`: inputs
    and params are marked used by the span's stream, results by the
    caller's, whose stream waits for every span once all are launched,
    before the sum. A span whose pair mask (the last array) holds no pair
    is pad tiles only and runs nothing: its loss and grads are exact
    zeros. A failing span raises: none is retried here."""
    from repro_torch.params import params_to, tree_leaves, tree_map

    n = mesh.size
    span = tgt.shape[0] // n
    first = mesh.devices[0]
    own = {t.device for t in tree_leaves(params)}
    fan, parts = StreamFan(), []
    for d in range(n):
        sl = slice(d * span, (d + 1) * span)
        if not bool(arrays[-1][sl].any()):
            continue
        dev = mesh.devices[d]
        p = params if own == {dev} else params_to(params, dev, torch.float32)
        with fan.member(mesh.streams[d]) as (reads, out):
            shard = [x[sl].to(dev) for x in (tgt, *arrays)]
            reads.extend(shard + tree_leaves(p))
            s, g = fn(p, *shard)
            out.extend([s] + tree_leaves(g))
            parts.append((s, g))
    fan.join()
    total = None
    for s, g in parts:
        s, g = s.to(first), params_to(g, first)
        if total is None:
            total = (s, g)
        else:
            it = iter(tree_leaves(g))
            total = (total[0] + s,
                     tree_map(lambda x: x + next(it), total[1]))
    if total is None:
        total = (torch.zeros((), dtype=torch.float32, device=first),
                 tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=first), params))
    return total


def score_packed_sharded(packed, params_by_device, mesh, *,
                         sparse: bool) -> tuple[torch.Tensor, int]:
    """A PackedPairBatch's [T, P] scores with its tiles split over `mesh`
    by `sharded_tile_plan`, and the padded tile count of that plan."""
    arrays = _kernel_arrays(packed, sparse)
    t = arrays[0].shape[0]
    target, _ = sharded_tile_plan(t, packed.node_budget, mesh.size,
                                  sparse=sparse)
    kernel = sparse_pair_score if sparse else packed_pair_score
    return score_tiles_sharded(kernel, arrays, params_by_device, mesh,
                               shard_spans(t, target, mesh.size)), target


def pair_score_packed_sharded(params, packed, *, mesh) -> torch.Tensor:
    """`pair_score_packed` with the tile axis split over `mesh` (a
    `distributed.sharding.TileMesh`): the same [T, P] scores, on the mesh's
    first device."""
    return score_packed_sharded(packed, shard_params(params, mesh), mesh,
                                sparse=False)[0]


def pair_score_sparse_sharded(params, packed, *, mesh) -> torch.Tensor:
    """`pair_score_sparse` with the tile axis split over `mesh`."""
    return score_packed_sharded(packed, shard_params(params, mesh), mesh,
                                sparse=True)[0]
