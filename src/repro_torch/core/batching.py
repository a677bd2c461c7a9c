"""Padded batching, size-bucketing and node-packing for many small graphs —
port of `repro.core.batching`.

Packing stays numpy on the host (the FPGA host-preprocessing role) and
produces exactly the JAX package's layouts: index planes, masks, segment
ids and pair maps are bit-identical, including the int16 ELL/COO index
planes. The A' edge weights come from `core.gcn.normalized_adjacency` and
agree within 2 ulp (see that module for XLA's rsqrt rounding). Tensors move
to the requested device once, at the end.

  * `pad_graphs` / `bucket_pairs` — graphs padded to the smallest bucket
    (8/16/32/64 nodes, power-of-two oversize buckets beyond);
  * `pack_pairs` — first-fit-decreasing packing of pairs into fixed
    `[node_budget]` tiles with per-node segment ids (DESIGN.md §8);
  * `packed_pair_edges` — the packed-CSR view of each tile's A' non-zeros:
    D ELLPACK neighbour planes plus a COO overflow list (DESIGN.md §9);
  * `to_edge_batch` / `edge_aggregate` — a padded batch's A' non-zeros as
    one edge list per graph, and the aggregation from it.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

DEFAULT_BUCKETS = (8, 16, 32, 64)


class GraphBatch(NamedTuple):
    """A batch of padded graphs as tensors on one device."""
    feats: torch.Tensor       # [B, N, F] one-hot node labels
    adj: torch.Tensor         # [B, N, N] raw 0/1 adjacency (no self loops)
    mask: torch.Tensor        # [B, N] 1.0 for real nodes
    n_nodes: torch.Tensor     # [B] int32
    labels: torch.Tensor | None = None   # [B, N] int32 node labels (pad 0)

    @property
    def max_nodes(self) -> int:
        return self.adj.shape[-1]


class EdgeBatch(NamedTuple):
    """Edge-list view (senders/receivers int16 or int32, weights A' entries,
    0 at pad slots)."""
    senders: torch.Tensor
    receivers: torch.Tensor
    weights: torch.Tensor
    edge_mask: torch.Tensor

    @property
    def edge_budget(self) -> int:
        return self.senders.shape[-1]


def _tensors(arrays, device) -> list[torch.Tensor]:
    return [torch.from_numpy(a).to(device) for a in arrays]


def pad_graphs(graphs: Sequence[dict], n_labels: int, max_nodes: int, *,
               device=None) -> GraphBatch:
    """graphs: list of {"adj": [n, n], "labels": [n] int}; pads to
    max_nodes and returns tensors on `device` (None = the card)."""
    device = resolve_device(device)
    b = len(graphs)
    feats = np.zeros((b, max_nodes, n_labels), np.float32)
    adj = np.zeros((b, max_nodes, max_nodes), np.float32)
    mask = np.zeros((b, max_nodes), np.float32)
    n_nodes = np.zeros((b,), np.int32)
    labels = np.zeros((b, max_nodes), np.int32)
    for i, g in enumerate(graphs):
        n = g["adj"].shape[0]
        if n > max_nodes:
            raise ValueError(f"graph with {n} nodes exceeds bucket {max_nodes}")
        adj[i, :n, :n] = g["adj"]
        feats[i, np.arange(n), g["labels"]] = 1.0
        mask[i, :n] = 1.0
        n_nodes[i] = n
        labels[i, :n] = g["labels"]
    return GraphBatch(*_tensors((feats, adj, mask, n_nodes, labels), device))


def bucket_for(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS, *,
               allow_oversize: bool = False) -> int:
    for b in buckets:
        if n <= b:
            return b
    if allow_oversize:
        # Oversized graphs get a power-of-two bucket of their own (pad
        # waste capped at 2x) instead of failing the call.
        b = buckets[-1]
        while b < n:
            b *= 2
        return b
    raise ValueError(f"graph with {n} nodes exceeds largest bucket {buckets[-1]}")


def bucket_pairs(pairs: Sequence[tuple], n_labels: int,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, *,
                 allow_oversize: bool = False, device=None):
    """Group graph pairs by the bucket of the larger graph: {bucket:
    (GraphBatch lhs, GraphBatch rhs, indices)}, `indices` (numpy int32)
    restoring the original pair order."""
    groups: dict[int, list] = {}
    for idx, (g1, g2) in enumerate(pairs):
        b = bucket_for(max(g1["adj"].shape[0], g2["adj"].shape[0]), buckets,
                       allow_oversize=allow_oversize)
        groups.setdefault(b, []).append((idx, g1, g2))
    out = {}
    for b, items in sorted(groups.items()):
        idxs = np.asarray([i for i, _, _ in items], np.int32)
        lhs = pad_graphs([g for _, g, _ in items], n_labels, b, device=device)
        rhs = pad_graphs([g for _, _, g in items], n_labels, b, device=device)
        out[b] = (lhs, rhs, idxs)
    return out


# --------------------------------------------------------- pair packing (§8)

class PackedPairBatch(NamedTuple):
    """Graph pairs packed into fixed node-budget tiles (DESIGN.md §8).

    Tile t holds up to P pairs; pair slot p owns one contiguous node range
    in the lhs tile (its G1) and one in the rhs tile (its G2). `seg*` maps
    every node slot to its pair slot (pad slots: segment 0 with mask 0)."""
    adj1: torch.Tensor        # [T, NB, NB] block-diagonal raw adjacency (lhs)
    labels1: torch.Tensor     # [T, NB] int32 node labels (pad 0)
    mask1: torch.Tensor       # [T, NB] 1.0 for real nodes
    seg1: torch.Tensor        # [T, NB] int32 pair-slot id in [0, P)
    adj2: torch.Tensor        # (rhs)
    labels2: torch.Tensor
    mask2: torch.Tensor
    seg2: torch.Tensor
    pair_mask: torch.Tensor   # [T, P] 1.0 for real pair slots
    pair_index: torch.Tensor  # [T, P] int32 original pair position
    edges: "PackedEdges | None" = None

    @property
    def node_budget(self) -> int:
        return self.adj1.shape[-1]

    @property
    def slots_per_tile(self) -> int:
        return self.pair_mask.shape[-1]


class PackedEdges(NamedTuple):
    """Packed-CSR view of a packed tile batch's normalized adjacency
    (DESIGN.md §9): per tile and side, D = edge_budget / node_budget
    ELLPACK neighbour planes (slot s holds the (s // NB)-th in-edge of node
    s % NB) plus a COO overflow list for in-degrees beyond D. Pad slots
    point at node 0 with exact-zero weight."""
    edges1: EdgeBatch         # lhs CSR rows, arrays [T, NB*D]
    edges2: EdgeBatch
    overflow1: EdgeBatch      # lhs COO spill, arrays [T, E_ov]
    overflow2: EdgeBatch

    @property
    def edge_budget(self) -> int:
        return self.edges1.senders.shape[-1]

    @property
    def overflow_budget(self) -> int:
        return self.overflow1.senders.shape[-1]


def pack_pairs(pairs: Sequence[tuple], node_budget: int = 64, *,
               slots_per_tile: int | None = None,
               with_edges: bool = False, edge_budget: int | None = None,
               overflow_budget: int = 8, device=None):
    """First-fit-decreasing packing of graph pairs into `[T, node_budget]`
    tiles -> (PackedPairBatch on `device`, stats).

    Both sides of a pair land in the same tile at the same pair slot; a
    pair goes to the first tile where its G1 fits the lhs budget AND its G2
    the rhs budget, in decreasing order of total pair size. With
    `with_edges=True` the batch carries `edges` (`packed_pair_edges`) and
    stats gain the edge budgets, nnz and densities. Same layouts and stats
    as the JAX package's `pack_pairs`."""
    device = resolve_device(device)
    sizes = [(g1["adj"].shape[0], g2["adj"].shape[0]) for g1, g2 in pairs]
    for n1, n2 in sizes:
        if max(n1, n2) > node_budget:
            raise ValueError(
                f"graph with {max(n1, n2)} nodes exceeds node_budget "
                f"{node_budget}; route oversized pairs to the padded fallback")
    cap = slots_per_tile if slots_per_tile else len(pairs) or 1
    order = sorted(range(len(pairs)), key=lambda i: -(sizes[i][0] + sizes[i][1]))
    tiles: list[dict] = []          # {"used1", "used2", "items": [pair idx]}
    for i in order:
        n1, n2 = sizes[i]
        for t in tiles:
            if (t["used1"] + n1 <= node_budget
                    and t["used2"] + n2 <= node_budget
                    and len(t["items"]) < cap):
                t["used1"] += n1
                t["used2"] += n2
                t["items"].append(i)
                break
        else:
            tiles.append({"used1": n1, "used2": n2, "items": [i]})

    n_tiles = len(tiles) or 1
    if slots_per_tile is None:
        most = max((len(t["items"]) for t in tiles), default=1)
        slots_per_tile = max(8, -(-most // 8) * 8)
    adj = [np.zeros((n_tiles, node_budget, node_budget), np.float32)
           for _ in range(2)]
    labels = [np.zeros((n_tiles, node_budget), np.int32) for _ in range(2)]
    mask = [np.zeros((n_tiles, node_budget), np.float32) for _ in range(2)]
    seg = [np.zeros((n_tiles, node_budget), np.int32) for _ in range(2)]
    pair_mask = np.zeros((n_tiles, slots_per_tile), np.float32)
    pair_index = np.zeros((n_tiles, slots_per_tile), np.int32)
    for t, tile in enumerate(tiles):
        offs = [0, 0]
        for p, idx in enumerate(tile["items"]):
            pair_mask[t, p] = 1.0
            pair_index[t, p] = idx
            for side, g in enumerate(pairs[idx]):
                n = g["adj"].shape[0]
                o = offs[side]
                adj[side][t, o:o + n, o:o + n] = g["adj"]
                labels[side][t, o:o + n] = g["labels"]
                mask[side][t, o:o + n] = 1.0
                seg[side][t, o:o + n] = p
                offs[side] += n

    real = [sum(s[0] for s in sizes), sum(s[1] for s in sizes)]
    cells = max(n_tiles * node_budget, 1)
    stats = {
        "n_pairs": len(pairs), "n_tiles": n_tiles,
        "node_budget": node_budget, "slots_per_tile": slots_per_tile,
        "occupancy_lhs": real[0] / cells, "occupancy_rhs": real[1] / cells,
        "pad_fraction_lhs": 1.0 - real[0] / cells,
        "pad_fraction_rhs": 1.0 - real[1] / cells,
        "mean_pairs_per_tile": len(pairs) / n_tiles,
    }
    packed = PackedPairBatch(*_tensors(
        (adj[0], labels[0], mask[0], seg[0], adj[1], labels[1], mask[1],
         seg[1], pair_mask, pair_index), device))
    if with_edges:
        planes = _edge_planes(((adj[0], mask[0]), (adj[1], mask[1])),
                              edge_budget, overflow_budget)
        packed = packed._replace(edges=_edges_on(planes, device))
        nnz = [int(csr[3].sum()) + int(ov[3].sum()) for csr, ov in planes]
        e_budget = planes[0][0][0].shape[-1]
        adj_cells = n_tiles * node_budget * node_budget
        stats.update(
            edge_budget=e_budget,
            overflow_budget=planes[0][1][0].shape[-1],
            nnz_lhs=nnz[0], nnz_rhs=nnz[1],
            density_lhs=nnz[0] / adj_cells, density_rhs=nnz[1] / adj_cells,
            edge_occupancy=(nnz[0] + nnz[1]) / max(2 * n_tiles * e_budget, 1))
    return packed, stats


def packed_pair_edges(packed: PackedPairBatch,
                      edge_budget: int | None = None,
                      overflow_budget: int = 8) -> PackedEdges:
    """Packed-CSR A' edge lists of a packed tile batch (DESIGN.md §9), on
    the batch's device. Budgets are powers of two and auto-grow to fit:
    `edge_budget=None` sizes D to the realized max in-degree (empty
    overflow); the COO list grows past `overflow_budget` to hold every
    spilled edge. Both sides share one budget."""
    sides = [(a.cpu().numpy(), m.cpu().numpy())
             for a, m in ((packed.adj1, packed.mask1),
                          (packed.adj2, packed.mask2))]
    return _edges_on(_edge_planes(sides, edge_budget, overflow_budget),
                     packed.mask1.device)


def _edges_on(planes, device) -> PackedEdges:
    (csr1, ov1), (csr2, ov2) = planes
    return PackedEdges(*(EdgeBatch(*_tensors(p, device))
                         for p in (csr1, csr2, ov1, ov2)))


def _edge_planes(sides, edge_budget: int | None, overflow_budget: int):
    """numpy ELL + COO planes for both sides: [((cs, cr, cw, cm),
    (os, or, ow, om)), ...]. One vectorized non-zero scan per side:
    np.nonzero returns row-major order, so edges arrive sorted by (tile,
    receiver) and the in-row rank is a searchsorted subtraction."""
    from repro_torch.core.gcn import normalized_adjacency

    nb = sides[0][0].shape[-1]
    if edge_budget is not None and edge_budget % nb:
        raise ValueError(f"edge_budget {edge_budget} must be a multiple of "
                         f"node_budget {nb} (CSR rows)")
    d_budget = (edge_budget // nb) if edge_budget else 1
    scans = []
    for adj, mask in sides:
        a_norm = normalized_adjacency(torch.from_numpy(adj),
                                      torch.from_numpy(mask)).numpy()
        tiles, rows, cols = np.nonzero(a_norm)
        w = a_norm[tiles, rows, cols].astype(np.float32)
        key = tiles.astype(np.int64) * nb + rows
        rank = np.arange(key.size) - np.searchsorted(key, key, side="left")
        max_rank = int(rank.max()) + 1 if key.size else 0
        scans.append((a_norm.shape[0], tiles, rows, cols, w, rank, max_rank))

    d = max(d_budget, 1)
    if edge_budget is None:
        d = next_pow2(max(s[6] for s in scans), floor=2)
    ov_need = 0
    for _, tiles, _, _, _, rank, _ in scans:
        spill = rank >= d
        if spill.any():
            ov_need = max(ov_need, int(np.bincount(tiles[spill]).max()))
    e_ov = next_pow2(ov_need, floor=max(8, overflow_budget))

    # Within-tile node indices fit int16 whenever the node budget does
    # (the JAX package's narrow index planes); the kernels widen on read.
    idx_dtype = np.int16 if nb < 2 ** 15 else np.int32
    out = []
    for t, tiles, rows, cols, w, rank, _ in scans:
        cs = np.zeros((t, nb * d), idx_dtype)
        cr = np.tile(np.tile(np.arange(nb, dtype=idx_dtype), d), (t, 1))
        cw = np.zeros((t, nb * d), np.float32)
        cm = np.zeros((t, nb * d), np.float32)
        os_ = np.zeros((t, e_ov), idx_dtype)
        or_ = np.zeros((t, e_ov), idx_dtype)
        ow = np.zeros((t, e_ov), np.float32)
        om = np.zeros((t, e_ov), np.float32)
        fit = rank < d
        # Plane-major (ELLPACK) flat slot: tile * NB·D + rank * NB + row.
        slot = tiles[fit] * (nb * d) + rank[fit] * nb + rows[fit]
        cs.reshape(-1)[slot] = cols[fit]
        cw.reshape(-1)[slot] = w[fit]
        cm.reshape(-1)[slot] = 1.0
        if (~fit).any():
            t_ov = tiles[~fit]            # sorted: position within tile is
            pos = (np.arange(t_ov.size)   # offset from the tile's first
                   - np.searchsorted(t_ov, t_ov, side="left"))
            oslot = t_ov * e_ov + pos
            os_.reshape(-1)[oslot] = cols[~fit]
            or_.reshape(-1)[oslot] = rows[~fit]
            ow.reshape(-1)[oslot] = w[~fit]
            om.reshape(-1)[oslot] = 1.0
        out.append(((cs, cr, cw, cm), (os_, or_, ow, om)))
    return out


def unpack_pair_scores(scores_tp, packed: PackedPairBatch,
                       n_pairs: int) -> np.ndarray:
    """Scatter kernel output [T, P] back to original pair order (host)."""
    s = torch.as_tensor(scores_tp).detach().cpu().float().numpy()
    live = packed.pair_mask.cpu().numpy() > 0
    out = np.zeros(n_pairs, np.float32)
    out[packed.pair_index.cpu().numpy()[live]] = s[live]
    return out


def next_pow2(n: int, floor: int = 8) -> int:
    """Smallest power of two >= max(n, floor) (always a true power of two,
    even when `floor` is not)."""
    target = max(n, floor)
    p = 1
    while p < target:
        p *= 2
    return p


#: (requested, grown) budget pairs already warned about: a stream that
#: outruns its `max_edges` on every batch re-derives the same grown budget
#: each call, so each distinct growth warns once per process.
_GROW_WARNED: set[tuple[int, int]] = set()


def reset_grow_warnings() -> None:
    """Clear the warn-once registry so the next budget growth warns
    again (test isolation, processes that re-tune budgets)."""
    _GROW_WARNED.clear()


def to_edge_batch(batch: GraphBatch, max_edges: int) -> EdgeBatch:
    """The normalised adjacency's non-zeros (self loops included, A'
    weights) as a padded edge list per graph, on the batch's device. The
    scan runs on the host in numpy; senders / receivers are int32 and pad
    slots carry node 0 with zero weight and mask.

    When a graph has more non-zeros than `max_edges`, the whole batch's
    budget grows to the next power of two that fits instead of raising,
    with a RuntimeWarning once per distinct (requested, grown) pair per
    process; the realised budget is `EdgeBatch.edge_budget`."""
    from repro_torch.core.gcn import normalized_adjacency

    a_norm = normalized_adjacency(batch.adj, batch.mask).cpu().numpy()
    bsz = a_norm.shape[0]
    nonzeros = [np.nonzero(a_norm[i]) for i in range(bsz)]
    peak = max((len(r) for r, _ in nonzeros), default=0)
    if peak > max_edges:
        grown = next_pow2(peak, floor=max(8, max_edges))
        if (max_edges, grown) not in _GROW_WARNED:
            _GROW_WARNED.add((max_edges, grown))
            import warnings
            warnings.warn(
                f"{peak} non-zeros exceed max_edges={max_edges}; growing the "
                f"edge budget to {grown} (power-of-two) instead of raising "
                "(warned once per stream: reuse EdgeBatch.edge_budget to "
                "stop re-growing)",
                RuntimeWarning, stacklevel=2)
        max_edges = grown
    senders = np.zeros((bsz, max_edges), np.int32)
    receivers = np.zeros((bsz, max_edges), np.int32)
    weights = np.zeros((bsz, max_edges), np.float32)
    emask = np.zeros((bsz, max_edges), np.float32)
    for i, (r, c) in enumerate(nonzeros):
        e = len(r)
        receivers[i, :e], senders[i, :e] = r, c
        weights[i, :e] = a_norm[i, r, c]
        emask[i, :e] = 1.0
    return EdgeBatch(*_tensors((senders, receivers, weights, emask),
                               batch.adj.device))


def edge_aggregate(edges: EdgeBatch, hw: torch.Tensor) -> torch.Tensor:
    """Aggregation from the edge list: out[b, r] = sum of w * hw[b, s] over
    the edges (s, r, w) of graph b; pad slots add exact zeros. hw [B, N, F]
    -> [B, N, F]. Differentiable (`kernels.common.edge_aggregate_block`)."""
    from repro_torch.kernels.common import edge_aggregate_block

    return edge_aggregate_block(edges.senders, edges.receivers,
                                edges.weights * edges.edge_mask, hw)
