"""Differentiable twins of the packed pair-score kernels — port of
`repro.kernels.grad` (DESIGN.md §11).

The JAX package cannot differentiate `pl.pallas_call`, so it composes the
packed kernels' bodies from `kernels/common.py`, whose custom VJP rules
reuse the forward's edge planes, under `jit`. The port composes the same
bodies in plain PyTorch: the packed kernels' plain versions, whose gather
and segment bodies carry those rules as `torch.autograd.Function`s. No CUDA
kernel runs here, on either device, as no Pallas kernel runs on the JAX
package's training path.

  * `packed_pair_score_grad` — the dense block-diagonal tile path (§8);
  * `sparse_pair_score_grad` — the packed-CSR edge path (§9).

Both take the `core.batching.pack_pairs` layouts the inference kernels
take and return the same `[T, P]` pair-slot scores (exact zeros at pad
slots), so one packing pass serves the forward and backward passes of
every accumulation chunk. `core.engine.ScoringEngine.loss_and_grad` is the
dispatch point.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.packed_pair import packed_pair_score_plain
from repro_torch.kernels.sparse_pair import sparse_pair_score_plain


def _weights(params) -> tuple:
    return params["gcn"], params["att"]["w"], params["ntn"], params["fcn"]


def packed_pair_score_grad(params, adj1, labels1, mask1, seg1,
                           adj2, labels2, mask2, seg2,
                           pair_mask) -> torch.Tensor:
    """Differentiable packed-dense scorer: in-graph normalisation, the GCN
    stack with the W1 label gather, segment Att pooling, NTN/FCN. pack_pairs
    layout in, [T, P] pair-slot scores out (zero at pad slots)."""
    return packed_pair_score_plain(adj1, labels1, mask1, seg1, adj2, labels2,
                                   mask2, seg2, pair_mask, *_weights(params))


def sparse_pair_score_grad(params,
                           nbr1, nbr_w1, ov_snd1, ov_rcv1, ov_w1,
                           labels1, mask1, seg1,
                           nbr2, nbr_w2, ov_snd2, ov_rcv2, ov_w2,
                           labels2, mask2, seg2,
                           pair_mask) -> torch.Tensor:
    """Differentiable packed-sparse scorer: aggregation from the packed-CSR
    edge planes (`csr_aggregate_block_sym`, whose backward aggregates the
    cotangent over the same planes). pack_pairs(with_edges=True) layout in,
    [T, P] pair-slot scores out."""
    return sparse_pair_score_plain(nbr1, nbr_w1, ov_snd1, ov_rcv1, ov_w1,
                                   labels1, mask1, seg1, nbr2, nbr_w2,
                                   ov_snd2, ov_rcv2, ov_w2, labels2, mask2,
                                   seg2, pair_mask, *_weights(params))


def packed_arrays(packed, *, sparse: bool) -> tuple:
    """Flatten a PackedPairBatch into the positional tensor tuple the
    matching `*_score_grad` function takes (`pair_mask` last)."""
    if sparse:
        e = packed.edges
        return (e.edges1.senders, e.edges1.weights,
                e.overflow1.senders, e.overflow1.receivers,
                e.overflow1.weights,
                packed.labels1, packed.mask1, packed.seg1,
                e.edges2.senders, e.edges2.weights,
                e.overflow2.senders, e.overflow2.receivers,
                e.overflow2.weights,
                packed.labels2, packed.mask2, packed.seg2,
                packed.pair_mask)
    return (packed.adj1, packed.labels1, packed.mask1, packed.seg1,
            packed.adj2, packed.labels2, packed.mask2, packed.seg2,
            packed.pair_mask)
