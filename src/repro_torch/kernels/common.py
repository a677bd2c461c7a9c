"""Plain PyTorch versions of the SimGNN kernel bodies — port of the
`*_block` bodies in `repro.kernels.common` and of their custom VJP rules
(DESIGN.md §11).

Each function computes what the Pallas body computes, on whole tensors, in
float32 whatever the input dtype. They are the CPU path of the kernel
wrappers (`sparse_pair.py`, `packed_pair.py`, `fused_pair.py`), the
reference `chip_smoke.py` holds every CUDA kernel against on the card, the
parity anchor the CPU tests hold against the JAX bodies, and, composed in
`kernels/grad.py`, the training path on either device.

The gather and segment bodies carry the JAX package's backward rules as
`torch.autograd.Function`s, each forward the body as it was: the W1 row
gather's dW1 is one one-hot contraction; an edge aggregation's `hw`
cotangent is the same aggregation with the sender and receiver planes
swapped (for the symmetric packed-CSR form, the forward aggregation applied
to the cotangent), plus the per-edge weight cotangent when asked for; the
segment Att pooling differentiates its body against the segment one-hot
saved by the forward. No backward uses `index_add_` or `scatter_add_`
(atomics on the card): sums over edges are one-hot contractions or adds of
gathered planes, so two runs on the card give the same bits. Edge
aggregation forwards are one-hot contractions for the same reason.

`layer_wb` is a list of (w, b) pairs of any length (SimGNNConfig.gcn_dims).
Integer index planes may be int16 or int32; torch indexing needs int64, so
they are widened on use.
"""

from __future__ import annotations

import torch

from repro_torch.core.gcn import normalized_adjacency


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [GB, N, F], idx [GB, E] -> x[g, idx[g, e], :] as [GB, E, F]."""
    return torch.take_along_dim(x, idx.long()[..., None], dim=1)


def _needs(ctx, *i) -> bool:
    return any(ctx.needs_input_grad[k] for k in i)


class _LabelGather(torch.autograd.Function):
    """W[labels] forward; dW = one_hot(labels)^T @ g backward (one [L, M]
    x [M, F] contraction, no scatter)."""

    @staticmethod
    def forward(ctx, w, labels):
        ctx.save_for_backward(labels)
        ctx.w_meta = (w.shape[0], w.dtype)
        return w.float()[labels.long()]

    @staticmethod
    def backward(ctx, g):
        (labels,) = ctx.saved_tensors
        n_labels, dtype = ctx.w_meta
        ids = torch.arange(n_labels, device=labels.device)
        flat = labels.reshape(-1).long()
        onehot_t = (flat[None, :] == ids[:, None]).float()          # [L, M]
        dw = onehot_t @ g.reshape(flat.shape[0], -1).float()
        return dw.to(dtype), None


def label_gather(w: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """First-layer one-hot elimination: one_hot(labels) @ W == W[labels].
    w [L, F], labels [...] -> [..., F] float32."""
    return _LabelGather.apply(w, labels)


#: In-kernel A' = D^-1/2 (A + I) D^-1/2 on a [GB, N, N] block under the
#: node mask. The JAX package keeps a second copy of the model's function
#: only so that Mosaic can lower its identity matrix; here it is the model's.
normalize_adjacency_block = normalized_adjacency


def _transform(h, w, b, li: int, labels, gb: int, n: int) -> torch.Tensor:
    """One layer's H·W + b: the W1 row gather on layer 0 when int labels
    are given, else a matmul. -> [GB, N, Fout] float32."""
    if li == 0 and labels is not None:
        hw = label_gather(w, labels.reshape(gb * n))
    else:
        hw = h.reshape(gb * n, -1) @ w.float()
    return (hw + b.float()).reshape(gb, n, -1)


def gcn_layers_block(adj_norm, h, mask, layer_wb, *, labels=None):
    """Variadic GCN stack on a graph block with dense aggregation:
    adj_norm [GB, N, N], h [GB, N, F0] (None with `labels` [GB, N]),
    mask [GB, N] -> [GB, N, F_last]."""
    gb, n, _ = adj_norm.shape
    for li, (w, b) in enumerate(layer_wb):
        hw = _transform(h, w, b, li, labels, gb, n)
        h = torch.relu(torch.bmm(adj_norm, hw)) * mask[..., None]
    return h


def _overflow_aggregate(ov_snd, ov_rcv, ov_w, hw):
    """COO overflow contraction: out[g, r] = sum over overflow edges e with
    ov_rcv[g, e] == r of ov_w[g, e] * hw[g, ov_snd[g, e]]."""
    gb, n, _ = hw.shape
    msgs = _gather_rows(hw, ov_snd) * ov_w.float()[..., None]      # [GB,Eo,F]
    node_ids = torch.arange(n, device=hw.device)[None, :, None]
    scat = (ov_rcv.long()[:, None, :] == node_ids).float()         # [GB,N,Eo]
    return torch.bmm(scat, msgs)


def _edge_weight_cotangent(senders, receivers, hw, g):
    """dL/dw of one edge list: per edge, <g[receiver], hw[sender]> — the
    forward's two gathers reduced over F. [GB, E] float32."""
    return (_gather_rows(g.float(), receivers)
            * _gather_rows(hw.float(), senders)).sum(-1)


class _EdgeAggregate(torch.autograd.Function):
    """out[g, r] = sum over edges e with receivers[g, e] == r of
    weights[g, e] * hw[g, senders[g, e]] — the JAX package's segment sum,
    computed by the COO overflow body's one-hot contraction. Backward: the
    same sweep with sender and receiver planes swapped, and the weight
    cotangent when asked for."""

    @staticmethod
    def forward(ctx, senders, receivers, weights, hw):
        ctx.save_for_backward(senders, receivers, weights, hw)
        return _overflow_aggregate(senders, receivers, weights, hw)

    @staticmethod
    def backward(ctx, g):
        senders, receivers, weights, hw = ctx.saved_tensors
        d_w = d_hw = None
        if _needs(ctx, 3):
            d_hw = _overflow_aggregate(receivers, senders, weights,
                                       g.float()).to(hw.dtype)
        if _needs(ctx, 2):
            d_w = _edge_weight_cotangent(senders, receivers, hw,
                                         g).to(weights.dtype)
        return None, None, d_w, d_hw


def edge_aggregate_block(senders, receivers, weights, hw):
    """Segment-sum aggregation from a tile-local edge list: senders /
    receivers [GB, E], weights [GB, E] (pad slots exact zero), hw [GB, N,
    F] -> [GB, N, F]. Pad edges gather row 0 and multiply by zero."""
    return _EdgeAggregate.apply(senders, receivers, weights, hw)


#: The COO overflow list's aggregation: the same function and backward
#: rule as `edge_aggregate_block` (the JAX package keeps two forward bodies,
#: a segment sum and a one-hot contraction; here both are the latter).
overflow_aggregate_block = edge_aggregate_block


def _csr_aggregate(nbr, nbr_w, ov_snd, ov_rcv, ov_w, hw):
    """Packed-CSR aggregation: the sum of D ELLPACK neighbour planes (slot
    s holds the (s // N)-th in-edge of node s % N) plus the COO overflow."""
    gb, n, f = hw.shape
    d = nbr.shape[-1] // n
    msgs = (_gather_rows(hw, nbr) * nbr_w.float()[..., None]).reshape(gb, d, n, f)
    out = msgs[:, 0]
    for k in range(1, d):
        out = out + msgs[:, k]
    return out + _overflow_aggregate(ov_snd, ov_rcv, ov_w, hw)


def _ell_receivers(nbr, n: int) -> torch.Tensor:
    """The implicit receiver plane of ELLPACK slots: slot s is node s % N."""
    d = nbr.shape[-1] // n
    return torch.arange(n, device=nbr.device).repeat(d).expand(nbr.shape)


class _CsrAggregate(torch.autograd.Function):
    """`_csr_aggregate` forward. Backward (`sym` False): the cotangent,
    gathered by each slot's implicit receiver, contracted onto the senders
    by one-hot, plus the COO tail with its planes swapped; (`sym` True, A'
    symmetric as the whole ELL+COO split) the forward aggregation of the
    cotangent. Weight cotangents follow the generic rule in both."""

    @staticmethod
    def forward(ctx, nbr, nbr_w, ov_snd, ov_rcv, ov_w, hw, sym):
        ctx.save_for_backward(nbr, nbr_w, ov_snd, ov_rcv, ov_w, hw)
        ctx.sym = sym
        return _csr_aggregate(nbr, nbr_w, ov_snd, ov_rcv, ov_w, hw)

    @staticmethod
    def backward(ctx, g):
        nbr, nbr_w, ov_snd, ov_rcv, ov_w, hw = ctx.saved_tensors
        g32 = g.float()
        n = hw.shape[1]
        d_nbr_w = d_ov_w = d_hw = None
        if _needs(ctx, 5):
            if ctx.sym:
                d_hw = _csr_aggregate(nbr, nbr_w, ov_snd, ov_rcv, ov_w, g32)
            else:
                d_hw = (_overflow_aggregate(_ell_receivers(nbr, n), nbr,
                                            nbr_w, g32)
                        + _overflow_aggregate(ov_rcv, ov_snd, ov_w, g32))
            d_hw = d_hw.to(hw.dtype)
        if _needs(ctx, 1):
            d_nbr_w = _edge_weight_cotangent(
                nbr, _ell_receivers(nbr, n), hw, g32).to(nbr_w.dtype)
        if _needs(ctx, 4):
            d_ov_w = _edge_weight_cotangent(ov_snd, ov_rcv, hw,
                                            g32).to(ov_w.dtype)
        return None, d_nbr_w, None, None, d_ov_w, d_hw, None


def csr_aggregate_block(nbr, nbr_w, ov_snd, ov_rcv, ov_w, hw):
    """Degree-aware packed-CSR aggregation (DESIGN.md §9): D ELLPACK
    neighbour planes plus the COO overflow, for any edge orientation."""
    return _CsrAggregate.apply(nbr, nbr_w, ov_snd, ov_rcv, ov_w, hw, False)


def csr_aggregate_block_sym(nbr, nbr_w, ov_snd, ov_rcv, ov_w, hw):
    """`csr_aggregate_block` for a structurally symmetric A' (every
    normalised adjacency here): the same forward; the `hw` cotangent is the
    forward aggregation applied to the output cotangent."""
    return _CsrAggregate.apply(nbr, nbr_w, ov_snd, ov_rcv, ov_w, hw, True)


def gcn_layers_edge_block(nbr, nbr_w, ov_snd, ov_rcv, ov_w, h, mask,
                          layer_wb, *, labels=None):
    """GCN stack whose aggregation runs from the packed-CSR edge planes
    (host-precomputed A' non-zeros; no adjacency block, no in-kernel
    normalization). A' is symmetric by construction, so the aggregation
    takes the symmetric backward."""
    gb, n = mask.shape
    for li, (w, b) in enumerate(layer_wb):
        hw = _transform(h, w, b, li, labels, gb, n)
        h = csr_aggregate_block_sym(nbr, nbr_w, ov_snd, ov_rcv, ov_w, hw)
        h = torch.relu(h) * mask[..., None]
    return h


def att_pool_block(h, mask, att_w):
    """Att stage (paper Eq. 3): h [GB, N, F], mask [GB, N] -> [GB, F]."""
    n_valid = mask.sum(1, keepdim=True).clamp_min(1.0)
    mean_h = (h * mask[..., None]).sum(1) / n_valid
    c = torch.tanh(mean_h @ att_w.float())
    att = torch.sigmoid((h * c[:, None, :]).sum(-1)) * mask
    return (att[..., None] * h).sum(1)


def gcn_att_block(adj_norm, h, mask, layer_wb, att_w, *, labels=None):
    """GCN stack + per-graph Att pooling: -> [GB, F_last]."""
    h = gcn_layers_block(adj_norm, h, mask, layer_wb, labels=labels)
    return att_pool_block(h, mask, att_w)


def segment_onehot(seg, mask, n_segments: int):
    """S [GB, P, N]: S[g, p, n] = 1 iff node slot n belongs to segment p
    and is a real node (pad slots are zero in every row)."""
    p_ids = torch.arange(n_segments, device=seg.device)[None, :, None]
    return (seg.long()[:, None, :] == p_ids).float() * mask[:, None, :]


def _seg_att_pool_from_onehot(h, mask, s, att_w):
    """Segment Att pooling given the segment one-hot S [GB, P, N]: the body
    of `segment_att_pool_block`'s forward and backward."""
    counts = s.sum(-1, keepdim=True).clamp_min(1.0)
    mean_h = torch.bmm(s, h) / counts
    c = torch.tanh(mean_h @ att_w.float())
    c_node = torch.bmm(s.transpose(1, 2), c)                       # [GB,N,F]
    att = torch.sigmoid((h * c_node).sum(-1)) * mask
    return torch.bmm(s, att[..., None] * h)


class _SegmentAttPool(torch.autograd.Function):
    """Forward builds S once and saves it; backward differentiates the
    matmul body against the same S (the int `seg` plane gets no
    cotangent). S = onehot(seg) * mask also carries mask sensitivity,
    fetched by one gather of dS at each node's own segment row."""

    @staticmethod
    def forward(ctx, h, mask, seg, att_w, n_segments):
        s = segment_onehot(seg, mask, n_segments)
        ctx.save_for_backward(h, mask, seg, s, att_w)
        return _seg_att_pool_from_onehot(h, mask, s, att_w)

    @staticmethod
    def backward(ctx, g):
        h, mask, seg, s, att_w = ctx.saved_tensors
        want = (_needs(ctx, 0), _needs(ctx, 1), _needs(ctx, 1),
                _needs(ctx, 3))
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(w)
                      for x, w in zip((h, mask, s, att_w), want)]
            out = _seg_att_pool_from_onehot(*leaves)
            wanted = [x for x, w in zip(leaves, want) if w]
            grads = iter(torch.autograd.grad(out, wanted, g.float()))
        d_h, d_mask, d_s, d_att_w = (next(grads) if w else None
                                     for w in want)
        if d_mask is not None:
            d_mask = (d_mask + torch.take_along_dim(
                d_s, seg.long()[:, None, :], dim=1)[:, 0, :]).to(mask.dtype)
        return (None if d_h is None else d_h.to(h.dtype), d_mask, None,
                None if d_att_w is None else d_att_w.to(att_w.dtype), None)


def segment_att_pool_block(h, mask, seg, att_w, n_segments: int):
    """Att pooling per segment of a packed tile (DESIGN.md §8): h [GB, N,
    F], seg [GB, N] in [0, P) -> [GB, P, F]; empty segments give zeros."""
    return _SegmentAttPool.apply(h, mask, seg, att_w, n_segments)


def ntn_fcn_block(h1, h2, wt, vt, bias, fcn_wb):
    """NTN + FCN on a pair block: h1/h2 [GB, F] -> [GB, 1] sigmoid scores.
    `wt` is W [K, F, F] reshaped to [F, K*F], `vt` is V [K, 2F] transposed."""
    gb, f = h1.shape
    k = bias.shape[0]
    t = h1 @ wt.float()
    bilinear = (t.reshape(gb, k, f) * h2[:, None, :]).sum(-1)
    linear = torch.cat([h1, h2], -1) @ vt.float()
    s = torch.relu(bilinear + linear + bias.float())
    for i, (w, b) in enumerate(fcn_wb):
        s = s @ w.float() + b.float()
        if i + 1 < len(fcn_wb):
            s = torch.relu(s)
    return torch.sigmoid(s)


def ntn_operands(ntn_params, f: int):
    """(wt [F, K*F], vt [2F, K], b [K]) — the pre-transposed NTN layout
    `ntn_fcn_block` takes."""
    k = ntn_params["b"].shape[0]
    wt = ntn_params["w"].permute(1, 0, 2).reshape(f, k * f)
    return wt, ntn_params["v"].T, ntn_params["b"]


def layer_pairs(layers) -> list:
    """[{'w','b'}, ...] -> [(w, b), ...]."""
    return [(p["w"], p["b"]) for p in layers]
