"""Plain PyTorch versions of the SimGNN kernel bodies — port of the forward
`*_block` bodies in `repro.kernels.common`.

Each function computes what the Pallas body computes, on whole tensors, in
float32 whatever the input dtype. They are the CPU path of the kernel
wrappers (`sparse_pair.py`, `packed_pair.py`, `fused_pair.py`), the
reference `chip_smoke.py` holds every CUDA kernel against on the card, and
the parity anchor the CPU tests hold against the JAX bodies. The JAX
package's custom VJP rules are not ported yet (the training slice).

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


def label_gather(w: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """First-layer one-hot elimination: one_hot(labels) @ W == W[labels].
    w [L, F], labels [M] -> [M, F] float32."""
    return w.float()[labels.long()]


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


def gcn_layers_edge_block(nbr, nbr_w, ov_snd, ov_rcv, ov_w, h, mask,
                          layer_wb, *, labels=None):
    """GCN stack whose aggregation runs from the packed-CSR edge planes
    (host-precomputed A' non-zeros; no adjacency block, no in-kernel
    normalization)."""
    gb, n = mask.shape
    for li, (w, b) in enumerate(layer_wb):
        hw = _transform(h, w, b, li, labels, gb, n)
        h = _csr_aggregate(nbr, nbr_w, ov_snd, ov_rcv, ov_w, hw)
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


def segment_att_pool_block(h, mask, seg, att_w, n_segments: int):
    """Att pooling per segment of a packed tile (DESIGN.md §8): h [GB, N,
    F], seg [GB, N] in [0, P) -> [GB, P, F]; empty segments give zeros."""
    s = segment_onehot(seg, mask, n_segments)
    counts = s.sum(-1, keepdim=True).clamp_min(1.0)
    mean_h = torch.bmm(s, h) / counts
    c = torch.tanh(mean_h @ att_w.float())
    c_node = torch.bmm(s.transpose(1, 2), c)                       # [GB,N,F]
    att = torch.sigmoid((h * c_node).sum(-1)) * mask
    return torch.bmm(s, att[..., None] * h)


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
