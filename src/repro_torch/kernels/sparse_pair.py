"""Edge-centric packed-sparse (packed-CSR) pair-score megakernel — port of
`repro.kernels.sparse_pair` (DESIGN.md §9).

Same dataflow as the packed-dense kernel — FFD-packed segment-id tiles,
segment Att pooling, NTN/FCN on tile-aligned pair slots, nothing but final
scores leaving the kernel — but each GCN layer aggregates from the tile's
host-built A' non-zeros: D ELLPACK neighbour planes plus a small COO
overflow list (`core.batching.packed_pair_edges`), with the first layer a
W1 row gather from int labels.

`sparse_pair_score` launches the CUDA kernel `csrc/sparse_pair.cu` on CUDA
tensors (one CTA per tile; see the source for what bounds it) and runs
`sparse_pair_score_plain` on CPU tensors. Pad edge slots point at node 0
with zero weight, pad nodes carry mask 0 / segment 0, and pad pair slots
are zeroed by `pair_mask`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.common import (gcn_layers_edge_block, layer_pairs,
                                        ntn_fcn_block, ntn_operands,
                                        segment_att_pool_block)


def sparse_pair_score_plain(nbr1, nbr_w1, ov_snd1, ov_rcv1, ov_w1, labels1,
                            mask1, seg1, nbr2, nbr_w2, ov_snd2, ov_rcv2,
                            ov_w2, labels2, mask2, seg2, pair_mask,
                            gcn_params, att_w, ntn_params, fcn_params):
    """Plain PyTorch version: [T, P] pair-slot scores, both sides stacked
    into one [2T, ...] block as the Pallas body does."""
    t, p = pair_mask.shape

    def cat(a, b):
        return torch.cat([a, b])

    mask = cat(mask1, mask2).float()
    h = gcn_layers_edge_block(cat(nbr1, nbr2), cat(nbr_w1, nbr_w2),
                              cat(ov_snd1, ov_snd2), cat(ov_rcv1, ov_rcv2),
                              cat(ov_w1, ov_w2), None, mask,
                              layer_pairs(gcn_params),
                              labels=cat(labels1, labels2))
    hg = segment_att_pool_block(h, mask, cat(seg1, seg2), att_w, p)
    f = hg.shape[-1]
    scores = ntn_fcn_block(hg[:t].reshape(t * p, f), hg[t:].reshape(t * p, f),
                           *ntn_operands(ntn_params, f),
                           layer_pairs(fcn_params))
    return scores.reshape(t, p) * pair_mask.float()


class SparseSide(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in
                ("nbr", "nw", "ovs", "ovr", "ovw", "labels", "mask", "seg")]


@functools.cache
def _launcher():
    """The C entry point, its side struct checked and signature set once."""
    lib = build.library("sparse_pair")
    build.check_side_struct(lib, "sparse_side_size", SparseSide)
    return build.bind(lib.sparse_pair_score_launch, [
        ctypes.POINTER(SparseSide), ctypes.POINTER(SparseSide),
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.POINTER(build.SimgnnParams), ctypes.c_void_p])


def sparse_pair_score(nbr1, nbr_w1, ov_snd1, ov_rcv1, ov_w1, labels1, mask1,
                      seg1, nbr2, nbr_w2, ov_snd2, ov_rcv2, ov_w2, labels2,
                      mask2, seg2, pair_mask, gcn_params, att_w, ntn_params,
                      fcn_params):
    """Packed tiles in packed-CSR edge form -> [T, P] pair-slot scores.
    CUDA tensors launch `csrc/sparse_pair.cu` (counted in
    `sparse_pair_score.launches`); CPU tensors run the plain version."""
    args = (nbr1, nbr_w1, ov_snd1, ov_rcv1, ov_w1, labels1, mask1, seg1,
            nbr2, nbr_w2, ov_snd2, ov_rcv2, ov_w2, labels2, mask2, seg2,
            pair_mask)
    if not on_cuda(*args):
        return sparse_pair_score_plain(*args, gcn_params, att_w, ntn_params,
                                       fcn_params)
    t, nb = mask1.shape
    e = nbr1.shape[-1]
    e_ov = ov_snd1.shape[-1]
    p = pair_mask.shape[-1]
    if e % nb:
        raise ValueError(f"edge planes of {e} slots are not {nb}-node rows")
    out = torch.empty((t, p), dtype=torch.float32, device=mask1.device)
    if t == 0:
        return out
    fn = _launcher()
    sides = []
    for s, (nbr, nw, ovs, ovr, ovw, lab, msk, seg) in enumerate(
            (args[:8], args[8:16])):
        sides.append(SparseSide(
            build.checked(nbr, f"nbr{s + 1}", torch.int16, (t, e)),
            build.checked(nw, f"nbr_w{s + 1}", torch.float32, (t, e)),
            build.checked(ovs, f"ov_snd{s + 1}", torch.int16, (t, e_ov)),
            build.checked(ovr, f"ov_rcv{s + 1}", torch.int16, (t, e_ov)),
            build.checked(ovw, f"ov_w{s + 1}", torch.float32, (t, e_ov)),
            build.checked(lab, f"labels{s + 1}", torch.int32, (t, nb)),
            build.checked(msk, f"mask{s + 1}", torch.float32, (t, nb)),
            build.checked(seg, f"seg{s + 1}", torch.int32, (t, nb))))
    pm = build.checked(pair_mask, "pair_mask", torch.float32, (t, p))
    params, _keep = build.simgnn_params(
        {"gcn": gcn_params, "att": {"w": att_w}, "ntn": ntn_params,
         "fcn": fcn_params}, mask1.device)
    err = fn(ctypes.byref(sides[0]), ctypes.byref(sides[1]), pm,
             out.data_ptr(), t, nb, e // nb, e_ov, p, ctypes.byref(params),
             torch.cuda.current_stream(mask1.device).cuda_stream)
    build.check_launch(err, "sparse_pair")
    sparse_pair_score.launches += 1
    return out


sparse_pair_score.launches = 0
