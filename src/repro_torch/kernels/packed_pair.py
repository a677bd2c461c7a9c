"""Node-packed pair-score megakernel with dense tile adjacency — port of
`repro.kernels.packed_pair` (DESIGN.md §8).

Per packed tile: both sides' block-diagonal raw adjacency normalized in
the kernel to D^-1/2 (A + I) D^-1/2 under the node mask, the GCN stack
with dense aggregation A'·(HW) and a first-layer W1 row gather from int
labels, segment Att pooling over the P pair slots, NTN, FCN and sigmoid.

`packed_pair_score` launches the CUDA kernel `csrc/packed_pair.cu` on CUDA
tensors (one CTA per tile; see the source for what bounds it) and runs
`packed_pair_score_plain` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.common import (gcn_layers_block, layer_pairs,
                                        normalize_adjacency_block,
                                        ntn_fcn_block, ntn_operands,
                                        segment_att_pool_block)


def packed_pair_score_plain(adj1, labels1, mask1, seg1, adj2, labels2, mask2,
                            seg2, pair_mask, gcn_params, att_w, ntn_params,
                            fcn_params):
    """Plain PyTorch version: [T, P] pair-slot scores."""
    t, p = pair_mask.shape
    adj = torch.cat([adj1, adj2]).float()
    mask = torch.cat([mask1, mask2]).float()
    a_norm = normalize_adjacency_block(adj, mask)
    h = gcn_layers_block(a_norm, None, mask, layer_pairs(gcn_params),
                         labels=torch.cat([labels1, labels2]))
    hg = segment_att_pool_block(h, mask, torch.cat([seg1, seg2]), att_w, p)
    f = hg.shape[-1]
    scores = ntn_fcn_block(hg[:t].reshape(t * p, f), hg[t:].reshape(t * p, f),
                           *ntn_operands(ntn_params, f),
                           layer_pairs(fcn_params))
    return scores.reshape(t, p) * pair_mask.float()


class PackedSide(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("adj", "labels", "mask", "seg")]


@functools.cache
def _launcher():
    """The C entry point, its side struct checked and signature set once."""
    lib = build.library("packed_pair")
    build.check_side_struct(lib, "packed_side_size", PackedSide)
    return build.bind(lib.packed_pair_score_launch, [
        ctypes.POINTER(PackedSide), ctypes.POINTER(PackedSide),
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.POINTER(build.SimgnnParams), ctypes.c_void_p])


def packed_pair_score(adj1, labels1, mask1, seg1, adj2, labels2, mask2, seg2,
                      pair_mask, gcn_params, att_w, ntn_params, fcn_params):
    """Packed tiles (pack_pairs layout) -> [T, P] pair-slot scores. CUDA
    tensors launch `csrc/packed_pair.cu` (counted in
    `packed_pair_score.launches`); CPU tensors run the plain version."""
    args = (adj1, labels1, mask1, seg1, adj2, labels2, mask2, seg2, pair_mask)
    if not on_cuda(*args):
        return packed_pair_score_plain(*args, gcn_params, att_w, ntn_params,
                                       fcn_params)
    t, nb = mask1.shape
    p = pair_mask.shape[-1]
    out = torch.empty((t, p), dtype=torch.float32, device=mask1.device)
    if t == 0:
        return out
    fn = _launcher()
    sides = [PackedSide(
        build.checked(adj, f"adj{s + 1}", torch.float32, (t, nb, nb)),
        build.checked(lab, f"labels{s + 1}", torch.int32, (t, nb)),
        build.checked(msk, f"mask{s + 1}", torch.float32, (t, nb)),
        build.checked(seg, f"seg{s + 1}", torch.int32, (t, nb)))
        for s, (adj, lab, msk, seg) in enumerate((args[:4], args[4:8]))]
    pm = build.checked(pair_mask, "pair_mask", torch.float32, (t, p))
    params, _keep = build.simgnn_params(
        {"gcn": gcn_params, "att": {"w": att_w}, "ntn": ntn_params,
         "fcn": fcn_params}, mask1.device)
    err = fn(ctypes.byref(sides[0]), ctypes.byref(sides[1]), pm,
             out.data_ptr(), t, nb, p, ctypes.byref(params),
             torch.cuda.current_stream(mask1.device).cuda_stream)
    build.check_launch(err, "packed_pair")
    packed_pair_score.launches += 1
    return out


packed_pair_score.launches = 0
