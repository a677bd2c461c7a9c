"""Bucketed single-pass pair-score megakernel — port of
`repro.kernels.fused_pair` (DESIGN.md §7).

Per padded graph pair: in-kernel normalization, the GCN stack on dense
one-hot features, per-graph Att pooling, NTN, FCN and sigmoid, the two
sides stacked as in the Pallas body. Serves the bucketed path, the
oversize fallback (power-of-two buckets beyond 64 nodes) and calls too
small to pack.

`fused_pair_score` launches the CUDA kernel `csrc/fused_pair.cu` on CUDA
tensors (one CTA per pair; A', H and HW in shared memory while they fit,
else in a global scratch buffer allocated here) and runs
`fused_pair_score_plain` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.common import (gcn_att_block, layer_pairs,
                                        normalize_adjacency_block,
                                        ntn_fcn_block, ntn_operands)


def fused_pair_score_plain(adj1, feats1, mask1, adj2, feats2, mask2,
                           gcn_params, att_w, ntn_params, fcn_params):
    """Plain PyTorch version: [B] scores."""
    b = adj1.shape[0]
    mask = torch.cat([mask1, mask2]).float()
    a_norm = normalize_adjacency_block(torch.cat([adj1, adj2]).float(), mask)
    hg = gcn_att_block(a_norm, torch.cat([feats1, feats2]).float(), mask,
                       layer_pairs(gcn_params), att_w)
    f = hg.shape[-1]
    return ntn_fcn_block(hg[:b], hg[b:], *ntn_operands(ntn_params, f),
                         layer_pairs(fcn_params))[:, 0]


class FusedSide(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("adj", "feats", "mask")]


@functools.cache
def _launcher():
    """(scratch sizer, launch) C entry points, the side struct checked and
    signatures set once."""
    lib = build.library("fused_pair")
    build.check_side_struct(lib, "fused_side_size", FusedSide)
    need = build.bind(lib.fused_pair_scratch_floats,
                      [ctypes.c_int, ctypes.POINTER(build.SimgnnParams)],
                      restype=ctypes.c_longlong)
    launch = build.bind(lib.fused_pair_score_launch, [
        ctypes.POINTER(FusedSide), ctypes.POINTER(FusedSide),
        ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.POINTER(build.SimgnnParams), ctypes.c_void_p])
    return need, launch


def fused_pair_score(adj1, feats1, mask1, adj2, feats2, mask2, gcn_params,
                     att_w, ntn_params, fcn_params):
    """Raw adjacency / one-hot feats / masks of B padded pairs -> [B]
    scores. CUDA tensors launch `csrc/fused_pair.cu` (counted in
    `fused_pair_score.launches`); CPU tensors run the plain version."""
    args = (adj1, feats1, mask1, adj2, feats2, mask2)
    if not on_cuda(*args):
        return fused_pair_score_plain(*args, gcn_params, att_w, ntn_params,
                                      fcn_params)
    b, n, _ = adj1.shape
    f0 = feats1.shape[-1]
    out = torch.empty((b,), dtype=torch.float32, device=adj1.device)
    if b == 0:
        return out
    need, fn = _launcher()
    sides = [FusedSide(
        build.checked(adj, f"adj{s + 1}", torch.float32, (b, n, n)),
        build.checked(ft, f"feats{s + 1}", torch.float32, (b, n, f0)),
        build.checked(msk, f"mask{s + 1}", torch.float32, (b, n)))
        for s, (adj, ft, msk) in enumerate((args[:3], args[3:]))]
    params, _keep = build.simgnn_params(
        {"gcn": gcn_params, "att": {"w": att_w}, "ntn": ntn_params,
         "fcn": fcn_params}, adj1.device)
    if gcn_params[0]["w"].shape[0] != f0:
        raise ValueError(f"feats width {f0} != first GCN layer's "
                         f"{gcn_params[0]['w'].shape[0]}")
    per_pair = need(n, ctypes.byref(params))
    scratch = (torch.empty(b * per_pair, dtype=torch.float32,
                           device=adj1.device) if per_pair else None)
    err = fn(ctypes.byref(sides[0]), ctypes.byref(sides[1]), out.data_ptr(),
             b, n, f0, None if scratch is None else scratch.data_ptr(),
             ctypes.byref(params),
             torch.cuda.current_stream(adj1.device).cuda_stream)
    build.check_launch(err, "fused_pair")
    fused_pair_score.launches += 1
    return out


fused_pair_score.launches = 0
