"""Fused GCN stack + Att pooling (graph embeddings) — port of
`repro.kernels.fused_gcn`.

Per padded graph: every GCN layer on the pre-normalised A' (layer 0 a dense
product on the one-hot features, as the Pallas body computes it), then the
Att pooling; [B, F_last] embeddings out. Serves the embedding cache's
embed stage, the search index and the `two_kernel` path's first stage.

`fused_gcn_att` launches the CUDA kernel `csrc/fused_gcn.cu` on CUDA
tensors (one CTA per graph, any B; A', H and HW in shared memory while
they fit, else in a global scratch buffer allocated here) and runs
`fused_gcn_att_plain` on CPU tensors. On the card a graph's embedding is
the same bits whatever its batch companions and bucket width.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.common import gcn_att_block, layer_pairs


def fused_gcn_att_plain(adj_norm, feats, mask, gcn_params, att_w):
    """Plain PyTorch version: [B, F_last] embeddings."""
    return gcn_att_block(adj_norm.float(), feats.float(), mask.float(),
                         layer_pairs(gcn_params), att_w)


@functools.cache
def _launcher():
    """(scratch sizer, launch) C entry points, signatures set once."""
    lib = build.library("fused_gcn")
    need = build.bind(lib.fused_gcn_scratch_floats,
                      [ctypes.c_int, ctypes.POINTER(build.SimgnnParams)],
                      restype=ctypes.c_longlong)
    launch = build.bind(lib.fused_gcn_launch, [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p,
                             ctypes.POINTER(build.SimgnnParams),
                             ctypes.c_void_p])
    return need, launch


def fused_gcn_att(adj_norm, feats, mask, gcn_params, att_w):
    """Pre-normalised A' [B, N, N], one-hot feats [B, N, F0], mask [B, N]
    -> [B, F_last] graph embeddings. CUDA tensors launch
    `csrc/fused_gcn.cu` (counted in `fused_gcn_att.launches`); CPU tensors
    run the plain version."""
    if not on_cuda(adj_norm, feats, mask):
        return fused_gcn_att_plain(adj_norm, feats, mask, gcn_params, att_w)
    b, n, _ = adj_norm.shape
    f0 = feats.shape[-1]
    if gcn_params[0]["w"].shape[0] != f0:
        raise ValueError(f"feats width {f0} != first GCN layer's "
                         f"{gcn_params[0]['w'].shape[0]}")
    f = gcn_params[-1]["w"].shape[1]
    out = torch.empty((b, f), dtype=torch.float32, device=adj_norm.device)
    if b == 0:
        return out
    ptrs = (build.checked(adj_norm, "adj_norm", torch.float32, (b, n, n)),
            build.checked(feats, "feats", torch.float32, (b, n, f0)),
            build.checked(mask, "mask", torch.float32, (b, n)))
    params, _keep = build.simgnn_params(
        {"gcn": gcn_params, "att": {"w": att_w}}, adj_norm.device)
    need, fn = _launcher()
    per_graph = need(n, ctypes.byref(params))
    scratch = (torch.empty(b * per_graph, dtype=torch.float32,
                           device=adj_norm.device) if per_graph else None)
    err = fn(*ptrs, out.data_ptr(), b, n, f0,
             None if scratch is None else scratch.data_ptr(),
             ctypes.byref(params),
             torch.cuda.current_stream(adj_norm.device).cuda_stream)
    build.check_launch(err, "fused_gcn")
    fused_gcn_att.launches += 1
    return out


fused_gcn_att.launches = 0
