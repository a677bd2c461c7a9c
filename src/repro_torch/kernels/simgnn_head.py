"""Fused NTN + FCN head on graph-embedding pairs — port of
`repro.kernels.simgnn_head`.

hg1/hg2 [B, F] -> [B] similarity scores in (0, 1): the K bilinear NTN
slices, the linear term, ReLU, the FCN stack and the sigmoid. The whole
per-query device cost of a warm exact 1-vs-N search, and the rerank of the
two-stage search.

`simgnn_head` launches the CUDA kernel `csrc/simgnn_head.cu` on CUDA
tensors (one warp per pair, any B: the JAX wrapper's `block_pairs`
padding has no counterpart) and runs `simgnn_head_plain` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.common import layer_pairs, ntn_fcn_block, ntn_operands


def simgnn_head_plain(hg1, hg2, ntn_params, fcn_params):
    """Plain PyTorch version: [B] scores."""
    f = hg1.shape[-1]
    return ntn_fcn_block(hg1.float(), hg2.float(), *ntn_operands(ntn_params, f),
                         layer_pairs(fcn_params))[:, 0]


@functools.cache
def _launcher():
    lib = build.library("simgnn_head")
    return build.bind(lib.simgnn_head_launch, [
        ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                ctypes.POINTER(build.SimgnnParams),
                                ctypes.c_void_p])


def simgnn_head(hg1, hg2, ntn_params, fcn_params):
    """hg1/hg2 [B, F] graph embeddings -> [B] scores. CUDA tensors launch
    `csrc/simgnn_head.cu` (counted in `simgnn_head.launches`); CPU tensors
    run the plain version."""
    if not on_cuda(hg1, hg2):
        return simgnn_head_plain(hg1, hg2, ntn_params, fcn_params)
    b, f = hg1.shape
    if ntn_params["w"].shape[-1] != f:
        raise ValueError(f"embedding width {f} != the NTN's "
                         f"{ntn_params['w'].shape[-1]}")
    out = torch.empty((b,), dtype=torch.float32, device=hg1.device)
    if b == 0:
        return out
    p1 = build.checked(hg1, "hg1", torch.float32, (b, f))
    p2 = build.checked(hg2, "hg2", torch.float32, (b, f))
    params, _keep = build.simgnn_params(
        {"ntn": ntn_params, "fcn": fcn_params}, hg1.device)
    err = _launcher()(p1, p2, out.data_ptr(), b, ctypes.byref(params),
                      torch.cuda.current_stream(hg1.device).cuda_stream)
    build.check_launch(err, "simgnn_head")
    simgnn_head.launches += 1
    return out


simgnn_head.launches = 0
