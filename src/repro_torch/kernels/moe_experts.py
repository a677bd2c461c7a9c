"""Fused MoE expert FFN — port of `repro.kernels.moe_experts`.

Per expert e: h = x @ W_in[e] in float32, SwiGLU (gate = the first F
columns, up = the last F), y = h @ W_out[e] in float32, y rounded once to
x's dtype.

`moe_expert_ffn` launches the CUDA kernels of `csrc/moe_experts.cu` on
CUDA tensors and runs `moe_expert_ffn_plain` on CPU tensors: float32
inputs take the FMA body (one launch, the hidden activations never in
device memory), bfloat16 inputs the tensor-core kernels (two launches, the
up-projection with SwiGLU, then the down-projection, h between them as
three bf16 planes in scratch this wrapper allocates). Either way one call
counts one in `moe_expert_ffn.launches`; `moe_expert_ffn_plan` says what a
call launches. A call that autograd records launches the same kernels
through `kernels.grad.kernel_with_plain_backward` (backward: autograd of
the plain version).

x is the dispatch buffer [E, C, D] of one sequence, as the JAX kernel
takes it, or [B, E, C, D] for a whole batch: the JAX model vmaps the
kernel over B, the port launches it once for the batch. C is taken
unpadded (the Pallas `block_c` padding has no counterpart).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.grad import kernel_with_plain_backward, needs_grad

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def moe_expert_ffn_plain(x, w_in, w_out):
    """Plain PyTorch version: x [..., E, C, D], w_in [E, D, 2F],
    w_out [E, F, D] -> [..., E, C, D] in x's dtype, float32 inside."""
    h = torch.einsum("...ecd,edf->...ecf", x.float(), w_in.float())
    gate, up = h.chunk(2, dim=-1)
    h = gate * torch.sigmoid(gate) * up
    y = torch.einsum("...ecf,efd->...ecd", h, w_out.float())
    return y.to(x.dtype)


@functools.cache
def _lib():
    lib = build.library("moe_experts")
    build.bind(lib.moe_expert_ffn_plan,
               [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])
    build.bind(lib.moe_expert_ffn_launch,
               [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
               + [ctypes.c_void_p])
    return lib


def _shapes(x, w_in, w_out) -> tuple[int, int, int, int, int]:
    """(B, E, C, D, F) after checking what the kernel takes."""
    if x.dim() not in (3, 4) or w_in.dim() != 3 or w_out.dim() != 3:
        raise ValueError(f"moe_expert_ffn takes x [E, C, D] or [B, E, C, D], "
                         f"w_in [E, D, 2F], w_out [E, F, D]; got ranks "
                         f"{x.dim()}, {w_in.dim()}, {w_out.dim()}")
    e, d, f2 = w_in.shape
    f = f2 // 2
    b = x.shape[0] if x.dim() == 4 else 1
    if x.shape[-3] != e or x.shape[-1] != d or f2 != 2 * f \
            or tuple(w_out.shape) != (e, f, d):
        raise ValueError(f"moe_expert_ffn shapes disagree: x {tuple(x.shape)},"
                         f" w_in {tuple(w_in.shape)}, w_out "
                         f"{tuple(w_out.shape)}")
    if d % 4 or f % 4:
        raise ValueError(f"the kernel takes D and F that are multiples of 4, "
                         f"got D={d}, F={f}")
    if x.dtype not in _DTYPE_CODE or w_in.dtype != x.dtype \
            or w_out.dtype != x.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16, one dtype "
                         f"for x and both weights; got {x.dtype}, "
                         f"{w_in.dtype}, {w_out.dtype}")
    return b, e, x.shape[-2], d, f


def moe_expert_ffn_plan(x, w_in, w_out) -> dict:
    """What a call on these CUDA tensors launches: the path ("wgmma" for
    bfloat16, "fma" for float32), whether the bf16 tiles are swapped
    (weights in wgmma's M slot, at most 32 token rows in N), and per
    launch its kernel, tile (token rows, columns; for the FMA body its
    rows per CTA and D), CTAs and shared bytes per CTA."""
    b, e, c, d, f = _shapes(x, w_in, w_out)
    out = (ctypes.c_int * 11)()
    build.check_launch(_lib().moe_expert_ffn_plan(
        _DTYPE_CODE[x.dtype], b, e, c, d, f, out), "moe_expert_ffn_plan")
    names = (("moe_up_wgmma_kernel", "moe_down_wgmma_kernel") if out[0]
             else ("moe_expert_ffn_kernel",))
    return {"path": "wgmma" if out[0] else "fma", "swapped": bool(out[1]),
            "launches": [{"kernel": names[i],
                          "tile": (out[3 + 4 * i], out[4 + 4 * i]),
                          "ctas": out[5 + 4 * i],
                          "smem_bytes": out[6 + 4 * i]}
                         for i in range(out[2])]}


def moe_expert_ffn(x, w_in, w_out):
    """x [E, C, D] or [B, E, C, D], w_in [E, D, 2F], w_out [E, F, D] ->
    y with x's shape and dtype. CUDA tensors launch `csrc/moe_experts.cu`
    (one count in `moe_expert_ffn.launches` per call); CPU tensors run the
    plain version."""
    if not on_cuda(x, w_in, w_out):
        return moe_expert_ffn_plain(x, w_in, w_out)
    if needs_grad(x, w_in, w_out):
        return kernel_with_plain_backward(moe_expert_ffn,
                                          moe_expert_ffn_plain,
                                          x, w_in, w_out)
    b, e, c, d, f = _shapes(x, w_in, w_out)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if y.numel() == 0:
        return y
    shape = tuple(x.shape)
    ptrs = [build.checked(t, name, x.dtype, s) for t, name, s in (
        (x, "x", shape), (w_in, "w_in", (e, d, 2 * f)),
        (w_out, "w_out", (e, f, d)))]
    h3 = (torch.empty((3, e, b * c, f), dtype=x.dtype, device=x.device)
          if x.dtype == torch.bfloat16 else None)
    err = _lib().moe_expert_ffn_launch(
        _DTYPE_CODE[x.dtype], *ptrs, y.data_ptr(),
        None if h3 is None else h3.data_ptr(), b, e, c, d, f,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(err, "moe_expert_ffn")
    moe_expert_ffn.launches += 1
    return y


moe_expert_ffn.launches = 0
