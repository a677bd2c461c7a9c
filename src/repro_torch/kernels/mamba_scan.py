"""Selective-SSM (Mamba) scan with ZOH discretization — port of
`repro.kernels.mamba_scan`.

Per channel with state h [N]:

    a_bar_t = exp(dt_t * A)
    h       = a_bar_t * h + (dt_t * x_t) * B_t
    y_t     = h . C_t + D * x_t

`mamba_selective_scan` is the JAX entry's function (y in x's dtype, zero
initial state). `mamba_selective_scan_state` is what the model computes
(`repro.models.mamba.mamba_block`'s scan carries the state into decode): it
takes an optional initial state h0 [B, Din, N] and returns (y, h_T), y in
`out_dtype` (float32 by default). Both include D * x in y, as the TPU body
does, so a caller must not add it again. Both launch the CUDA kernel
`csrc/mamba_scan.cu` on CUDA tensors (counted in
`mamba_selective_scan_state.launches`) and run the plain versions beside
them on CPU tensors. A call that autograd records launches the same kernel
through `kernels.grad.kernel_with_plain_backward` (backward: autograd of
the plain version). The kernel takes dt and x in float32 or bfloat16 (one
dtype); the wrapper upcasts B, C, A and D to float32 (exact; they are the
small operands). The Pallas `block_t` / `block_d` policies have no
counterpart. `mamba_scan_plan` reports what a launch at given sizes runs:
its CTAs of CH channels, the time block TB, how dt/x, B/C and the state
rows are staged, and its shared memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.grad import kernel_with_plain_backward, needs_grad

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 32


def mamba_selective_scan_state_plain(dt, x, b, c, a, d, h0=None,
                                     out_dtype=torch.float32):
    """Plain PyTorch version: the sequential scan in float32, as the JAX
    oracle `mamba_selective_scan_ref` and `mamba_block`'s step. dt/x
    [B,T,Din], b/c [B,T,N], a [Din,N], d [Din], h0 [B,Din,N] or None ->
    (y [B,T,Din] in `out_dtype`, h_T [B,Din,N] float32)."""
    bsz, t, din = x.shape
    n = a.shape[-1]
    a32, d32 = a.float(), d.float()
    h = (torch.zeros((bsz, din, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    dt32, x32, b32, c32 = (z.float() for z in (dt, x, b, c))
    y = torch.empty((bsz, t, din), dtype=torch.float32, device=x.device)
    for i in range(t):
        dt_t, x_t, b_t, c_t = dt32[:, i], x32[:, i], b32[:, i], c32[:, i]
        a_bar = torch.exp(dt_t[..., None] * a32)
        h = a_bar * h + (dt_t * x_t)[..., None] * b_t[:, None, :]
        y[:, i] = torch.einsum("bdn,bn->bd", h, c_t) + d32 * x_t
    return y.to(out_dtype), h


def mamba_selective_scan_plain(dt, x, b, c, a, d):
    """Plain version of the JAX entry: -> y [B,T,Din] in x's dtype."""
    return mamba_selective_scan_state_plain(dt, x, b, c, a, d,
                                            out_dtype=x.dtype)[0]


@functools.cache
def _lib():
    lib = build.library("mamba_scan")
    build.bind(lib.mamba_scan_launch, [ctypes.c_int] + [ctypes.c_void_p] * 9
               + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    build.bind(lib.mamba_scan_plan,
               [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)])
    return lib


def mamba_scan_plan(bsz, t, din, n, dtype) -> dict:
    """What `mamba_selective_scan_state` launches for dt/x of `dtype` at
    (B, T, Din, N): CTAs, threads per CTA (one a channel: CH), the time
    block TB, how dt and x are staged ("route": "async" by cp.async,
    "plain" by plain loads), how B and C are ("bc_route"), how the state
    rows are read and written ("state_rows": "float4", or "scalar": N
    accesses a thread), dynamic shared bytes per CTA, NMAX and whether the
    instantiation for N = 16 exactly runs ("exact_n"). A launch whose base
    pointers are not 16-byte aligned takes the plain routes for them."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes float32 or bfloat16, got {dtype}")
    out = (ctypes.c_int * 10)()
    build.check_launch(_lib().mamba_scan_plan(_DTYPE_CODE[dtype], bsz, t,
                                              din, n, out), "mamba_scan_plan")
    return {"ctas": out[0], "threads": out[1], "ch": out[2], "tb": out[3],
            "route": "async" if out[4] else "plain", "smem_bytes": out[5],
            "nmax": out[6], "exact_n": bool(out[7]),
            "bc_route": "async" if out[8] else "plain",
            "state_rows": "float4" if out[9] else "scalar"}


def _shapes(dt, x, b, c, a, d, h0, out_dtype) -> tuple[int, int, int, int]:
    """(B, T, Din, N) after checking what the kernel takes."""
    if x.dim() != 3 or b.dim() != 3 or a.dim() != 2 or d.dim() != 1:
        raise ValueError(f"mamba_selective_scan takes dt/x [B,T,Din], b/c "
                         f"[B,T,N], a [Din,N], d [Din]; got ranks {x.dim()}, "
                         f"{b.dim()}, {a.dim()}, {d.dim()}")
    bsz, t, din = x.shape
    n = a.shape[-1]
    if tuple(dt.shape) != tuple(x.shape) or tuple(b.shape) != (bsz, t, n) \
            or tuple(c.shape) != (bsz, t, n) or tuple(a.shape) != (din, n) \
            or tuple(d.shape) != (din,) \
            or (h0 is not None and tuple(h0.shape) != (bsz, din, n)):
        raise ValueError(
            f"mamba_selective_scan shapes disagree: dt {tuple(dt.shape)}, x "
            f"{tuple(x.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, a "
            f"{tuple(a.shape)}, d {tuple(d.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the kernel takes N <= {MAX_N}, got N={n}")
    if x.dtype not in _DTYPE_CODE or dt.dtype != x.dtype:
        raise ValueError(f"the kernel takes dt and x in one dtype, float32 "
                         f"or bfloat16; got {dt.dtype}, {x.dtype}")
    if any(z.dtype not in _DTYPE_CODE for z in (b, c, a, d)) \
            or (h0 is not None and h0.dtype != torch.float32) \
            or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes b, c, a, d in float32 or "
                         f"bfloat16, a float32 h0 and a float32 or bfloat16 "
                         f"output; got {b.dtype}, {c.dtype}, {a.dtype}, "
                         f"{d.dtype}, {None if h0 is None else h0.dtype}, "
                         f"{out_dtype}")
    return bsz, t, din, n


def mamba_selective_scan_state(dt, x, b, c, a, d, h0=None,
                               out_dtype=torch.float32):
    """dt/x [B,T,Din], b/c [B,T,N], a [Din,N] (negative), d [Din], h0
    [B,Din,N] float32 or None (zeros) -> (y [B,T,Din] in `out_dtype`, D*x
    included; h_T [B,Din,N] float32). CUDA tensors launch
    `csrc/mamba_scan.cu` (counted in `mamba_selective_scan_state.launches`);
    CPU tensors run `mamba_selective_scan_state_plain`."""
    tensors = (dt, x, b, c, a, d) + (() if h0 is None else (h0,))
    if not on_cuda(*tensors):
        return mamba_selective_scan_state_plain(dt, x, b, c, a, d, h0,
                                                out_dtype)
    if needs_grad(*tensors):
        return kernel_with_plain_backward(
            lambda *z: mamba_selective_scan_state(*z, out_dtype=out_dtype),
            lambda *z: mamba_selective_scan_state_plain(
                *z, out_dtype=out_dtype), dt, x, b, c, a, d, h0)
    bsz, t, din, n = _shapes(dt, x, b, c, a, d, h0, out_dtype)
    b, c, a, d = (z.float() for z in (b, c, a, d))
    y = torch.empty((bsz, t, din), dtype=torch.float32, device=x.device)
    h_t = torch.empty((bsz, din, n), dtype=torch.float32, device=x.device)
    if t == 0 or bsz * din == 0:      # nothing to scan: the state passes
        return y.to(out_dtype), (h_t.zero_() if h0 is None else h_t.copy_(h0))
    f32 = torch.float32
    ptrs = [build.checked(z, name, want, shape) for z, name, want, shape in (
        (dt, "dt", x.dtype, (bsz, t, din)), (x, "x", x.dtype, (bsz, t, din)),
        (b, "b", f32, (bsz, t, n)), (c, "c", f32, (bsz, t, n)),
        (a, "a", f32, (din, n)), (d, "d", f32, (din,)))]
    h0_ptr = None if h0 is None else build.checked(h0, "h0", f32,
                                                   (bsz, din, n))
    err = _lib().mamba_scan_launch(
        _DTYPE_CODE[x.dtype], *ptrs, h0_ptr, y.data_ptr(), h_t.data_ptr(),
        bsz, t, din, n, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(err, "mamba_selective_scan")
    mamba_selective_scan_state.launches += 1
    return y.to(out_dtype), h_t


mamba_selective_scan_state.launches = 0


def mamba_selective_scan(dt, x, b, c, a, d):
    """The JAX entry: -> y [B,T,Din] in x's dtype, from a zero state (one
    `mamba_selective_scan_state` launch on the card)."""
    return mamba_selective_scan_state(dt, x, b, c, a, d,
                                      out_dtype=x.dtype)[0]
