"""RWKV-6 (Finch) WKV recurrence — port of `repro.kernels.wkv6`.

Per head with key dim K and value dim V, data-dependent per-channel decay:

    o_t = r_t^T S_{t-1}  +  (r_t . (u * k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

`wkv6` is the JAX entry's function (o in r's dtype, zero initial state).
`wkv6_state` is what the model computes (`repro.models.rwkv6.wkv_scan`
returns the final state too, and decode carries it): it takes an optional
initial state s0 [B, H, K, V] and returns (o, s_T), o in `out_dtype`
(float32 by default, as `wkv_scan`). Both launch the CUDA kernel
`csrc/wkv6.cu` on CUDA tensors (counted in `wkv6_state.launches`) and run
the plain versions beside them on CPU tensors. A call that autograd
records launches the same kernel through `kernels.grad.
kernel_with_plain_backward` (backward: autograd of the plain version; a
loss that reads only o gives s_T no gradient). The kernel takes r, k, v in
float32 or bfloat16 (one dtype) and w, u in float32; the wrapper upcasts a
bfloat16 w or u (exact) and rounds o to bfloat16 when asked (one rounding,
as the TPU body). The Pallas `block_t` policy has no counterpart: T is taken
unpadded. `wkv6_plan` reports what a launch at given sizes runs: its grid
(heads times column blocks of VB value columns), block, time block TB,
how the rows are staged (cp.async or plain loads) and its shared memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.grad import kernel_with_plain_backward, needs_grad

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_K = 128
MAX_V = 256


def wkv6_state_plain(r, k, v, w, u, s0=None, out_dtype=torch.float32):
    """Plain PyTorch version: the sequential recurrence in float32, as
    `repro.models.rwkv6.wkv_scan`. r/k/w [B,T,H,K], v [B,T,H,V], u [H,K],
    s0 [B,H,K,V] or None (zeros) -> (o [B,T,H,V] in `out_dtype`,
    s_T [B,H,K,V] float32)."""
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    s = (torch.zeros((b, h, kd, vd), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    r32, k32, v32, w32 = (a.float() for a in (r, k, v, w))
    u32 = u.float()
    o = torch.empty((b, t, h, vd), dtype=torch.float32, device=r.device)
    for i in range(t):
        rt, kt, vt, wt = r32[:, i], k32[:, i], v32[:, i], w32[:, i]
        o[:, i] = torch.einsum("bhk,bhkv->bhv", rt, s) \
            + torch.sum(rt * u32 * kt, -1, keepdim=True) * vt
        s = wt[..., None] * s + kt[..., None] * vt[..., None, :]
    return o.to(out_dtype), s


def wkv6_plain(r, k, v, w, u):
    """Plain version of the JAX entry: r/k/w [B,T,H,K], v [B,T,H,V],
    u [H,K] -> o [B,T,H,V] in r's dtype."""
    return wkv6_state_plain(r, k, v, w, u, out_dtype=r.dtype)[0]


@functools.cache
def _lib():
    lib = build.library("wkv6")
    build.bind(lib.wkv6_launch, [ctypes.c_int] + [ctypes.c_void_p] * 8
               + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    build.bind(lib.wkv6_plan,
               [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])
    return lib


def wkv6_plan(b, t, h, kd, vd, dtype) -> dict:
    """What `wkv6_state` launches for r/k/v of `dtype` at (B, T, H, K, V):
    CTAs, threads per CTA, the time block TB, the value columns VB of a
    CTA and those of a thread, the staging route ("async": cp.async,
    "plain": plain loads; a launch whose base pointers are not 16-byte
    aligned also takes plain loads), dynamic shared bytes per CTA and the
    padded key width KMAX."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes float32 or bfloat16, got {dtype}")
    out = (ctypes.c_int * 8)()
    build.check_launch(_lib().wkv6_plan(_DTYPE_CODE[dtype], b, t, h, kd, vd,
                                        out), "wkv6_plan")
    return {"ctas": out[0], "threads": out[1], "tb": out[2], "vb": out[3],
            "route": "async" if out[4] else "plain", "smem_bytes": out[5],
            "kmax": out[6], "cols_per_thread": out[7]}


def _shapes(r, k, v, w, u, s0, out_dtype) -> tuple[int, int, int, int, int]:
    """(B, T, H, K, V) after checking what the kernel takes."""
    if r.dim() != 4 or v.dim() != 4 or u.dim() != 2:
        raise ValueError(f"wkv6 takes r/k/w [B,T,H,K], v [B,T,H,V], u [H,K];"
                         f" got ranks {r.dim()}, {v.dim()}, {u.dim()}")
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    if tuple(k.shape) != tuple(r.shape) or tuple(w.shape) != tuple(r.shape) \
            or tuple(v.shape[:3]) != (b, t, h) or tuple(u.shape) != (h, kd) \
            or (s0 is not None and tuple(s0.shape) != (b, h, kd, vd)):
        raise ValueError(
            f"wkv6 shapes disagree: r {tuple(r.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}, "
            f"s0 {None if s0 is None else tuple(s0.shape)}")
    if not (1 <= kd <= MAX_K and 1 <= vd <= MAX_V):
        raise ValueError(f"the kernel takes K <= {MAX_K} and V <= {MAX_V}, "
                         f"got K={kd}, V={vd}")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise ValueError(f"the kernel takes r, k, v in one dtype, float32 or "
                         f"bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype not in _DTYPE_CODE or u.dtype not in _DTYPE_CODE \
            or (s0 is not None and s0.dtype != torch.float32) \
            or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes w and u in float32 or bfloat16, "
                         f"a float32 s0 and a float32 or bfloat16 output; got "
                         f"{w.dtype}, {u.dtype}, "
                         f"{None if s0 is None else s0.dtype}, {out_dtype}")
    return b, t, h, kd, vd


def wkv6_state(r, k, v, w, u, s0=None, out_dtype=torch.float32):
    """r/k/w [B,T,H,K], v [B,T,H,V], u [H,K], s0 [B,H,K,V] float32 or None
    (zeros) -> (o [B,T,H,V] in `out_dtype`, s_T [B,H,K,V] float32). CUDA
    tensors launch `csrc/wkv6.cu` (counted in `wkv6_state.launches`); CPU
    tensors run `wkv6_state_plain`."""
    tensors = (r, k, v, w, u) + (() if s0 is None else (s0,))
    if not on_cuda(*tensors):
        return wkv6_state_plain(r, k, v, w, u, s0, out_dtype)
    if needs_grad(*tensors):
        return kernel_with_plain_backward(
            lambda *a: wkv6_state(*a, out_dtype=out_dtype),
            lambda *a: wkv6_state_plain(*a, out_dtype=out_dtype),
            r, k, v, w, u, s0)
    b, t, h, kd, vd = _shapes(r, k, v, w, u, s0, out_dtype)
    w, u = w.float(), u.float()
    o = torch.empty((b, t, h, vd), dtype=torch.float32, device=r.device)
    s_t = torch.empty((b, h, kd, vd), dtype=torch.float32, device=r.device)
    if t == 0 or b * h == 0:          # nothing to scan: the state passes
        return o.to(out_dtype), (s_t.zero_() if s0 is None else s_t.copy_(s0))
    dt = r.dtype
    ptrs = [build.checked(x, name, want, shape) for x, name, want, shape in (
        (r, "r", dt, (b, t, h, kd)), (k, "k", dt, (b, t, h, kd)),
        (v, "v", dt, (b, t, h, vd)), (w, "w", torch.float32, (b, t, h, kd)),
        (u, "u", torch.float32, (h, kd)))]
    s0_ptr = None if s0 is None else build.checked(
        s0, "s0", torch.float32, (b, h, kd, vd))
    err = _lib().wkv6_launch(
        _DTYPE_CODE[dt], *ptrs, s0_ptr, o.data_ptr(), s_t.data_ptr(), b, t,
        h, kd, vd, torch.cuda.current_stream(r.device).cuda_stream)
    build.check_launch(err, "wkv6")
    wkv6_state.launches += 1
    return o.to(out_dtype), s_t


wkv6_state.launches = 0


def wkv6(r, k, v, w, u):
    """The JAX entry: r/k/w [B,T,H,K], v [B,T,H,V], u [H,K] -> o [B,T,H,V]
    in r's dtype, from a zero state (one `wkv6_state` launch on the card)."""
    return wkv6_state(r, k, v, w, u, out_dtype=r.dtype)[0]
