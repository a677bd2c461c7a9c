"""Online-softmax GQA attention — causal, sliding-window, softcap — port of
`repro.kernels.flash_attn`.

`flash_attention(q, k, v, causal=, window=, softcap=)` takes q [B,T,H,D]
and k/v [B,S,KV,D] with H % KV == 0 and returns [B,T,H,D] in q's dtype,
float32 inside. The masks index both axes from 0: a query row t sees kv
row s when s <= t (causal) and t - s < window, also when T != S (not the
bottom-right alignment of common FlashAttention libraries). A row that
sees nothing gives 0.

CUDA tensors launch a kernel of `csrc/flash_attn.cu` (counted in
`flash_attention.launches`): bfloat16 inputs the tensor-core kernel
(wgmma, P split into two bf16 terms), float32 inputs the FMA body;
`flash_attention_plan` says which. A call that autograd records (grad
enabled, an input requiring grad) launches the same kernel through
`kernels.grad.kernel_with_plain_backward`: its backward is autograd of the
plain version. CPU tensors run
`flash_attention_plain`, the JAX oracle `flash_attention_ref`'s dense
softmax. The Pallas `block_q` / `block_kv` policies have no counterpart:
T and S are taken unpadded. The kernels take float32 or bfloat16 (one
dtype for q, k, v) and D <= 256.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.grad import kernel_with_plain_backward, needs_grad

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 256
#: the plain version scores at most this many (head, query, kv) entries at
#: once, one block of query rows after another (rows are independent)
_PLAIN_CELLS = 1 << 28


def flash_attention_plain(q, k, v, *, causal=True, window=None,
                          softcap=None):
    """Plain PyTorch version: dense masked softmax in float32 over blocks
    of query rows, as the JAX oracle. q [B,T,H,D], k/v [B,S,KV,D] ->
    [B,T,H,D] in q's dtype."""
    b, t, h, d = q.shape
    s_len, kv = k.shape[1], k.shape[2]
    group = h // kv
    k32 = k.float().repeat_interleave(group, dim=2)
    v32 = v.float().repeat_interleave(group, dim=2)
    kv_pos = torch.arange(s_len, device=q.device)[None, :]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rows = max(1, _PLAIN_CELLS // max(1, b * h * s_len))
    for t0 in range(0, t, rows):
        qb = q[:, t0:t0 + rows].float()
        s = torch.einsum("bthd,bshd->bhts", qb, k32) * (d ** -0.5)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        q_pos = torch.arange(t0, t0 + qb.shape[1], device=q.device)[:, None]
        mask = torch.ones((qb.shape[1], s_len), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kv_pos <= q_pos
        if window is not None:
            mask &= (q_pos - kv_pos) < window
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        p = torch.where(mask, p, 0.0)
        out[:, t0:t0 + rows] = torch.einsum("bhts,bshd->bthd", p,
                                            v32).to(q.dtype)
    return out


@functools.cache
def _lib():
    lib = build.library("flash_attn")
    build.bind(lib.flash_attn_launch,
               [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
               + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_float]
               + [ctypes.c_void_p])
    build.bind(lib.flash_attn_plan,
               [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)])
    return lib


def _shapes(q, k, v) -> tuple[int, int, int, int, int, int]:
    """(B, T, S, H, KV, D) after checking what the kernel takes."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes q [B,T,H,D] and k/v "
                         f"[B,S,KV,D]; got ranks {q.dim()}, {k.dim()}, "
                         f"{v.dim()}")
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b \
            or k.shape[3] != d or kv == 0 or h % kv:
        raise ValueError(f"flash_attention shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} (H % KV must be 0)")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the kernel takes D <= {MAX_D}, got D={d}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes q, k, v in one dtype, float32 or "
                         f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    return b, t, s, h, kv, d


def flash_attention_plan(q, k, v) -> dict:
    """What a call on these CUDA tensors launches: the path ("wgmma" for
    bfloat16, "fma" for float32), its kernel, the padded head width DP,
    CTAs, threads and shared bytes per CTA."""
    b, t, _, h, _, d = _shapes(q, k, v)
    out = (ctypes.c_int * 5)()
    build.check_launch(_lib().flash_attn_plan(_DTYPE_CODE[q.dtype], b, t, h,
                                              d, out), "flash_attn_plan")
    return {"path": "wgmma" if out[0] else "fma",
            "kernel": ("flash_attn_wgmma_kernel" if out[0]
                       else "flash_attn_kernel"),
            "dp": out[1], "ctas": out[2], "threads": out[3],
            "smem_bytes": out[4]}


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None):
    """q [B,T,H,D], k/v [B,S,KV,D] -> [B,T,H,D] in q's dtype. CUDA tensors
    launch a kernel of `csrc/flash_attn.cu` (counted in
    `flash_attention.launches`); CPU tensors run `flash_attention_plain`."""
    if not on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    if needs_grad(q, k, v):
        opts = dict(causal=causal, window=window, softcap=softcap)
        return kernel_with_plain_backward(
            lambda *a: flash_attention(*a, **opts),
            lambda *a: flash_attention_plain(*a, **opts), q, k, v)
    b, t, s, h, kv, d = _shapes(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if s == 0:                            # every row sees nothing
        return out.zero_()
    ptrs = [build.checked(x, name, q.dtype, shape) for x, name, shape in (
        (q, "q", (b, t, h, d)), (k, "k", (b, s, kv, d)),
        (v, "v", (b, s, kv, d)))]
    err = _lib().flash_attn_launch(
        _DTYPE_CODE[q.dtype], *ptrs, out.data_ptr(), b, t, s, h, kv, d,
        d ** -0.5, int(causal), int(window is not None),
        0 if window is None else int(window), int(softcap is not None),
        0.0 if softcap is None else float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
