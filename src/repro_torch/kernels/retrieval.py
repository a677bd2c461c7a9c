"""Blocked streaming top-M retrieval prefilter — port of
`repro.kernels.retrieval` (DESIGN.md §14).

The two-stage query path (`serve/search.py`) shortlists M candidates per
query with a cheap embedding-space proxy before the exact NTN+FCN rerank.
Two scans, each returning `(scores [Q, M] float32, indices [Q, M] int32)`,
rows ordered by (-score, ascending corpus index):

  * `blocked_topm` — a dot product of [Q, F] query vectors (raw, or the
    calibrated `prefilter_query_vectors`) with every corpus row;
  * `blocked_topm_ntn` — the exact pre-sigmoid NTN+FCN logit per corpus row
    from the collapsed query operands of `collapse_query_ntn`.

Both launch the CUDA kernels of `csrc/retrieval.cu` on CUDA tensors
(column blocks scored and sorted in parallel, then merged per query; the
selection and merge run in the kernel) and their plain versions on CPU
tensors. The plain versions materialise the [Q, N] score matrix and rank
it with an explicit stable (-score, index) sort; the kernels never do.
Non-finite scores become `NEG_FILL`, so NaN rows (dropped embeddings) rank
last but never surface as NaN; M is clamped to N; Q = 0 or N = 0 gives
empty results; a `block_cols` beyond `RETRIEVAL_MAX_BLOCK_COLS` raises.

The numpy helpers (`retrieval_block_cols`, `collapse_query_ntn`,
`topm_reference`, `ntn_logit_reference`, `fit_prefilter_calibration`,
`prefilter_query_vectors`) are copies of the JAX package's.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.common import layer_pairs

__all__ = ["RETRIEVAL_MAX_BLOCK_COLS", "NEG_FILL", "retrieval_block_cols",
           "blocked_topm", "blocked_topm_ntn", "blocked_topm_plain",
           "blocked_topm_ntn_plain", "collapse_query_ntn", "topm_reference",
           "ntn_logit_reference", "fit_prefilter_calibration",
           "prefilter_query_vectors"]

#: Hard ceiling on corpus rows per streamed block — the guard that keeps
#: the scan from materialising [Q, N].
RETRIEVAL_MAX_BLOCK_COLS = 1024

#: Finite sentinel for non-finite proxy scores: NaN rows rank last among
#: real rows, and still outrank the -inf pad columns and init slots.
NEG_FILL = float(np.float32(-3.0e38))

#: widest embedding the CUDA scans take (TOPM_FMAX in csrc/retrieval.cu).
MAX_FEAT = 64


def retrieval_block_cols(n_corpus: int, *,
                         shard_rows: int | None = None) -> int:
    """Corpus-column block size for the scans: the persisted shard size
    when given (halved while it exceeds the ceiling), else the corpus
    rounded up to a power of two, capped at `RETRIEVAL_MAX_BLOCK_COLS`."""
    if n_corpus < 1:
        raise ValueError(f"n_corpus must be >= 1, got {n_corpus}")
    if shard_rows is not None and shard_rows >= 1:
        b = int(shard_rows)
        while b > RETRIEVAL_MAX_BLOCK_COLS and b % 2 == 0:
            b //= 2
        return min(b, RETRIEVAL_MAX_BLOCK_COLS)
    b = 8
    while b < n_corpus and b < RETRIEVAL_MAX_BLOCK_COLS:
        b *= 2
    return b


def _scan_args(q: int, n: int, m: int,
               block_cols: int | None) -> tuple[int, int] | None:
    """Shared clamp/guard policy of both scans: (m, block_cols), or None
    for an empty scan."""
    if q == 0 or n == 0:
        return None
    if block_cols is None:
        block_cols = retrieval_block_cols(n)
    if block_cols > RETRIEVAL_MAX_BLOCK_COLS:
        raise ValueError(
            f"block_cols={block_cols} exceeds RETRIEVAL_MAX_BLOCK_COLS="
            f"{RETRIEVAL_MAX_BLOCK_COLS}: a block that wide materializes "
            "the score matrix the streaming scan exists to avoid")
    if block_cols < 1:
        raise ValueError(f"block_cols must be >= 1, got {block_cols}")
    return int(max(1, min(m, n))), int(block_cols)


def _empty(q: int, like: torch.Tensor):
    return (torch.zeros((q, 0), dtype=torch.float32, device=like.device),
            torch.zeros((q, 0), dtype=torch.int32, device=like.device))


def _rank_plain(s: torch.Tensor, m: int):
    """Top-m of a [Q, N] score matrix by (-score, ascending index)."""
    s = torch.where(torch.isfinite(s), s, torch.full_like(s, NEG_FILL))
    order = torch.argsort(-s, dim=1, stable=True)[:, :m]
    return torch.take_along_dim(s, order, dim=1), order.to(torch.int32)


def blocked_topm_plain(qv, corpus, m: int):
    """Plain PyTorch version of the dot scan (m already clamped)."""
    return _rank_plain(qv.float() @ corpus.float().T, m)


def blocked_topm_ntn_plain(uq, dq, corpus, fcn_params, m: int):
    """Plain PyTorch version of the NTN+FCN logit scan."""
    q, (n, f) = uq.shape[0], corpus.shape
    k = dq.shape[1]
    x = torch.einsum("qkf,nf->qnk", uq.float().reshape(q, k, f),
                     corpus.float()) + dq.float()[:, None, :]
    x = torch.relu(x)
    layers = layer_pairs(fcn_params)
    for li, (w, b) in enumerate(layers):
        x = x @ w.float() + b.float()
        if li + 1 < len(layers):
            x = torch.relu(x)
    return _rank_plain(x[..., 0], m)


@functools.cache
def _launchers():
    """(dot launch, NTN launch) C entry points, signatures set once."""
    lib = build.library("retrieval")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dot = build.bind(lib.topm_dot_launch,
                     [ptr, ptr] + [i32] * 5 + [ptr] * 5)
    ntn = build.bind(lib.topm_ntn_launch,
                     [ptr] * 3 + [i32] * 6 + [ptr] * 4
                     + [ctypes.POINTER(build.SimgnnParams), ptr])
    return dot, ntn


def _scan_buffers(q: int, n: int, m: int, block_cols: int, device):
    """Per-block key lists [Q, blocks, min(M, block_cols)] and the outputs."""
    entries = q * -(-n // block_cols) * min(m, block_cols)
    return (torch.empty(entries, dtype=torch.float32, device=device),
            torch.empty(entries, dtype=torch.int32, device=device),
            torch.empty((q, m), dtype=torch.float32, device=device),
            torch.empty((q, m), dtype=torch.int32, device=device))


def _check_feat(f: int):
    if f > MAX_FEAT:
        raise ValueError(f"the top-M kernels take embeddings up to "
                         f"{MAX_FEAT} wide, got {f}")


def blocked_topm(qv, corpus, m: int, *, block_cols: int | None = None):
    """Streaming top-M dot-product scan: qv [Q, F] against corpus [N, F]
    -> (scores [Q, M], indices [Q, M] int32), scores descending. CUDA
    tensors launch `csrc/retrieval.cu` (counted in
    `blocked_topm.launches`); CPU tensors run the plain version."""
    if qv.ndim != 2 or corpus.ndim != 2 or qv.shape[1] != corpus.shape[1]:
        raise ValueError(f"shape mismatch: qv {tuple(qv.shape)} vs corpus "
                         f"{tuple(corpus.shape)}")
    (q, f), n = qv.shape, corpus.shape[0]
    args = _scan_args(q, n, m, block_cols)
    if args is None:
        return _empty(q, qv)
    m, block_cols = args
    if not on_cuda(qv, corpus):
        return blocked_topm_plain(qv, corpus, m)
    _check_feat(f)
    pq = build.checked(qv, "qv", torch.float32, (q, f))
    pc = build.checked(corpus, "corpus", torch.float32, (n, f))
    ps, pi, out_s, out_i = _scan_buffers(q, n, m, block_cols, qv.device)
    err = _launchers()[0](
        pq, pc, q, n, f, block_cols, m, ps.data_ptr(), pi.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(qv.device).cuda_stream)
    build.check_launch(err, "topm")
    blocked_topm.launches += 1
    return out_s, out_i


def blocked_topm_ntn(uq, dq, corpus, fcn_params, m: int, *,
                     block_cols: int | None = None):
    """Exact streamed NTN+FCN top-M scan: `(uq [Q, K*F], dq [Q, K])` from
    `collapse_query_ntn` against corpus [N, F] -> (pre-sigmoid logits
    [Q, M], indices [Q, M] int32). CUDA tensors launch
    `csrc/retrieval.cu` (counted in `blocked_topm_ntn.launches`); CPU
    tensors run the plain version."""
    if uq.ndim != 2 or dq.ndim != 2 or corpus.ndim != 2 \
            or uq.shape[1] != dq.shape[1] * corpus.shape[1] \
            or uq.shape[0] != dq.shape[0]:
        raise ValueError(f"uq {tuple(uq.shape)} is not [Q, K*F] for dq "
                         f"{tuple(dq.shape)} and corpus "
                         f"{tuple(corpus.shape)}")
    (q, k), (n, f) = dq.shape, corpus.shape
    args = _scan_args(q, n, m, block_cols)
    if args is None:
        return _empty(q, uq)
    m, block_cols = args
    if not on_cuda(uq, dq, corpus):
        return blocked_topm_ntn_plain(uq, dq, corpus, fcn_params, m)
    _check_feat(f)
    if fcn_params[0]["w"].shape[0] != k:
        raise ValueError(f"NTN width {k} != first FCN layer's "
                         f"{fcn_params[0]['w'].shape[0]}")
    pu = build.checked(uq, "uq", torch.float32, (q, k * f))
    pd = build.checked(dq, "dq", torch.float32, (q, k))
    pc = build.checked(corpus, "corpus", torch.float32, (n, f))
    params, _keep = build.simgnn_params({"fcn": fcn_params}, uq.device)
    ps, pi, out_s, out_i = _scan_buffers(q, n, m, block_cols, uq.device)
    err = _launchers()[1](
        pu, pd, pc, q, n, f, k, block_cols, m, ps.data_ptr(), pi.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), ctypes.byref(params),
        torch.cuda.current_stream(uq.device).cuda_stream)
    build.check_launch(err, "topm_ntn")
    blocked_topm_ntn.launches += 1
    return out_s, out_i


blocked_topm.launches = 0
blocked_topm_ntn.launches = 0


# ------------------------------------------------ numpy references + proxy

def topm_reference(qv, corpus, m: int):
    """Dense numpy reference for `blocked_topm` (same sentinel and tie
    order): materializes [Q, N]."""
    s = np.asarray(qv, np.float32) @ np.asarray(corpus, np.float32).T
    return _rank_reference(s, m)


def collapse_query_ntn(ntn_params, hq) -> tuple[np.ndarray, np.ndarray]:
    """Fold the NTN's query side into per-query scan operands: slice k of
    the pre-activation is (h_q W_k + v_k[F:])·h_c + (v_k[:F]·h_q + b_k).
    Returns `(uq [Q, K*F], dq [Q, K])`. `ntn_params` leaves may be numpy
    arrays or tensors."""
    w, v, b = (_host_f32(ntn_params[n]) for n in ("w", "v", "b"))
    hq = np.asarray(hq, np.float32)
    f = w.shape[1]
    uq = np.einsum("qf,kfg->qkg", hq, w) + v[None, :, f:]
    dq = hq @ v[:, :f].T + b[None, :]
    return (uq.reshape(hq.shape[0], -1).astype(np.float32),
            dq.astype(np.float32))


def ntn_logit_reference(uq, dq, corpus, fcn_params, m: int):
    """Dense numpy reference for `blocked_topm_ntn`: materializes [Q, N]."""
    corpus = np.asarray(corpus, np.float32)
    q, (n, f) = np.asarray(uq).shape[0], corpus.shape
    k = np.asarray(dq).shape[1]
    a = np.einsum("qkf,nf->qnk", np.asarray(uq, np.float32).reshape(q, k, f),
                  corpus) + np.asarray(dq, np.float32)[:, None, :]
    x = np.maximum(a, 0.0)
    for li, p in enumerate(fcn_params):
        x = x @ _host_f32(p["w"]) + _host_f32(p["b"])
        if li + 1 < len(fcn_params):
            x = np.maximum(x, 0.0)
    return _rank_reference(x[..., 0], m)


def _rank_reference(s: np.ndarray, m: int):
    s = np.where(np.isfinite(s), s, np.float32(NEG_FILL)).astype(np.float32)
    m = int(max(1, min(m, s.shape[1])))
    order = np.argsort(-s, axis=1, kind="stable")[:, :m]
    return (np.take_along_axis(s, order, axis=1),
            order.astype(np.int32))


def _host_f32(x) -> np.ndarray:
    """A float32 host copy of a numpy array or a tensor of any float
    dtype (bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def fit_prefilter_calibration(ntn_w, hq, hc, exact_scores, *,
                              ridge: float = 1e-4) -> dict:
    """Fit the proxy so dot-product ranking tracks the exact head: ridge-
    regress the exact score's logit on the bilinear features
    phi_k = h_q W_k h_c, h_c, h_q and a constant, and collapse the fit
    into (alpha [K], beta [F]) so that
    proxy(q, c) = (sum_k alpha_k (h_q @ W_k) + beta) · h_c.
    Returns {"alpha", "beta", "r2", "n_samples"}."""
    w = _host_f32(ntn_w)                                    # [K, F, F]
    hq = np.asarray(hq, np.float32)
    hc = np.asarray(hc, np.float32)
    y = np.asarray(exact_scores, np.float64)
    ok = (np.isfinite(hq).all(axis=-1) & np.isfinite(hc).all(axis=-1)
          & np.isfinite(y))
    hq, hc, y = hq[ok], hc[ok], y[ok]
    if len(y) < w.shape[0]:
        raise ValueError(f"need >= {w.shape[0]} finite calibration pairs, "
                         f"got {len(y)}")
    y = np.log(np.clip(y, 1e-6, 1 - 1e-6)) - np.log1p(
        -np.clip(y, 1e-6, 1 - 1e-6))
    t = np.einsum("qf,kfg->qkg", hq, w)                     # [S, K, F]
    phi = np.einsum("qkg,qg->qk", t, hc)                    # [S, K]
    x = np.concatenate([phi, hc, hq, np.ones((len(y), 1))],
                       axis=1).astype(np.float64)
    k, f = w.shape[0], w.shape[1]
    # Ridge in the normal equations; scale-aware lambda so wildly different
    # feature magnitudes (bilinear vs raw embedding) are penalized evenly.
    g = x.T @ x
    lam = ridge * np.trace(g) / g.shape[0]
    coef = np.linalg.solve(g + lam * np.eye(g.shape[0]), x.T @ y)
    pred = x @ coef
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum()) or 1.0
    return {"alpha": coef[:k].astype(np.float32),
            "beta": coef[k:k + f].astype(np.float32),
            "r2": round(1.0 - ss_res / ss_tot, 6),
            "n_samples": int(len(y))}


def prefilter_query_vectors(ntn_w, hq, calib: dict) -> np.ndarray:
    """Collapse calibrated coefficients into per-query scan vectors
    `[Q, F]` such that `qv @ corpus.T` is the calibrated proxy score."""
    w = _host_f32(ntn_w)
    hq = np.asarray(hq, np.float32)
    t = np.einsum("qf,kfg->qkg", hq, w)                     # [Q, K, F]
    return (np.einsum("k,qkg->qg", calib["alpha"], t)
            + calib["beta"][None, :]).astype(np.float32)
