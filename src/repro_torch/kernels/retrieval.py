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

Both launch the CUDA kernels of `csrc/retrieval.cu` on CUDA tensors and
their plain versions on CPU tensors. `topm_plan` and `topm_ntn_plan` (pure
Python, functions of the shapes and the card's limits) pick a launch's
route: the select route (M <= `MAX_SELECT`: one launch, a cluster of CTAs
along the corpus a group of queries, the chunk's scores from the dot or
the NTN phase, warp-level top-M selection, the cluster's lists merged
through distributed shared memory) or the sort route (larger M, layouts
that fit no chunk of 32 rows, and NTN heads whose FCN layers after K are
wider than `NTN_HIDDEN`: column blocks scored and sorted in parallel,
then merged per query in a second pass). The selection and merge run in
the kernels; no library selection call is on the CUDA path. The plain
versions materialise the [Q, N] score matrix and rank it with an explicit
stable (-score, index) sort; the kernels never do.
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
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.common import layer_pairs
from repro_torch.kernels.fused_gcn import RESERVED_SMEM, device_limits

__all__ = ["RETRIEVAL_MAX_BLOCK_COLS", "NEG_FILL", "retrieval_block_cols",
           "topm_plan", "topm_ntn_plan", "blocked_topm", "blocked_topm_ntn",
           "blocked_topm_plain", "blocked_topm_ntn_plain", "collapse_query_ntn", "topm_reference",
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

#: the select route (csrc/retrieval.cu): threads a CTA, queries a CTA (two
#: warps each), the portable cluster limit, the widest M it keeps (8 keys a
#: lane), queue slots a warp, rows staged at once, and the CTAs an SM its
#: __launch_bounds__ leaves room for by registers (2 at up to 2 keys a
#: lane and F = 32, which the kernel is built for at compile time; else 1)
SELECT_THREADS = 256
SELECT_QUERIES = 4
MAX_CLUSTER = 8
MAX_SELECT = 256
QUEUE = 64
MAX_CHUNK = 256
CTAS_BY_REGISTERS = 2
#: the sort route: queries a CTA of the block pass, threads a CTA
SORT_QUERIES = 8
SORT_THREADS = 256
#: the NTN phase: the widest FCN layer after K it holds in registers
#: (TOPM_NTN_HIDDEN), the head compiled into its own instantiation (F, FCN
#: widths from K to 1: SimGNN-AIDS), rows a lane by instantiation, the
#: most rows it stages at once (two TMA boxes), and the share of an SM's
#: cluster slots the plan counts on for clusters of 4 and 8 (the card
#: held 62 of 66 clusters of 4 and 30 of 33 of 8 at 2 CTAs an SM)
NTN_HIDDEN = 16
SERVED_NTN = (32, (16, 8, 4, 1))
NTN_ROWS = {"ntn_served": 2, "ntn": 1}
NTN_MAX_CHUNK = 512
CLUSTER_PACKING = 0.85


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
def _lib():
    """The library with its entry points' signatures set once."""
    lib = build.library("retrieval")
    build.check_side_struct(lib, "topm_layout_size", TopmLayout)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    build.bind(lib.topm_select_launch, [ptr, ptr] + [i32] * 4 + [ptr] * 2
               + [ctypes.POINTER(TopmLayout), ptr])
    build.bind(lib.topm_dot_launch, [ptr, ptr] + [i32] * 5 + [ptr] * 5)
    build.bind(lib.topm_ntn_launch, [ptr] * 3 + [i32] * 6 + [ptr] * 4
               + [ctypes.POINTER(build.SimgnnParams), ptr])
    build.bind(lib.topm_ntn_select_launch, [ptr] * 3 + [i32] * 5 + [ptr] * 2
               + [ctypes.POINTER(build.SimgnnParams),
                  ctypes.POINTER(TopmLayout), ptr])
    build.bind(lib.topm_max_clusters, [i32] * 5 + [ctypes.POINTER(i32)])
    return lib


def _scan_lists(entries: int, device):
    """The sort route's per-block key lists [Q, blocks, min(M, block_cols)]."""
    return (torch.empty(entries, dtype=torch.float32, device=device),
            torch.empty(entries, dtype=torch.int32, device=device))


def _outputs(q: int, m: int, device):
    return (torch.empty((q, m), dtype=torch.float32, device=device),
            torch.empty((q, m), dtype=torch.int32, device=device))


def _check_feat(f: int):
    if f > MAX_FEAT:
        raise ValueError(f"the top-M kernels take embeddings up to "
                         f"{MAX_FEAT} wide, got {f}")


def _pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _ru4(x: int) -> int:
    return (x + 3) // 4 * 4


def _row_stride(f: int) -> int:
    """Staged row stride (floats): at least F, a multiple of 4 and 4 mod 32,
    so the eight rows a warp reads with float4 loads hit distinct banks."""
    return (_ru4(f) + 27) // 32 * 32 + 4


@dataclass(frozen=True)
class TopmPlan:
    """One launch of a top-M scan in `csrc/retrieval.cu`. `layout` holds
    the select route's C struct `TopmLayout` fields (empty on the sort
    route)."""
    route: str              # "select" or "sort"
    grid: tuple             # select: (CTAs,); sort: the block pass's (x, y)
    threads: int
    cluster: int            # CTAs a cluster (select), 1 (sort)
    queries: int            # queries a CTA
    chunk: int              # rows staged at once (select), block_cols (sort)
    keys_a_lane: int        # R: a warp keeps 32R keys (select; 0 on sort)
    chunks_per_cta: int     # chunks a CTA walks (select; 1 on sort)
    ctas_per_sm: int        # what the plan counts on (shared bytes, registers)
    smem_bytes: int         # dynamic shared bytes (of the block pass on sort)
    list_entries: int       # per-block list entries in global memory (sort)
    layout: tuple           # ((field, value), ...)
    scoring: str = "dot"    # "dot", "ntn" or "ntn_served" (the AIDS head)

    def summary(self) -> str:
        scan = "" if self.scoring == "dot" else f"{self.scoring} scan, "
        if self.route == "sort":
            return (f"{scan}sort route, block pass grid {self.grid[0]} x "
                    f"{self.grid[1]} x {self.threads} threads "
                    f"({self.queries} queries, {self.chunk} columns a CTA, "
                    f"{self.smem_bytes} shared bytes), then the merge pass "
                    f"over {self.list_entries} listed keys")
        return (f"{scan}select route, grid {self.grid[0]} x {self.threads} "
                f"threads in clusters of {self.cluster}, {self.queries} "
                f"queries a CTA, {self.chunks_per_cta} chunk(s) of "
                f"{self.chunk} rows a CTA, {32 * self.keys_a_lane} keys a "
                f"warp ({self.keys_a_lane} a lane), {self.ctas_per_sm} "
                f"CTA(s)/SM, {self.smem_bytes} shared bytes")


def _select_layout(f: int, chunk: int, r: int, cs: int,
                   qb: int = SELECT_QUERIES, ntn_words: int = 0) -> dict:
    """Offsets (4-byte words) of the select route's shared buffers: two
    staged chunks [chunk, ld], the score tile [4, lds], a queue of
    (score, index) slots a warp, a published bound a warp (64-bit), the
    two chunk buffers' mbarriers, each query's list from half 1 to half 0,
    the cluster's lists gathered in rank 0 (scores then indices, 32R a
    list) and the NTN scan's operands (`ntn_words`, none for the dot
    scan)."""
    ld = _row_stride(f)
    lds = (chunk + 31) // 32 * 32 + 8
    kp = 32 * r
    warps = SELECT_THREADS // 32
    # the second buffer on a 1024-byte boundary (the TMA route's swizzle)
    stage = (0, (chunk * ld + 255) // 256 * 256)
    sc = stage[1] + chunk * ld
    queue = sc + _ru4(SELECT_QUERIES * lds)
    thr = queue + warps * 2 * QUEUE
    bar = thr + _ru4(2 * warps)
    lst = bar + 4
    gather = lst + 2 * SELECT_QUERIES * kp
    ntn = gather + 2 * cs * SELECT_QUERIES * kp
    return dict(chunk=chunk, ld=ld, lds=lds, qb=qb, stage_off=stage,
                sc_off=sc, queue_off=queue, thr_off=thr, bar_off=bar,
                list_off=lst, gather_off=gather, ntn_off=ntn,
                smem_words=ntn + ntn_words)


def _keys_a_lane(m: int) -> int:
    r = 1
    while 32 * r < m:
        r *= 2
    return r


def _select_ctas(r: int, pair: bool, smem: int, smem_optin: int) -> int:
    """CTAs an SM holds for a select-route layout: by registers (2 at up to
    2 keys a lane for an instantiation built for two, `pair`, else 1),
    threads and shared bytes."""
    by_regs = CTAS_BY_REGISTERS if r <= 2 and pair else 1
    return min(by_regs, 2048 // SELECT_THREADS,
               (smem_optin + RESERVED_SMEM) // (smem + RESERVED_SMEM))


def _cluster_sizes(nchunks: int):
    """Cluster sizes 1, 2, 4, 8 that leave no rank without a chunk (each
    walks ceil(chunks / cs) of them)."""
    for cs in (1, 2, 4, MAX_CLUSTER):
        if cs <= nchunks and (cs - 1) * -(-nchunks // cs) < nchunks:
            yield cs


def _plan_of(scoring, q, n, f, r, chunk, qb, cs, ntn_words, smem_optin,
             pair) -> TopmPlan:
    groups, nchunks = -(-q // qb), -(-n // chunk)
    if groups * cs > 2 ** 31 - 1:
        raise ValueError(f"{q} queries exceed the select route's grid")
    lay = _select_layout(f, chunk, r, cs, qb, ntn_words)
    smem = 4 * lay["smem_words"]
    per = -(-nchunks // cs)
    return TopmPlan(route="select", grid=(groups * cs,),
                    threads=SELECT_THREADS, cluster=cs, queries=qb,
                    chunk=chunk, keys_a_lane=r, chunks_per_cta=per,
                    ctas_per_sm=_select_ctas(r, pair, smem, smem_optin),
                    smem_bytes=smem, list_entries=0,
                    layout=tuple(dict(lay, cs=cs, per=per, r=r).items()),
                    scoring=scoring)


def _fit_chunk(f, cols, r, ntn_words, smem_optin) -> int | None:
    """min(cols, 256) rows, halved while the layout (sized for clusters of
    8 and 4 queries a CTA) is above `smem_optin` bytes; None below 32."""
    chunk = min(cols, MAX_CHUNK)
    while 4 * _select_layout(f, chunk, r, MAX_CLUSTER, SELECT_QUERIES,
                             ntn_words)["smem_words"] > smem_optin:
        if chunk <= 32:
            return None
        chunk = (chunk + 1) // 2
    return chunk


def _select_plan(q: int, n: int, f: int, m: int, cols: int, sms: int,
                 smem_optin: int) -> TopmPlan | None:
    """The dot scan's select-route plan, or None where no chunk of 32 rows
    or more fits `smem_optin` (sized for clusters of 8)."""
    r = _keys_a_lane(m)
    chunk = _fit_chunk(f, cols, r, 0, smem_optin)
    if chunk is None:
        return None
    groups, nchunks = -(-q // SELECT_QUERIES), -(-n // chunk)
    pair = f == 32
    ctas = _select_ctas(
        r, pair, 4 * _select_layout(f, chunk, r, MAX_CLUSTER)["smem_words"],
        smem_optin)
    cs = max(_cluster_sizes(nchunks))
    while cs > 1 and groups * (cs // 2) >= sms * ctas:
        cs //= 2
    return _plan_of("dot", q, n, f, r, chunk, SELECT_QUERIES, cs, 0,
                    smem_optin, pair)


def _check_scan(q, n, f, m, cols, route):
    if q < 1 or n < 1 or not 1 <= m <= n:
        raise ValueError(f"topm_plan takes Q, N >= 1 and 1 <= M <= N, got "
                         f"Q {q}, N {n}, M {m}")
    if not 1 <= f <= MAX_FEAT:
        raise ValueError(f"the top-M kernels take embeddings up to "
                         f"{MAX_FEAT} wide, got {f}")
    if not 1 <= cols <= RETRIEVAL_MAX_BLOCK_COLS:
        raise ValueError(f"block_cols must be 1..{RETRIEVAL_MAX_BLOCK_COLS}, "
                         f"got {cols}")
    if route not in (None, "select", "sort"):
        raise ValueError(f"route must be 'select' or 'sort', got {route!r}")
    if route == "select" and m > MAX_SELECT:
        raise ValueError(f"the select route keeps M <= {MAX_SELECT}, got {m}")


def _sort_plan(q, n, f, m, cols, smem_optin, smem, scoring) -> TopmPlan:
    nblk = -(-n // cols)
    if smem > smem_optin:
        raise ValueError(f"the sort route's block of {cols} columns at "
                         f"embedding width {f} needs {smem} shared bytes, "
                         f"the card {smem_optin}")
    if -(-q // SORT_QUERIES) > 65535 or \
            -(-nblk * min(m, cols) // SORT_THREADS) > 65535:
        raise ValueError(f"Q {q}, N {n}, M {m} at block_cols {cols} exceed "
                         "the sort route's grid")
    return TopmPlan(route="sort", grid=(nblk, -(-q // SORT_QUERIES)),
                    threads=SORT_THREADS, cluster=1, queries=SORT_QUERIES,
                    chunk=cols, keys_a_lane=0, chunks_per_cta=1,
                    ctas_per_sm=min(2048 // SORT_THREADS,
                                    (smem_optin + RESERVED_SMEM)
                                    // (smem + RESERVED_SMEM)),
                    smem_bytes=smem, list_entries=q * nblk * min(m, cols),
                    layout=(), scoring=scoring)


@functools.lru_cache(maxsize=256)
def topm_plan(q: int, n: int, f: int, m: int, cols: int, sms: int,
              smem_optin: int, route: str | None = None) -> TopmPlan:
    """Route, grid, cluster and shared layout of one dot-scan launch of Q
    queries of width F against N corpus rows, keeping M (clamped: M <= N),
    with column blocks of `cols` rows.

    M <= `MAX_SELECT` takes the select route: a cluster of cs CTAs along
    the corpus for each group of 4 queries, each CTA staging chunks of
    min(cols, 256) rows, halved while the layout (sized for clusters of 8)
    is above `smem_optin` bytes. cs is the largest of 1, 2, 4, 8 that is at
    most the corpus's chunks, halved while the halved grid still fills a
    wave (`sms` x the CTAs an SM holds) or a CTA would get no chunk (each
    walks ceil(chunks / cs) of them). Larger M, or a layout that fits no
    chunk of 32 rows, takes the sort route. `route` forces one (for timing
    the other); a shape that fits neither raises naming its width."""
    _check_scan(q, n, f, m, cols, route)
    if m <= MAX_SELECT and route != "sort":
        plan = _select_plan(q, n, f, m, cols, sms, smem_optin)
        if plan is not None:
            return plan
        if route == "select":
            raise ValueError(f"the select route's layout at embedding width "
                             f"{f} does not fit {smem_optin} shared bytes")
    smem = (2 * SORT_QUERIES * _pow2(cols) + SORT_QUERIES * f) * 4
    return _sort_plan(q, n, f, m, cols, smem_optin, smem, "dot")


def _ntn_words(qb: int, k: int, f: int, dims: tuple) -> int:
    """Words of the NTN phase's shared region (`topm_ntn_words`): uq
    [qb][K][ru4(F)], dq [qb][K], then each FCN layer's W and b, every
    piece rounded up to 4 words."""
    return qb * k * _ru4(f) + _ru4(qb * k) + sum(
        _ru4(a * b) + _ru4(b) for a, b in zip(dims, dims[1:]))


def _ntn_scoring(f: int, dims: tuple) -> str | None:
    """The NTN phase's instantiation for a head, None where its FCN layers
    after K are too wide for the registers."""
    if (f, dims) == SERVED_NTN:
        return "ntn_served"
    return "ntn" if max(dims[1:]) <= NTN_HIDDEN else None


def _ntn_busiest(q, n, chunk, qb, cs, sms) -> int:
    """(query, row) pairs on the busiest SM of an NTN select launch (one
    CTA an SM). A wave holds the clusters the card fits at once: all of
    its SMs for clusters of 1 or 2 CTAs, `CLUSTER_PACKING` of them for 4
    or 8 (a cluster sits inside one GPC)."""
    fits = sms // cs if cs <= 2 else int(CLUSTER_PACKING * sms / cs)
    waves = -(-(-(-q // qb)) // max(fits, 1))
    return waves * qb * -(-(-(-n // chunk)) // cs) * chunk


def _ntn_select_plan(q, n, f, dims, m, cols, sms, smem_optin, *,
                     qb: int | None = None,
                     cs: int | None = None) -> TopmPlan | None:
    """The NTN scan's select-route plan, or None where the head or no
    chunk of 32 rows fits. Both NTN instantiations take one CTA an SM (by
    registers). A CTA of qb queries stages chunks of 256 x rows-a-lane /
    qb rows (8 warps x 32 lanes' rows over its queries; at most
    `NTN_MAX_CHUNK`), halved while the layout (sized for clusters of 8) is
    above `smem_optin`. (qb, cs) as given, else the pair whose busiest SM
    holds the fewest (query, row) pairs (`_ntn_busiest`), then the most
    queries a CTA (fewer corpus reads), then the smallest cluster."""
    scoring = _ntn_scoring(f, dims)
    if scoring is None:
        return None
    r, k = _keys_a_lane(m), dims[0]

    def chunk_for(b):
        c = min(NTN_MAX_CHUNK, SELECT_THREADS * NTN_ROWS[scoring] // b)
        while 4 * _select_layout(f, c, r, MAX_CLUSTER, b, _ntn_words(
                b, k, f, dims))["smem_words"] > smem_optin:
            if c <= 32:
                return None
            c = (c + 1) // 2
        return c

    if qb is None or cs is None:
        keys = [((_ntn_busiest(q, n, c, b, s, sms), -b, s), b, s)
                for b in (SELECT_QUERIES, 2, 1) if b == 1 or b <= q
                for c in [chunk_for(b)] if c is not None
                for s in _cluster_sizes(-(-n // c))]
        if not keys:
            return None
        _, qb, cs = min(keys)
    chunk = chunk_for(qb)
    if chunk is None:
        return None
    return _plan_of(scoring, q, n, f, r, chunk, qb, cs,
                    _ntn_words(qb, k, f, dims), smem_optin, False)


@functools.lru_cache(maxsize=256)
def topm_ntn_plan(q: int, n: int, f: int, dims: tuple, m: int, cols: int,
                  sms: int, smem_optin: int,
                  route: str | None = None) -> TopmPlan:
    """Route, grid, cluster and shared layout of one NTN-scan launch: Q
    queries' collapsed operands (uq [Q, K*F], dq [Q, K]) against N corpus
    rows of width F, the FCN widths `dims` from K to 1, keeping M (M <= N)
    with column blocks of `cols` rows.

    M <= `MAX_SELECT` takes the select route where the head fits the NTN
    phase (the AIDS head compiled in, or FCN layers after K up to
    `NTN_HIDDEN` wide) and a chunk of 32 rows or more fits `smem_optin`
    with the query operands and FCN weights; queries a CTA, the chunk
    (not `cols`: the phase needs rows for all its warps) and the cluster
    are picked by `_ntn_select_plan`. Else the sort route on column blocks
    of `cols` (the block pass holds 8 queries' operands and two activation
    planes). `route` forces one (for timing the other); a shape that fits
    neither raises."""
    _check_scan(q, n, f, m, cols, route)
    dims = tuple(int(d) for d in dims)
    if len(dims) < 2 or dims[-1] != 1 or min(dims) < 1 or \
            max(dims) > build.MAX_HEAD or len(dims) - 1 > build.MAX_FCN:
        raise ValueError(f"the NTN scan takes FCN widths 1..{build.MAX_HEAD} "
                         f"from K to 1 over 1..{build.MAX_FCN} layers, got "
                         f"{dims}")
    if m <= MAX_SELECT and route != "sort":
        plan = _ntn_select_plan(q, n, f, dims, m, cols, sms, smem_optin)
        if plan is not None:
            return plan
        if route == "select":
            raise ValueError(f"the select route does not hold the NTN head "
                             f"{dims} at embedding width {f} in "
                             f"{smem_optin} shared bytes")
    k = dims[0]
    smem = (2 * SORT_QUERIES * _pow2(cols) + SORT_QUERIES * k * f
            + SORT_QUERIES * k + 2 * max(dims) * SORT_THREADS) * 4
    return _sort_plan(q, n, f, m, cols, smem_optin, smem, "ntn")


class TopmLayout(ctypes.Structure):
    """Mirror of `TopmLayout` in `csrc/retrieval.cu`."""
    _fields_ = ([(n, ctypes.c_int) for n in ("chunk", "ld", "lds", "cs",
                                             "per", "r", "qb")]
                + [("stage_off", ctypes.c_int * 2)]
                + [(n, ctypes.c_int) for n in ("sc_off", "queue_off",
                                               "thr_off", "bar_off",
                                               "list_off", "gather_off",
                                               "ntn_off", "smem_words")])


@functools.lru_cache(maxsize=256)
def _layout_struct(plan: TopmPlan) -> TopmLayout:
    s = TopmLayout()
    for name, v in plan.layout:
        if isinstance(v, tuple):
            arr = getattr(s, name)
            for i, x in enumerate(v):
                arr[i] = x
        else:
            setattr(s, name, v)
    return s


def plan_for(q: int, n: int, f: int, m: int, block_cols: int,
             device) -> TopmPlan:
    """The plan `blocked_topm` launches with on `device` (m clamped)."""
    return topm_plan(q, n, f, m, block_cols,
                     *device_limits(device.index or 0))


def ntn_plan_for(q: int, n: int, f: int, dims: tuple, m: int,
                 block_cols: int, device) -> TopmPlan:
    """The plan `blocked_topm_ntn` launches with on `device` (m clamped)."""
    return topm_ntn_plan(q, n, f, tuple(dims), m, block_cols,
                         *device_limits(device.index or 0))


#: `topm_max_clusters`' head argument by a plan's scoring phase
_HEAD = {"dot": 0, "ntn": 1, "ntn_served": 2}


def max_clusters(plan: TopmPlan, f: int) -> int:
    """Clusters of a select plan at width F the current device holds at
    once, as the CUDA runtime computes it (registers included)."""
    out = ctypes.c_int()
    build.check_launch(_lib().topm_max_clusters(
        plan.keys_a_lane, f, _HEAD[plan.scoring], plan.cluster,
        plan.smem_bytes, ctypes.byref(out)), "topm occupancy")
    return out.value


def launch(plan: TopmPlan, pq: int, pc: int, q: int, n: int, f: int, m: int,
           out_s: torch.Tensor, out_i: torch.Tensor) -> None:
    """One dot-scan launch of `plan` on checked qv/corpus pointers into
    [Q, M] outputs; the sort route allocates its per-block lists."""
    dev = out_s.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan.route == "select":
        err = _lib().topm_select_launch(
            pq, pc, q, n, f, m, out_s.data_ptr(), out_i.data_ptr(),
            ctypes.byref(_layout_struct(plan)), stream)
    else:
        ps, pi = _scan_lists(plan.list_entries, dev)
        err = _lib().topm_dot_launch(
            pq, pc, q, n, f, plan.chunk, m, ps.data_ptr(), pi.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), stream)
    build.check_launch(err, "topm")


def launch_ntn(plan: TopmPlan, pu: int, pd: int, pc: int, q: int, n: int,
               f: int, k: int, m: int, params, out_s: torch.Tensor,
               out_i: torch.Tensor) -> None:
    """One NTN-scan launch of `plan` on checked uq/dq/corpus pointers and
    a `SimgnnParams` of the FCN stack into [Q, M] outputs; the sort route
    allocates its per-block lists."""
    dev = out_s.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan.route == "select":
        err = _lib().topm_ntn_select_launch(
            pu, pd, pc, q, n, f, k, m, out_s.data_ptr(), out_i.data_ptr(),
            ctypes.byref(params), ctypes.byref(_layout_struct(plan)), stream)
    else:
        ps, pi = _scan_lists(plan.list_entries, dev)
        err = _lib().topm_ntn_launch(
            pu, pd, pc, q, n, f, k, plan.chunk, m, ps.data_ptr(),
            pi.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            ctypes.byref(params), stream)
    build.check_launch(err, "topm_ntn")


def blocked_topm(qv, corpus, m: int, *, block_cols: int | None = None):
    """Streaming top-M dot-product scan: qv [Q, F] against corpus [N, F]
    -> (scores [Q, M], indices [Q, M] int32), scores descending. CUDA
    tensors launch `csrc/retrieval.cu` on `topm_plan`'s route (counted in
    `blocked_topm.launches`, the plan kept in `blocked_topm.last_plan`);
    CPU tensors run the plain version."""
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
    pq = build.checked(qv, "qv", torch.float32, (q, f))
    pc = build.checked(corpus, "corpus", torch.float32, (n, f))
    plan = plan_for(q, n, f, m, block_cols, qv.device)
    out_s, out_i = _outputs(q, m, qv.device)
    launch(plan, pq, pc, q, n, f, m, out_s, out_i)
    blocked_topm.launches += 1
    blocked_topm.last_plan = plan
    return out_s, out_i


def blocked_topm_ntn(uq, dq, corpus, fcn_params, m: int, *,
                     block_cols: int | None = None):
    """Exact streamed NTN+FCN top-M scan: `(uq [Q, K*F], dq [Q, K])` from
    `collapse_query_ntn` against corpus [N, F] -> (pre-sigmoid logits
    [Q, M], indices [Q, M] int32). CUDA tensors launch
    `csrc/retrieval.cu` on `topm_ntn_plan`'s route (counted in
    `blocked_topm_ntn.launches`, the plan kept in
    `blocked_topm_ntn.last_plan`); CPU tensors run the plain version."""
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
    dims = (k,) + tuple(int(p["w"].shape[1]) for p in fcn_params)
    plan = ntn_plan_for(q, n, f, dims, m, block_cols, uq.device)
    out_s, out_i = _outputs(q, m, uq.device)
    launch_ntn(plan, pu, pd, pc, q, n, f, k, m, params, out_s, out_i)
    blocked_topm_ntn.launches += 1
    blocked_topm_ntn.last_plan = plan
    return out_s, out_i


blocked_topm.launches = 0
blocked_topm.last_plan = None
blocked_topm_ntn.launches = 0
blocked_topm_ntn.last_plan = None


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
