"""The top-M scans' launch plans (`kernels/retrieval.py` `topm_plan` for the
dot scan, `topm_ntn_plan` for the NTN scan) and the select route's
selection, on the CPU.

The plans are pure functions of the shapes and the card's limits, so they
are checked here at the H100's (132 SMs, 232448 opt-in shared bytes a
block) without a card: the route, the grid, the cluster, the queries a
CTA, the partition of the corpus over a cluster's CTAs and the
shared-memory layout the kernel carves (the NTN scan's query operands
and FCN weights included). The selection of `csrc/retrieval.cu`'s select
route is emulated in numpy step by step (each warp's queue of keys that
beat its filter threshold, the thresholds the cluster's warps publish,
the 32-key rank sort and the bitonic merge into a warp's sorted list, the
pairwise merges of a query's warps in a CTA and across the cluster) over
the plan's partition, and must give `_rank_reference`'s scores (int32 bit
patterns) and indices over ties, NaN, +-inf, -0 and an all-NaN corpus,
for dot-scan plans on dot scores and for NTN plans on the logits of
`ntn_logit_reference`; with the index tie rule dropped it must not (a
mutation check)."""

import ctypes

import numpy as np
import pytest

from repro_torch.kernels.fused_gcn import RESERVED_SMEM
from repro_torch.kernels.retrieval import (MAX_SELECT, NEG_FILL,
                                           RETRIEVAL_MAX_BLOCK_COLS,
                                           TopmLayout, _layout_struct,
                                           _ntn_words, _rank_reference,
                                           ntn_logit_reference, topm_ntn_plan,
                                           topm_plan)

SMS, OPTIN = 132, 232448
SERVED = (64, 8192, 32, 64, 256)          # (Q, N, F, M, block_cols)
INT_MAX = np.iinfo(np.int32).max
QUEUE, THREADS, QB = 64, 256, 4


def _plan(q, n, f, m, cols, **kw):
    return topm_plan(q, n, f, m, cols, SMS, OPTIN, **kw)


def test_served_scan_is_one_launch_of_clusters_of_eight():
    plan = _plan(*SERVED)
    lay = dict(plan.layout)
    assert plan.route == "select" and plan.list_entries == 0
    assert (plan.grid, plan.cluster, plan.queries) == ((128,), 8, 4)
    assert (plan.chunk, plan.chunks_per_cta, plan.keys_a_lane) == (256, 4, 2)
    assert lay["cs"] * lay["per"] * lay["chunk"] == 8192
    assert plan.smem_bytes <= OPTIN and plan.ctas_per_sm == 2
    assert _plan(64, 8192, 32, 65, 256).ctas_per_sm == 1    # 4 keys a lane


def test_m_equal_n_and_m_above_the_cap_take_the_sort_route():
    plan = _plan(1, 8192, 32, 8192, 256)
    assert plan.route == "sort" and plan.layout == ()
    assert plan.grid == (32, 1) and plan.list_entries == 8192
    assert _plan(5, 300, 32, MAX_SELECT, 64).route == "select"
    assert _plan(5, 300, 32, MAX_SELECT + 1, 64).route == "sort"
    assert _plan(*SERVED, route="sort").route == "sort"


SHAPES = [SERVED, (1, 8192, 32, 64, 256), (65, 8192, 32, 64, 256),
          (5, 137, 32, 137, 32), (5, 137, 32, 1, 32), (5, 137, 32, 100, 32),
          (3, 8, 32, 8, 8), (3, 40, 32, 40, 16), (4, 300, 32, 50, 64),
          (64, 8192, 4, 64, 256), (64, 8192, 64, 256, 1024),
          (7, 1000, 5, 33, 64), (64, 8192, 32, 64, 8),
          (1024, 8192, 32, 64, 256), (100000, 4096, 64, 129, 1024)]


def _words(lay, r, ntn=0):
    kp = 32 * r
    return {"stage0": (lay["stage_off"][0], lay["chunk"] * lay["ld"]),
            "stage1": (lay["stage_off"][1], lay["chunk"] * lay["ld"]),
            "scores": (lay["sc_off"], QB * lay["lds"]),
            "queues": (lay["queue_off"], THREADS // 32 * 2 * QUEUE),
            "bounds": (lay["thr_off"], THREADS // 32 * 2),
            "mbarriers": (lay["bar_off"], 4),
            "lists": (lay["list_off"], 2 * QB * kp),
            "gather": (lay["gather_off"], 2 * lay["cs"] * QB * kp),
            "ntn": (lay["ntn_off"], ntn)}


@pytest.mark.parametrize("shape", SHAPES)
def test_layout_is_disjoint_aligned_and_inside_the_opt_in_limit(shape):
    q, n, f, m, cols = shape
    plan = _plan(*shape)
    assert plan.route == "select"
    lay = dict(plan.layout)
    spans = sorted(_words(lay, plan.keys_a_lane).values())
    for (a, na), (b, _) in zip(spans, spans[1:]):
        assert a + na <= b
    assert spans[0][0] == 0 and all(a % 4 == 0 for a, _ in spans)
    assert spans[-1][0] + spans[-1][1] == lay["smem_words"]
    assert lay["thr_off"] % 2 == 0 and lay["bar_off"] % 2 == 0   # 64-bit
    assert lay["stage_off"][1] % 256 == 0    # the TMA swizzle's 1024 bytes
    assert plan.smem_bytes == 4 * lay["smem_words"] <= OPTIN
    # padded rows: float4 reads of eight rows a warp on distinct banks
    assert lay["ld"] % 32 == 4 and lay["ld"] >= (f + 3) // 4 * 4
    assert lay["lds"] % 32 == 8 and lay["lds"] >= lay["chunk"]
    assert plan.ctas_per_sm * (plan.smem_bytes + RESERVED_SMEM) <= \
        OPTIN + RESERVED_SMEM


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_covers_every_query_and_row_in_clusters_of_at_most_eight(shape):
    q, n, f, m, cols = shape
    plan = _plan(*shape)
    lay = dict(plan.layout)
    cs = plan.cluster
    assert cs in (1, 2, 4, 8) and lay["cs"] == cs
    assert plan.grid[0] % cs == 0 and plan.grid[0] // cs * QB >= q
    assert (plan.grid[0] // cs - 1) * QB < q         # no idle cluster
    assert lay["chunk"] == min(cols, 256) <= RETRIEVAL_MAX_BLOCK_COLS
    nchunks = -(-n // lay["chunk"])
    assert cs <= nchunks and cs * lay["per"] >= nchunks
    assert (cs * lay["per"] - lay["per"]) < nchunks  # rank cs-1 has rows
    r = plan.keys_a_lane
    assert r in (1, 2, 4, 8) and 32 * r >= m and (r == 1 or 16 * r < m)


def test_cluster_halves_only_while_the_grid_still_fills_a_wave():
    assert _plan(64, 8192, 32, 64, 256).cluster == 8
    assert _plan(1024, 8192, 32, 64, 256).cluster == 2
    assert _plan(1 << 16, 8192, 32, 64, 256).cluster == 1
    assert _plan(2, 100, 32, 10, 32).cluster == 4    # 4 chunks of 32 rows
    assert _plan(2, 160, 32, 10, 32).cluster == 2    # 5: no rank left idle


def test_a_small_opt_in_limit_halves_the_chunk_then_takes_the_sort_route():
    small = topm_plan(64, 8192, 64, 256, 1024, SMS, 100_000)
    assert small.route == "select" and small.chunk < 256
    assert small.smem_bytes <= 100_000
    tiny = topm_plan(64, 8192, 64, 64, 64, SMS, 12_000)
    assert tiny.route == "sort" and tiny.smem_bytes <= 12_000


def test_sizes_that_do_not_fit_are_refused_by_name():
    with pytest.raises(ValueError, match="up to 64 wide, got 65"):
        _plan(4, 100, 65, 10, 32)
    with pytest.raises(ValueError, match="embedding width 64 does not fit"):
        topm_plan(64, 8192, 64, 64, 1024, SMS, 12_000, route="select")
    with pytest.raises(ValueError, match="1024 columns at embedding width"):
        topm_plan(64, 8192, 64, 300, 1024, SMS, 12_000)
    with pytest.raises(ValueError, match="keeps M <= 256"):
        _plan(4, 1000, 32, 300, 64, route="select")
    with pytest.raises(ValueError, match="block_cols"):
        _plan(4, 1000, 32, 10, 2048)
    with pytest.raises(ValueError, match="1 <= M <= N"):
        _plan(4, 10, 32, 11, 8)


@pytest.mark.parametrize("scan", ("dot", "ntn"))
def test_layout_fills_the_c_struct_field_by_field(scan):
    plan = (_plan(*SERVED) if scan == "dot" else
            _ntn_plan(64, 8192, 32, AIDS, 64, 256))
    s = _layout_struct(plan)
    assert ctypes.sizeof(TopmLayout) == 17 * 4
    assert len(plan.layout) == len(TopmLayout._fields_)
    for name, v in plan.layout:
        got = getattr(s, name)
        assert (tuple(got) if isinstance(v, tuple) else got) == v, name


# ------------------------------------------------ the selection, emulated

def _before(a_s, a_i, b_s, b_i, ties=True):
    out = a_s > b_s
    if ties:
        out = out | ((a_s == b_s) & (a_i < b_i))
    return out


def _exchange(s, i, lo, hi, keep_best_low, ties):
    """One network stage: positions lo and hi = lo + d swap where the
    better key (or, where keep_best_low is False, the worse) is at hi."""
    hi_first = _before(s[hi], i[hi], s[lo], i[lo], ties)
    lo_first = _before(s[lo], i[lo], s[hi], i[hi], ties)
    swap = np.where(keep_best_low, hi_first, lo_first)
    a, b = lo[swap], hi[swap]
    s[a], s[b] = s[b].copy(), s[a].copy()
    i[a], i[b] = i[b].copy(), i[a].copy()


def _rank_sort(s, i, take, ties):
    """`topm_drain`'s batch sort: lane l's key goes to position #{j < take:
    key j before key l}; lanes from `take` on hold sentinels."""
    out_s = np.full(32, -np.inf, np.float32)
    out_i = np.full(32, INT_MAX, np.int64)
    for lane in range(take):
        rank = int(_before(s[:take], i[:take], s[lane], i[lane], ties).sum())
        out_s[rank], out_i[rank] = s[lane], i[lane]
    return out_s, out_i


def _clean(s, i, ties):
    """`WarpTopM::clean`: the half-cleaners of a bitonic merge."""
    pos = np.arange(len(s))
    d = len(s) // 2
    while d:
        lo = pos[(pos & d) == 0]
        _exchange(s, i, lo, lo + d, np.ones(len(lo), bool), ties)
        d //= 2


class _Warp:
    """A warp's WarpTopM<R>, its queue and its filter threshold `ft`."""

    def __init__(self, m, kp, ties, pub=0):
        self.m, self.ties, self.pub = m, ties, pub
        self.s = np.full(kp, -np.inf, np.float32)
        self.i = np.full(kp, INT_MAX, np.int64)
        self.qs, self.qi = [], []
        self.ft = (np.float32(-np.inf), INT_MAX)
        self.published = [self.ft]          # every key it has published

    def t(self):
        return self.s[self.m - 1], self.i[self.m - 1]

    def tighten(self, key):
        if _before(*key, *self.ft, self.ties):
            self.ft = key

    def offer(self, s, i, real):
        ok = real & _before(s, i, *self.ft, self.ties)
        self.qs += list(s[ok])
        self.qi += list(i[ok])
        if len(self.qs) >= 32:
            self.drain()

    def drain(self):
        bs = np.full(32, -np.inf, np.float32)
        bi = np.full(32, INT_MAX, np.int64)
        take = min(32, len(self.qs))
        bs[:take], bi[:take] = self.qs[:take], self.qi[:take]
        self.qs, self.qi = self.qs[take:], self.qi[take:]
        bs, bi = _rank_sort(bs, bi, take, self.ties)
        tail = slice(len(self.s) - 32, None)
        rs, ri = bs[::-1].copy(), bi[::-1].copy()
        better = _before(rs, ri, self.s[tail], self.i[tail], self.ties)
        self.s[tail] = np.where(better, rs, self.s[tail])
        self.i[tail] = np.where(better, ri, self.i[tail])
        _clean(self.s, self.i, self.ties)
        self.tighten(self.t())
        self.published.append((self.s[self.pub], self.i[self.pub]))

    def merge(self, other_s, other_i):
        rs, ri = other_s[::-1], other_i[::-1]
        better = _before(rs, ri, self.s, self.i, self.ties)
        self.s = np.where(better, rs, self.s).astype(np.float32)
        self.i = np.where(better, ri, self.i)
        _clean(self.s, self.i, self.ties)


def emulate_select(scores, m, plan, ties=True, seed=0, pub=None):
    """The select route's result on a [Q, N] score matrix, step by step
    over `plan`'s partition, chunk by chunk across the cluster's CTAs: the
    W = 8 / qb warps of a query take its 32-row groups in turn; from a
    CTA's second chunk on, a warp tightens its filter threshold once a
    chunk with the worst of the keys the query's W cs warps published (each
    its key ceil(M / W cs) - 1), each the latest or the one before at
    random, as a read of another CTA's shared memory may find an older key.
    A CTA's W warps of a query then merge pairwise (part p + d into part
    p, d = W / 2 .. 1), and rank 0's P = min(W, cs) parts merge the ranks'
    lists (part p those of ranks p, p + P, ...) and then pairwise. Also
    returns how often each (query, row) was offered to a warp."""
    rng = np.random.default_rng(seed)
    s = np.where(np.isfinite(scores), scores,
                 np.float32(NEG_FILL)).astype(np.float32)
    q, n = s.shape
    lay = dict(plan.layout)
    chunk, cs, per, kp, qb = lay["chunk"], lay["cs"], lay["per"], \
        32 * lay["r"], lay["qb"]
    w_q = THREADS // 32 // qb
    nchunks = -(-n // chunk)
    out_s = np.zeros((q, m), np.float32)
    out_i = np.zeros((q, m), np.int32)
    seen = np.zeros((q, n), np.int64)
    if pub is None:
        pub = -(-m // (w_q * cs)) - 1
    for g in range(plan.grid[0] // cs):
        live = [sq for sq in range(qb) if g * qb + sq < q]
        warps = {(rank, sq, p): _Warp(m, kp, ties, pub) for rank in range(cs)
                 for sq in live for p in range(w_q)}
        for step in range(per):
            for (rank, sq, part), wp in warps.items():
                c = rank * per + step
                if c >= min(rank * per + per, nchunks):
                    continue
                if step > 0:
                    seen_keys = [o.published[-1 - rng.integers(
                        min(2, len(o.published)))]
                        for key, o in warps.items() if key[1] == sq]
                    worst = seen_keys[0]
                    for k in seen_keys[1:]:
                        if _before(*worst, *k, ties):
                            worst = k
                    wp.tighten(worst)
                qq, r0 = g * qb + sq, c * chunk
                rows = min(chunk, n - r0)
                for base in range(32 * part, rows, 32 * w_q):
                    r = base + np.arange(32)
                    real = r < rows
                    rr = np.minimum(r0 + r, n - 1)
                    seen[qq, rr[real]] += 1
                    wp.offer(np.where(real, s[qq, rr], 0).astype(
                        np.float32), r0 + r, real)

        def pairwise(ws):
            d = len(ws) // 2
            while d >= 1:
                for p in range(d):
                    ws[p].merge(ws[p + d].s, ws[p + d].i)
                d //= 2
            return ws[0]
        lists = {}
        for rank in range(cs):
            for sq in live:
                ws = [warps[(rank, sq, p)] for p in range(w_q)]
                for wp in ws:
                    if wp.qs:
                        wp.drain()
                first = pairwise(ws)
                lists[(rank, sq)] = (first.s, first.i)
        for sq in live:
            parts = []
            for p in range(min(w_q, cs)):
                wp = _Warp(m, kp, ties)
                wp.s, wp.i = (x.copy() for x in lists[(p, sq)])
                for r in range(p + min(w_q, cs), cs, min(w_q, cs)):
                    wp.merge(*lists[(r, sq)])
                parts.append(wp)
            first = pairwise(parts)
            out_s[g * qb + sq] = first.s[:m]
            out_i[g * qb + sq] = first.i[:m]
    return out_s, out_i, seen


def _scores(case, q, n, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((q, n)).astype(np.float32)
    if case == "ties":
        dup = rng.choice(n, size=n // 3, replace=False)
        s[:, dup] = s[:, rng.choice(n // 4, size=len(dup))]
    elif case == "nan":
        s[:, rng.choice(n, size=n // 5, replace=False)] = np.nan
    elif case == "inf":
        s[:, rng.choice(n, size=n // 6, replace=False)] = np.inf
        s[:, rng.choice(n, size=n // 6, replace=False)] = -np.inf
    elif case == "signed_zero":       # the zeros rank first
        s = -np.abs(s)
        z = rng.choice(n, size=n // 2, replace=False)
        s[:, z] = np.where(rng.random((q, len(z))) < 0.5, -0.0, 0.0)
    elif case == "all_nan":
        s[:] = np.nan
    elif case == "coarse":             # few distinct values: ties everywhere
        s = np.round(s * 2).astype(np.float32) / 2
    return s


EMULATED = [("plain", 5, 137, 10, 32), ("ties", 4, 300, 50, 64),
            ("ties", 9, 600, 64, 256), ("nan", 3, 40, 40, 16),
            ("inf", 6, 500, 100, 64), ("signed_zero", 5, 260, 200, 64),
            ("signed_zero", 3, 137, 1, 32), ("all_nan", 3, 8, 8, 8),
            ("all_nan", 5, 300, 256, 32), ("coarse", 7, 1000, 33, 128),
            ("coarse", 2, 2048, 129, 256), ("plain", 1, 64, 64, 64)]


@pytest.mark.parametrize("case,q,n,m,cols", EMULATED)
def test_emulated_selection_has_the_reference_bits(case, q, n, m, cols):
    s = _scores(case, q, n)
    plan = _plan(q, n, 32, m, cols)
    got_s, got_i, seen = emulate_select(s, m, plan, seed=n)
    want_s, want_i = _rank_reference(s, m)
    assert (seen == 1).all()                      # every row offered once
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s.view(np.int32),
                                  want_s.view(np.int32))


@pytest.mark.parametrize("case", ("ties", "signed_zero", "all_nan"))
def test_emulation_without_the_tie_rule_departs_from_the_reference(case):
    """A mutation check: the same emulation with (score) instead of
    (score, index) as the order must fail where scores tie."""
    q, n, m, cols = 4, 300, 50, 64
    s = _scores(case, q, n)
    plan = _plan(q, n, 32, m, cols)
    got_s, got_i, _ = emulate_select(s, m, plan, ties=False)
    want_s, want_i = _rank_reference(s, m)
    assert not np.array_equal(got_i, want_i)


def test_a_bound_from_too_few_keys_departs_from_the_reference():
    """A mutation check of the published bounds: each warp publishing its
    best key (16 warps x 1 key < M = 64) instead of key ceil(M / 16) - 1
    lets the bound cut off keys of the top M. Each of the 16 warps of a
    query meets one outstanding row in its first step, so the wrong bound
    is tight from then on."""
    q, n, m, cols = 4, 2048, 64, 64
    s = _scores("plain", q, n)
    plan = _plan(q, n, 32, m, cols)
    lay = dict(plan.layout)
    assert plan.cluster == 8 and lay["chunk"] == 64
    for rank in range(8):
        for h in (0, 1):
            s[:, rank * lay["per"] * 64 + 32 * h] += 100.0
    want_s, want_i = _rank_reference(s, m)
    got_s, got_i, _ = emulate_select(s, m, plan, seed=1)
    np.testing.assert_array_equal(got_i, want_i)
    got_s, got_i, _ = emulate_select(s, m, plan, seed=1, pub=0)
    assert not np.array_equal(got_i, want_i)


# ------------------------------------------------------------ the NTN scan

AIDS = (16, 8, 4, 1)                      # K and FCN widths to 1


def _ntn_plan(q, n, f, dims, m, cols, **kw):
    return topm_ntn_plan(q, n, f, dims, m, cols, SMS, OPTIN, **kw)


def test_served_ntn_scan_is_one_select_launch_of_one_query_a_cta():
    """One query a CTA in clusters of 2 (64 clusters, all resident at one
    CTA an SM), chunks of 512 rows (8 warps x 32 lanes x 2 rows), no
    per-block lists; the AIDS head's own instantiation."""
    plan = _ntn_plan(64, 8192, 32, AIDS, 64, 256)
    lay = dict(plan.layout)
    assert plan.route == "select" and plan.list_entries == 0
    assert plan.scoring == "ntn_served"
    assert (plan.grid, plan.cluster, plan.queries) == ((128,), 2, 1)
    assert (plan.chunk, plan.chunks_per_cta, plan.keys_a_lane) == (512, 8, 2)
    assert lay["cs"] * lay["per"] * lay["chunk"] == 8192
    assert plan.ctas_per_sm == 1 and plan.smem_bytes <= OPTIN
    assert plan.grid[0] <= SMS                  # one CTA an SM, one wave
    # other heads take the instantiation for any head
    assert _ntn_plan(64, 8192, 32, (40, 8, 4, 1), 64, 256).scoring == "ntn"
    assert _ntn_plan(64, 8192, 4, AIDS, 64, 256).scoring == "ntn"


NTN_SHAPES = [(64, 8192, 64, 256), (1, 8192, 64, 256), (5, 1000, 1, 64),
              (3, 4000, 256, 128), (127, 8192, 33, 256), (7, 300, 200, 32),
              (1024, 8192, 64, 256), (2, 40, 40, 16)]
NTN_HEADS = [(32, AIDS), (32, (40, 8, 4, 1)), (4, AIDS), (64, AIDS),
             (64, (40, 8, 4, 1)), (32, (16, 16, 8, 4, 1)), (32, (16, 1))]


@pytest.mark.parametrize("head", NTN_HEADS)
@pytest.mark.parametrize("shape", NTN_SHAPES)
def test_ntn_layout_is_disjoint_aligned_and_inside_the_opt_in_limit(head,
                                                                   shape):
    f, dims = head
    q, n, m, cols = shape
    plan = _ntn_plan(q, n, f, dims, m, cols)
    assert plan.route == "select"
    lay = dict(plan.layout)
    words = _ntn_words(lay["qb"], dims[0], f, dims)
    spans = sorted(_words(lay, plan.keys_a_lane, words).values())
    for (a, na), (b, _) in zip(spans, spans[1:]):
        assert a + na <= b
    assert spans[0][0] == 0 and all(a % 4 == 0 for a, _ in spans)
    assert spans[-1][0] + spans[-1][1] == lay["smem_words"]
    assert lay["ntn_off"] == spans[-1][0] and words > 0
    assert lay["thr_off"] % 2 == 0 and lay["bar_off"] % 2 == 0
    assert lay["stage_off"][1] % 256 == 0
    assert plan.smem_bytes == 4 * lay["smem_words"] <= OPTIN
    assert lay["ld"] % 32 == 4 and lay["ld"] >= (f + 3) // 4 * 4
    assert lay["lds"] % 32 == 8 and lay["lds"] >= lay["chunk"]
    # two TMA boxes of 256 rows at most, whole boxes
    assert lay["chunk"] <= 512 and (lay["chunk"] <= 256
                                    or lay["chunk"] % 256 == 0)
    assert plan.ctas_per_sm * (plan.smem_bytes + RESERVED_SMEM) <= \
        OPTIN + RESERVED_SMEM


@pytest.mark.parametrize("head", NTN_HEADS[:3])
@pytest.mark.parametrize("shape", NTN_SHAPES)
def test_ntn_grid_covers_every_query_and_row(head, shape):
    f, dims = head
    q, n, m, cols = shape
    plan = _ntn_plan(q, n, f, dims, m, cols)
    lay = dict(plan.layout)
    cs, qb = plan.cluster, lay["qb"]
    assert qb == plan.queries in (1, 2, 4) and cs in (1, 2, 4, 8)
    assert plan.grid[0] % cs == 0 and plan.grid[0] // cs * qb >= q
    assert (plan.grid[0] // cs - 1) * qb < q        # no idle cluster
    nchunks = -(-n // lay["chunk"])
    assert cs <= nchunks and cs * lay["per"] >= nchunks
    assert (cs * lay["per"] - lay["per"]) < nchunks  # rank cs-1 has rows
    r = plan.keys_a_lane
    assert r in (1, 2, 4, 8) and 32 * r >= m and (r == 1 or 16 * r < m)


def test_ntn_plan_spreads_the_arithmetic_over_the_sms():
    """The busiest SM holds close to 1/132 of the (query, row) pairs at
    the served shape; the candidates it beats put two CTAs of four queries
    on some SMs or leave clusters for a second wave."""
    plan = _ntn_plan(64, 8192, 32, AIDS, 64, 256)
    per_cta = plan.queries * plan.chunks_per_cta * plan.chunk
    assert per_cta * plan.ctas_per_sm <= 1.04 * 64 * 8192 / SMS
    assert _ntn_plan(1, 8192, 32, AIDS, 64, 256).cluster == 8   # one query
    assert _ntn_plan(1024, 8192, 32, AIDS, 64, 256).queries == 4


def test_ntn_m_above_the_cap_wide_heads_and_tight_limits_take_the_sort_route():
    plan = _ntn_plan(64, 8192, 32, AIDS, 257, 256)
    assert plan.route == "sort" and plan.layout == () and \
        plan.scoring == "ntn"
    assert plan.list_entries == 64 * 32 * 256 and plan.grid == (32, 8)
    assert _ntn_plan(64, 8192, 32, AIDS, 256, 256).route == "select"
    wide = _ntn_plan(64, 8192, 32, (16, 48, 1), 64, 256)
    assert wide.route == "sort"                 # FCN layer 48 > 16 wide
    assert _ntn_plan(64, 8192, 32, (16, 16, 1), 64, 256).route == "select"
    # 256 keys a warp: the lists gathered in rank 0 alone are 64 KB
    tight = topm_ntn_plan(64, 8192, 32, AIDS, 256, 64, SMS, 60_000)
    assert tight.route == "sort" and tight.smem_bytes <= 60_000
    small = topm_ntn_plan(64, 8192, 32, AIDS, 64, 256, SMS, 100_000)
    assert small.route == "select" and small.smem_bytes <= 100_000
    assert _ntn_plan(64, 8192, 32, AIDS, 64, 256, route="sort").route == \
        "sort"


def test_ntn_sizes_that_do_not_fit_are_refused_by_name():
    with pytest.raises(ValueError, match="up to 64 wide, got 65"):
        _ntn_plan(4, 100, 65, AIDS, 10, 32)
    with pytest.raises(ValueError, match="FCN widths"):
        _ntn_plan(4, 100, 32, (16, 8, 4, 2), 10, 32)
    with pytest.raises(ValueError, match="FCN widths"):
        _ntn_plan(4, 100, 32, (80, 8, 1), 10, 32)
    with pytest.raises(ValueError, match="keeps M <= 256"):
        _ntn_plan(4, 1000, 32, AIDS, 300, 64, route="select")
    with pytest.raises(ValueError, match="does not hold the NTN head"):
        _ntn_plan(4, 1000, 32, (16, 48, 1), 10, 64, route="select")
    with pytest.raises(ValueError, match="1024 columns at embedding width"):
        topm_ntn_plan(64, 8192, 32, AIDS, 300, 1024, SMS, 30_000)
    with pytest.raises(ValueError, match="1 <= M <= N"):
        _ntn_plan(4, 10, 32, AIDS, 11, 8)


def _ntn_logits(case, q, n, f=32, dims=AIDS, seed=0):
    """[Q, N] logits of `ntn_logit_reference` on data made from a seed:
    random, or small integers and weights of -1, 0, 1 (exact, ties), NaN
    corpus rows, an all-NaN corpus, and the integers' logits made <= 0
    with half of them -0 or +0."""
    rng = np.random.default_rng(seed)
    k = dims[0]
    uq = rng.standard_normal((q, k * f)).astype(np.float32)
    dq = rng.standard_normal((q, k)).astype(np.float32)
    corpus = rng.standard_normal((n, f)).astype(np.float32)
    fcn = [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(
        np.float32), "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
        for a, b in zip(dims, dims[1:])]
    if case in ("ties", "signed_zero"):
        uq, dq, corpus = (rng.integers(-2, 3, x.shape).astype(np.float32)
                          for x in (uq, dq, corpus))
        fcn = [{n_: np.sign(t) for n_, t in p.items()} for p in fcn]
    elif case == "nan_rows":
        corpus[rng.choice(n, size=n // 5, replace=False)] = np.nan
    elif case == "all_nan":
        corpus[:] = np.nan
    s, i = ntn_logit_reference(uq, dq, corpus, fcn, n)
    logits = np.empty((q, n), np.float32)
    np.put_along_axis(logits, i.astype(np.int64), s, axis=1)
    if case == "signed_zero":
        logits = -np.abs(logits)
        z = rng.random((q, n)) < 0.5
        logits[z] = np.where(rng.random(int(z.sum())) < 0.5, -0.0, 0.0)
    return logits


NTN_EMULATED = [("plain", 5, 1000, 10, 64, None), ("ties", 9, 600, 64, 256,
                                                    None),
                ("ties", 3, 2048, 33, 256, (1, 8)),
                ("ties", 6, 1500, 100, 64, (2, 4)),
                ("signed_zero", 4, 700, 200, 64, (4, 2)),
                ("signed_zero", 2, 300, 1, 32, (1, 2)),
                ("nan_rows", 7, 900, 64, 128, (2, 8)),
                ("all_nan", 3, 300, 256, 32, None),
                ("all_nan", 2, 40, 40, 16, (1, 1)),
                ("plain", 64, 1024, 64, 256, None)]


@pytest.mark.parametrize("case,q,n,m,cols,forced", NTN_EMULATED)
def test_emulated_selection_over_ntn_plans_has_the_reference_bits(
        case, q, n, m, cols, forced):
    """The selection over the NTN plan's partition (as planned, or with
    the queries a CTA and the cluster forced, so that 8, 4 and 2 warps a
    query and clusters of 1 to 8 all run) gives the reference's bits."""
    logits = _ntn_logits(case, q, n, seed=n + m)
    if forced is None:
        plan = _ntn_plan(q, n, 32, AIDS, m, cols)
    else:
        from repro_torch.kernels.retrieval import _ntn_select_plan
        plan = _ntn_select_plan(q, n, 32, AIDS, m, cols, SMS, OPTIN,
                                qb=forced[0], cs=forced[1])
        assert (plan.queries, plan.cluster) == forced
    assert plan.route == "select"
    got_s, got_i, seen = emulate_select(logits, m, plan, seed=n)
    want_s, want_i = _rank_reference(logits, m)
    assert (seen == 1).all()
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s.view(np.int32),
                                  want_s.view(np.int32))


@pytest.mark.parametrize("case", ("ties", "signed_zero"))
def test_emulation_over_an_ntn_plan_without_the_tie_rule_departs(case):
    """A mutation check on NTN logits: (score) instead of (score, index)."""
    q, n, m = 4, 900, 64
    logits = _ntn_logits(case, q, n, seed=3)
    plan = _ntn_plan(q, n, 32, AIDS, m, 64)
    got_s, got_i, _ = emulate_select(logits, m, plan, ties=False)
    want_s, want_i = _rank_reference(logits, m)
    assert not np.array_equal(got_i, want_i)
