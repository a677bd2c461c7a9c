"""The bucketed pair kernel's launch plan and its live-row rule
(`kernels/fused_pair.py` `fused_pair_plan`, `row_blocks`), on the CPU.

The plan is a pure function of the shapes and the card's limits, so it is
checked here at the H100's (132 SMs, 232448 opt-in shared bytes a block)
without a card: the route, the cluster size, the grid, the row blocks and
the shared-memory layout the kernel carves. The live-row rule is checked
on a numpy float32 emulation of one side's node-ordered chains
(normalization, GCN stack, Att pooling): running every chain to
nr = min(n, ru4(n_eff + 1)) rows gives the bits of running it over all n
rows, with NaN, ±inf and -0 in the inputs, masks with holes and NaN in a
masked-out row of the raw adjacency."""

import ctypes

import numpy as np
import pytest

from repro_torch.configs.simgnn_aids import CONFIG
from repro_torch.core.simgnn import SimGNNConfig
from repro_torch.kernels.fused_gcn import RESERVED_SMEM
from repro_torch.kernels.fused_pair import (LAYOUT_FIELDS, FusedLayout,
                                            _layout_struct, fused_pair_plan,
                                            row_blocks)

SMS, OPTIN = 132, 232448
AIDS = CONFIG.feature_dims                        # (29, 128, 64, 32)
NARROW = SimGNNConfig(gcn_dims=(16, 8, 8, 4)).feature_dims
DEEP = (29, 24, 20, 16, 12, 10, 8, 6, 5)          # eight layers, odd widths
FCN = tuple(CONFIG.fcn_dims) + (1,)
BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def _plan(b, n, dims=AIDS, k=CONFIG.ntn_k, fcn=FCN):
    return fused_pair_plan(b, n, dims[0], dims[1:], k, fcn, SMS, OPTIN)


def _ru4(x):
    return (x + 3) // 4 * 4


def _buffers(plan, dims):
    """(name, start, words) of every buffer the cluster route carves."""
    lay = dict(plan.layout)
    np_, rbp, f = _ru4(lay["n"]), lay["rbp"], dims[-1]
    words = {"a": rbp * lay["lda"], "x": rbp * max(lay["ldf"], lay["ldh"]),
             "hwo": rbp * lay["ldh"], "win": lay["wr"] * lay["ldh"],
             "pool": np_ * lay["ldp"], "mask": np_, "inv": np_, "att": np_,
             "mean": f, "c": f, "hg": f, "hgp": 2 * f, "head": 2 * 64,
             "int": 4}
    if lay["w_off"] >= 0:
        words["w"] = max(a * _ru4(b) for a, b in zip(dims, dims[1:]))
    return [(k, lay[f"{k}_off"], w) for k, w in words.items()]


@pytest.mark.parametrize("dims", (AIDS, NARROW, DEEP),
                         ids=("aids", "narrow", "eight_layers"))
@pytest.mark.parametrize("n", BUCKETS)
@pytest.mark.parametrize("b", (1, 2, 3, 39, 193, 2048))
def test_every_plan_fits_the_card_and_its_buffers_are_disjoint(b, n, dims):
    plan = _plan(b, n, dims)
    assert plan.smem_bytes <= OPTIN and plan.threads == 256
    assert plan.waves == -(-plan.grid // (SMS * plan.ctas_per_sm))
    if plan.route == "single":
        assert plan.cluster == 1 and plan.grid == b and plan.layout == ()
        return
    assert plan.route == "cluster"
    assert plan.cluster in (2, 4, 8) and plan.cluster == 2 * plan.side_ctas
    assert plan.grid == plan.cluster * b and plan.scratch_floats == 0
    assert plan.ctas_per_sm * (plan.smem_bytes + RESERVED_SMEM) \
        <= OPTIN + RESERVED_SMEM
    lay = dict(plan.layout)
    assert plan.smem_bytes == 4 * lay["smem_floats"]
    assert lay["cs"] == plan.side_ctas and lay["n"] == n
    assert lay["f0"] == dims[0]
    for k in ("lda", "ldf", "ldh"):
        assert lay[k] % 4 == 0 and lay[k] % 32 == 4 or lay[k] < 32, k
    assert lay["lda"] >= _ru4(n) and lay["ldh"] >= max(dims[1:])
    assert lay["ldp"] % 2 == 1 and lay["ldp"] >= dims[-1]
    assert lay["wr"] == plan.window_rows and lay["wr"] % 4 == 0
    assert 4 <= lay["wr"] <= _ru4(n)
    spans = {}
    for name, start, words in _buffers(plan, dims):
        assert start % 4 == 0, name           # float4 / 16-byte aligned
        assert start + words <= lay["smem_floats"], name
        spans[name] = (start, start + words, name)
    # the pooled H may lie in the window, dead once the last aggregation
    # has read it; everything else stays apart the whole launch
    for skip in ("pool", "win"):
        rest = sorted(v for k, v in spans.items() if k != skip)
        for (_, end, x), (start, _, y) in zip(rest, rest[1:]):
            assert end <= start, (x, y)


@pytest.mark.parametrize("n", BUCKETS)
@pytest.mark.parametrize("dims", (AIDS, NARROW, DEEP),
                         ids=("aids", "narrow", "eight_layers"))
def test_row_blocks_cover_each_row_once(n, dims):
    plan = _plan(1, n, dims)
    rows = [i for start, stop in plan.row_blocks for i in range(start, stop)]
    assert rows == list(range(n))
    if plan.route == "cluster":
        assert len(plan.row_blocks) == plan.side_ctas
        rbp = dict(plan.layout)["rbp"]
        assert all(stop - start <= rbp for start, stop in plan.row_blocks)
        assert rbp * plan.side_ctas >= n


@pytest.mark.parametrize("cs", (1, 2, 4))
def test_the_kernels_split_of_the_live_rows_covers_each_once(cs):
    for rows in range(1, 513):
        blocks = row_blocks(rows, cs)
        assert len(blocks) == cs
        assert [i for s, e in blocks for i in range(s, e)] == \
            list(range(rows))
        rb = _ru4(-(-rows // cs))
        assert all(s == min(rows, q * rb) for q, (s, _) in enumerate(blocks))
        # the live rows never need more than the bucket's block
        assert rb <= _ru4(-(-_ru4(rows) // cs))


def test_served_buckets_and_small_calls_take_clusters():
    # the forced 256-pair request: 2, 22, 193 and 39 pairs
    assert _plan(2, 8).cluster == 2 and _plan(22, 16).cluster == 2
    assert _plan(193, 32).cluster == 2
    p64 = _plan(39, 64)
    assert p64.cluster == 4 and p64.grid == 156 and p64.waves == 1
    assert p64.ctas_per_sm == 2
    # calls of 1-3 pairs spread each side over more SMs
    for b in (1, 2, 3):
        assert _plan(b, 64).cluster == 8 and _plan(b, 32).cluster == 4
        assert _plan(b, 16).cluster == 2
    assert _plan(2048, 32).cluster == 2


def test_oversize_bucket_256_holds_the_live_rows_in_one_window():
    plan = _plan(1, 256)
    assert plan.route == "cluster" and plan.cluster == 8
    assert plan.scratch_floats == 0
    # the 130-node graph of the served oversize pair: 132 live rows
    assert plan.window_rows >= 132


def test_widths_that_fit_no_cluster_take_the_single_route():
    plan = _plan(1, 512)
    assert plan.route == "single" and plan.cluster == 1
    assert plan.scratch_floats == 512 * 512 + 2 * 512 * 128
    assert "single route" in plan.summary() and "scratch" in plan.summary()
    small = _plan(3, 512, NARROW)
    assert small.route == "single" and small.scratch_floats == 3 * (
        512 * 512 + 2 * 512 * 16)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match=r"widths \(16384,\)"):
        _plan(1, 64, (29, 16384))
    with pytest.raises(ValueError, match="GCN layers"):
        _plan(1, 64, (29,) + (8,) * 9)
    with pytest.raises(ValueError, match="positive"):
        _plan(0, 64)
    with pytest.raises(ValueError, match="ending in 1"):
        _plan(1, 64, fcn=(8, 4))
    with pytest.raises(ValueError, match="<= 64"):
        _plan(1, 64, k=65)


def test_layout_fills_the_c_struct_field_by_field():
    plan = _plan(39, 64)
    s = _layout_struct(plan)
    assert ctypes.sizeof(FusedLayout) == 4 * len(LAYOUT_FIELDS) == 4 * 25
    assert [k for k, _ in plan.layout] == list(LAYOUT_FIELDS)
    for k, v in plan.layout:
        assert getattr(s, k) == v, k
    assert "clusters of 4" in plan.summary()


# ------------------------------------------------ the live-row rule

def _fma(a, b, c):
    """float32 fmaf, elementwise: the product of two float32 values is
    exact in float64, and both chains compared below round the same
    non-zero terms the same way; every term a null row adds is a zero
    product (exact) or a NaN."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _relu(x):
    return np.where(x < 0, np.float32(0), x).astype(np.float32)


def _side(adj, feats, mask, ws, bs, att_w, rows):
    """One side of the kernel, every node-ordered chain run to `rows`
    rows (the degrees over `rows` columns): (A' [n, n], H [rows, F], hg)."""
    n = len(mask)
    f32 = np.float32
    eye = np.eye(n, dtype=f32)
    raw = ((adj + eye).astype(f32) * np.outer(mask, mask).astype(f32)
           ).astype(f32)
    deg = np.zeros(n, f32)
    for k in range(rows):
        deg = (deg + raw[:, k]).astype(f32)
    inv = np.where(deg > 0, (f32(1) / np.sqrt(np.maximum(deg, f32(1e-12))))
                   .astype(f32), f32(0)).astype(f32)
    a = ((raw * inv[:, None]).astype(f32) * inv[None, :]).astype(f32)
    x = feats[:rows]
    for w, b in zip(ws, bs):
        acc = np.zeros((rows, w.shape[1]), f32)
        for k in range(w.shape[0]):
            acc = _fma(x[:, k:k + 1], w[k][None, :], acc)
        hw = (acc + b).astype(f32)
        acc = np.zeros_like(hw)
        for k in range(rows):
            acc = _fma(a[:rows, k:k + 1], hw[k][None, :], acc)
        x = (_relu(acc) * mask[:rows, None]).astype(f32)
    h, m = x, mask[:rows]
    f = h.shape[1]
    s, cnt = np.zeros(f, f32), f32(0)
    for k in range(rows):
        s = _fma(m[k], h[k], s)
        cnt = f32(cnt + m[k])
    mean = (s / np.maximum(cnt, f32(1))).astype(f32)
    acc = np.zeros(f, f32)
    for j in range(f):
        acc = _fma(mean[j], att_w[j], acc)
    c = np.tanh(acc).astype(f32)
    att = np.zeros(rows, f32)
    for k in range(rows):
        if m[k] != 0:
            d = f32(0)
            for j in range(f):
                d = _fma(h[k, j], c[j], d)
            att[k] = f32(f32(1) / f32(f32(1) + np.exp(-d).astype(f32))) * m[k]
    hg = np.zeros(f, f32)
    for k in range(rows):
        hg = _fma(m[k], (att[k] * h[k]).astype(f32), hg)
    return a, h, hg


def _live_rows(adj, feats, mask):
    """1 + the last non-null row, as the kernel scans it: entries of the
    raw A' it forms, feature rows and masks."""
    n = len(mask)
    raw = ((adj + np.eye(n, dtype=np.float32)).astype(np.float32)
           * np.outer(mask, mask).astype(np.float32))
    v = 0
    for i, j in zip(*np.nonzero(raw != 0)):        # NaN != 0 too
        v = max(v, i + 1, j + 1)
    for i in np.nonzero((feats != 0).any(1) | (mask != 0))[0]:
        v = max(v, i + 1)
    return v


def _bits(x):
    x = np.asarray(x, np.float32)
    return np.where(np.isnan(x), np.uint32(0x7FC00000), x.view(np.uint32))


def _graph(seed, n=24, live=14, holes=(3, 9)):
    """Adjacency, one-hot feats and mask of a graph of `live` nodes padded
    to n, with masked-out holes among the live nodes."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), np.float32)
    for i in range(1, live):
        for j in rng.choice(i, size=min(i, 2), replace=False):
            adj[i, j] = adj[j, i] = 1.0
    feats = np.zeros((n, 5), np.float32)
    feats[np.arange(live), rng.integers(0, 5, live)] = 1.0
    mask = (np.arange(n) < live).astype(np.float32)
    mask[list(holes)] = 0.0
    return adj, feats, mask


def _weights(seed, dims=(5, 6, 4, 3)):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(size=(a, b)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [rng.normal(size=b).astype(np.float32) for b in dims[1:]]
    return ws, bs, rng.normal(size=(dims[-1], dims[-1])).astype(np.float32)


CHAIN_CASES = {
    "clean": {},
    "nan_in_a_hole_row": {"adj": [(3, 7, np.nan)]},
    "inf_in_a_hole_row": {"adj": [(9, 1, np.inf), (2, 9, -np.inf)]},
    "nan_in_a_padding_row": {"adj": [(20, 5, np.nan)]},
    "neg_zero_entries": {"adj": [(22, 1, -0.0), (1, 4, -0.0)],
                         "mask": [(17, -0.0)]},
    "nan_in_w0": {"w": [(0, 2, 1, np.nan)]},
    "inf_in_w1": {"w": [(1, 0, 3, np.inf)]},
    "minus_inf_in_b0": {"b": [(0, 4, -np.inf)]},
    "nan_in_att_w": {"att": [(1, 2, np.nan)]},
    "all_masked_out": {"mask_all": 0.0},
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
@pytest.mark.parametrize("seed", (0, 1))
def test_chains_to_the_live_rows_keep_every_bit(case, seed):
    spec = CHAIN_CASES[case]
    adj, feats, mask = _graph(seed)
    ws, bs, att_w = _weights(seed)
    for i, j, v in spec.get("adj", []):
        adj[i, j] = v
    for i, v in spec.get("mask", []):
        mask[i] = v
    if "mask_all" in spec:
        mask[:] = spec["mask_all"]
    for layer, i, j, v in spec.get("w", []):
        ws[layer][i, j] = v
    for layer, j, v in spec.get("b", []):
        bs[layer][j] = v
    for i, j, v in spec.get("att", []):
        att_w[i, j] = v
    n = len(mask)
    with np.errstate(all="ignore"):
        n_eff = _live_rows(adj, feats, mask)
    nr = min(n, _ru4(n_eff + 1))
    with np.errstate(all="ignore"):
        a, h_all, hg_all = _side(adj, feats, mask, ws, bs, att_w, n)
        a_live, h_live, hg_live = _side(adj, feats, mask, ws, bs, att_w, nr)
    # the kernel decides nullness on the raw A' it forms; the normalized
    # A' has the same null rows, and every row from n_eff on is null
    def nulls(m):
        return [k for k in range(n) if mask[k] == 0 and not feats[k].any()
                and not (m[k] != 0).any() and not (m[:, k] != 0).any()]
    with np.errstate(all="ignore"):
        raw = ((adj + np.eye(n, dtype=np.float32)).astype(np.float32)
               * np.outer(mask, mask).astype(np.float32))
    assert nulls(raw) == nulls(a)
    assert set(range(n_eff, n)) <= set(nulls(a))
    assert n_eff == 0 or n_eff - 1 not in nulls(a)
    if case in ("clean", "nan_in_a_hole_row", "inf_in_a_hole_row"):
        assert nr < n                     # the rule skips rows here
    if case == "nan_in_a_padding_row":
        assert nr == n                    # the NaN keeps its row live
    np.testing.assert_array_equal(_bits(a_live[:nr, :nr]), _bits(a[:nr, :nr]))
    np.testing.assert_array_equal(_bits(h_live), _bits(h_all[:nr]))
    np.testing.assert_array_equal(_bits(hg_live), _bits(hg_all))
