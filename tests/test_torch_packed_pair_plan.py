"""The packed-dense kernel's launch plan (`kernels/packed_pair.py`
`packed_pair_plan`) and the loop bounds of its cluster route, on the CPU.
The plan is a pure function of the shapes and the card's limits, so it is
checked here at the H100's (132 SMs, 232448 opt-in shared bytes a block)
without a card: the route, the grid, the block, the CTAs an SM holds and
the shared-memory layout the kernel carves. The loop bounds are emulated
in numpy: a row tile's chain over the union of its rows' nonzero columns
(and the degree sums over each row's nonzero columns) must give the bits
of the chain over every column whenever the kernel takes them, NaN, inf
and signed zeros included."""

import ctypes

import numpy as np
import pytest

from repro_torch.configs.simgnn_aids import CONFIG
from repro_torch.core.simgnn import SimGNNConfig
from repro_torch.kernels.fused_gcn import RESERVED_SMEM
from repro_torch.kernels.packed_pair import (PackedLayout, _layout_struct,
                                             head_words, packed_pair_plan)

SMS, OPTIN = 132, 232448
AIDS = CONFIG.feature_dims                        # (29, 128, 64, 32)
NARROW = SimGNNConfig(gcn_dims=(16, 8, 8, 4)).feature_dims
DEEP = (29, 128, 128, 64, 64, 32, 32, 16, 16)     # eight layers
ODD = (29, 24, 20, 16, 12, 10, 8, 6, 5)           # eight, off the float4 tile
SERVED = dict(t=105, nb=64, p=16)                 # a 256-pair request
HEAD = (CONFIG.ntn_k,) + tuple(CONFIG.fcn_dims) + (1,)   # K, FCN .., 1
WIDE_HEAD = (40,) + tuple(CONFIG.fcn_dims) + (1,)        # NTN K 40


def _plan(t=105, nb=64, p=16, dims=AIDS, head=HEAD):
    return packed_pair_plan(t, nb, p, dims, SMS, OPTIN, head=head)


def _ru4(x):
    return (x + 3) // 4 * 4


POOL = ("mean", "c", "att", "hg", "hgp", "head", "headw")
LAYERS = ("h", "a", "hw")


def _buffers(plan, nb, p, dims, head):
    """(name, start, words) of every buffer the kernel carves."""
    lay = dict(plan.layout)
    rows, f = _ru4(nb), dims[-1]
    words = {"h": rows * lay["ldh"], "a": rows * lay["lda"],
             "hw": rows * lay["ldh"], "mask": nb, "inv": nb, "pm": p,
             "labels": nb, "seg": nb, "first": nb, "last": nb,
             "live": p + 1, "need": p, "segs": p + 1, "neff": 1,
             "mean": p * f, "c": p * f, "att": nb, "hg": p * f,
             "hgp": p * f, "head": 8 * 2 * 64, "headw": head_words(f, head)}
    out = [(k, lay[f"{k}_off"], n) for k, n in words.items()]
    if lay["w_stage"]:
        out.append(("w", lay["w_off"], max(
            dims[l] * _ru4(dims[l + 1]) for l in range(1, len(dims) - 1)
            if lay["w_stage"] >> l & 1)))
    return out


def _disjoint(spans):
    spans = sorted(spans)
    for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
        assert end <= start, (a, b)


def test_served_request_runs_one_wave_of_clusters():
    plan = _plan()
    lay = dict(plan.layout)
    assert plan.route == "cluster" and plan.cluster == 2
    assert plan.grid == 2 * SERVED["t"] == 210 and plan.threads == 256
    assert plan.ctas_per_sm == 2 and plan.waves == 1
    assert plan.ctas_per_sm * (plan.smem_bytes + RESERVED_SMEM) \
        <= OPTIN + RESERVED_SMEM
    # the head's weights lie in the layer buffers, dead by then; W of layer
    # 2 is staged, layer 1's (32 KB) would cost a CTA an SM
    assert lay["headw_off"] < lay["hw_off"] + 64 * lay["ldh"]
    assert lay["w_stage"] == 1 << 2


def test_rows_are_padded_4_mod_32_at_served_widths():
    lay = dict(_plan().layout)
    assert lay["lda"] % 32 == 4 and lay["lda"] >= 64
    assert lay["ldh"] % 32 == 4 and lay["ldh"] >= 128


@pytest.mark.parametrize("t", (1, 2, 3, 105, 132, 133, 1000))
def test_grid_is_two_ctas_a_tile_and_one_wave_up_to_132_clusters(t):
    plan = _plan(t=t)
    assert plan.grid == 2 * t and plan.ctas_per_sm == 2
    assert plan.waves == -(-2 * t // (SMS * 2))
    assert (plan.waves == 1) == (t <= SMS)


@pytest.mark.parametrize("dims", (AIDS, NARROW, DEEP, ODD, (29, 32)),
                         ids=("aids", "narrow", "eight_layers",
                              "eight_odd_widths", "one_layer"))
@pytest.mark.parametrize("shape", (SERVED, dict(t=3, nb=30, p=16),
                                   dict(t=1, nb=61, p=5),
                                   dict(t=7, nb=16, p=8),
                                   dict(t=2, nb=128, p=16)),
                         ids=("served", "nb30", "odd", "nb16", "nb128"))
def test_every_buffer_is_disjoint_and_inside_the_opt_in_limit(dims, shape):
    plan = _plan(dims=dims, **shape)
    assert plan.route == "cluster"
    lay = dict(plan.layout)
    assert plan.smem_bytes == 4 * lay["smem_floats"] <= OPTIN
    assert lay["ldh"] % 4 == 0 and lay["ldh"] >= max(dims[1:])
    assert lay["lda"] % 4 == 0 and lay["lda"] >= shape["nb"]
    spans = {}
    for name, start, words in _buffers(plan, shape["nb"], shape["p"], dims,
                                       HEAD):
        assert start % 4 == 0, name           # float4 / 16-byte aligned
        assert 0 <= start and start + words <= lay["smem_floats"], name
        spans[name] = (start, start + words, name)
    # the pooling and head buffers may lie in the layer buffers past the
    # last layer's H (stride F | 1), dead by the time they are written
    last_h = _ru4(_ru4(shape["nb"]) * (dims[-1] | 1))
    _disjoint([v for k, v in spans.items() if k not in POOL])
    _disjoint([v for k, v in spans.items() if k not in LAYERS + ("w",)]
              + [(lay["h_off"], lay["h_off"] + last_h, "last H")])


def test_staged_w_never_costs_a_cta_an_sm():
    for dims in (AIDS, NARROW, DEEP, ODD):
        for nb in (16, 30, 64, 100):
            plan = _plan(dims=dims, nb=nb)
            lay = dict(plan.layout)
            if not lay["w_stage"]:
                continue
            without = 4 * lay["w_off"]        # W is carved last
            assert plan.ctas_per_sm == min(2, (OPTIN + RESERVED_SMEM) // (
                without + RESERVED_SMEM))
            assert lay["w_stage"] & 1 == 0    # layer 0 is a row gather


def test_large_nb_takes_the_single_route():
    # NTN K 40 (a 160 KB tensor): NB 40 still fits a cluster layout at one
    # CTA an SM, NB 48 and 64 only the one-CTA-per-tile kernel's
    assert _plan(nb=40, head=WIDE_HEAD).route == "cluster"
    for nb in (48, 64):
        plan = _plan(nb=nb, head=WIDE_HEAD)
        assert plan.route == "single" and plan.cluster == 1
        assert plan.grid == 105 and plan.threads == 256
        assert dict(plan.layout)["route"] == 0
        f, fmax, p = 32, 128, 16                  # packed_smem_bytes
        assert plan.smem_bytes == 4 * (nb * nb + 2 * nb * fmax + 4 * p * f
                                       + 3 * nb + 8 * 2 * 64 + 2 * nb)
    # at AIDS widths the cluster layout is the smaller one, up to NB 140
    assert _plan(nb=140).route == "cluster"


def test_sizes_that_do_not_fit_are_refused_by_name():
    with pytest.raises(ValueError, match=r"widths \(29, 128, 64, 32\)"):
        _plan(nb=144)
    with pytest.raises(ValueError, match=r"widths \(29, 1024, 512\)"):
        _plan(dims=(29, 1024, 512))
    with pytest.raises(ValueError, match="GCN layers"):
        _plan(dims=(29,) + (8,) * 9)
    with pytest.raises(ValueError, match="positive"):
        _plan(p=0)
    with pytest.raises(ValueError, match=r"head \(65, 8, 4, 1\)"):
        _plan(head=(65, 8, 4, 1))


def test_layout_fills_the_c_struct_field_by_field():
    plan = _plan()
    s = _layout_struct(plan)
    assert ctypes.sizeof(PackedLayout) == 4 * 27
    assert [k for k, _ in plan.layout] == [k for k, _ in PackedLayout._fields_]
    for k, v in plan.layout:
        assert getattr(s, k) == v, k


# ----------------------------------------- the cluster route's loop bounds

def _fma(a, b, acc):
    """One float32 multiply-add. The emulation rounds twice (float64, then
    float32), which can differ from fmaf in the last bit; both chains below
    use it, and the rule under test only needs fma(±0, x, acc) == acc for
    finite x and acc != -0, which holds for it as for fmaf."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(acc))


def _chain(row, hw, j, ks):
    acc = np.float32(0.0)
    for k in ks:
        acc = _fma(row[k], hw[k, j], acc)
    return acc


def _ranges(a):
    """Each row's first and last column whose entry is not ±0 (NaN counts),
    as the kernel's ballots find them; (n, -1) for a row of zeros."""
    out = []
    for row in a:
        nz = np.flatnonzero((row != 0) | np.isnan(row))
        out.append((int(nz[0]), int(nz[-1])) if nz.size else (len(row), -1))
    return out


def _kernel_h(a, hw, tm, kfull):
    """H = relu(A' HW) by the kernel's rule: rows in tiles of tm, a tile's
    chain over the union of its rows' ranges (start rounded down to a
    multiple of 4) when every HW entry is finite, else over k < kfull."""
    n, f = a.shape[0], hw.shape[1]
    ranged = bool(np.isfinite(hw[:kfull]).all())
    rng = _ranges(a)
    out = np.zeros((n, f), np.float32)
    for r0 in range(0, n, tm):
        rows = range(r0, min(n, r0 + tm))
        kb, ke = 0, kfull
        if ranged:
            kb = min(rng[i][0] for i in rows) & ~3
            ke = max(rng[i][1] + 1 for i in rows)
        for i in rows:
            for j in range(f):
                out[i, j] = _chain(a[i], hw, j, range(kb, ke))
    return out


def _full_h(a, hw):
    n, f = a.shape[0], hw.shape[1]
    return np.array([[_chain(a[i], hw, j, range(hw.shape[0]))
                      for j in range(f)] for i in range(n)], np.float32)


def _same_bits(x, y):
    nx, ny = np.isnan(x), np.isnan(y)
    return np.array_equal(nx, ny) and np.array_equal(
        x[~nx].view(np.uint32), y[~ny].view(np.uint32))


def _block_adjacency(rng, sizes, n, dense=False):
    """A raw A' with the kernel's masking: graphs of `sizes` nodes on the
    diagonal (or, dense, random entries over all live rows), -0 in some
    zero cells, pad rows past the graphs."""
    a = np.zeros((n, n), np.float32)
    live = sum(sizes)
    if dense:
        a[:live, :live] = rng.random((live, live)) < 0.5
    else:
        o = 0
        for s in sizes:
            a[o:o + s, o:o + s] = rng.random((s, s)) < 0.3
            o += s
    a[np.arange(live), np.arange(live)] += 1.0
    a[(a == 0) & (rng.random((n, n)) < 0.3)] = -0.0
    return a * rng.uniform(0.2, 1.0, (n, 1)).astype(np.float32)


@pytest.mark.parametrize("poison", (None, np.nan, np.inf, -np.inf, -0.0),
                         ids=("finite", "nan", "inf", "-inf", "-0"))
@pytest.mark.parametrize("dense", (False, True), ids=("blocks", "dense"))
@pytest.mark.parametrize("tm", (4, 2))
def test_ranged_chains_have_the_bits_of_the_full_chains(poison, dense, tm):
    rng = np.random.default_rng(11 + tm)
    for _ in range(3):
        sizes = list(rng.integers(3, 9, rng.integers(1, 4)))
        n = 28
        a = _block_adjacency(rng, sizes, n, dense)
        hw = rng.standard_normal((n, 3)).astype(np.float32)
        hw[rng.random((n, 3)) < 0.2] = -0.0
        if poison is not None:
            hw[rng.integers(0, n), rng.integers(0, 3)] = poison
        with np.errstate(invalid="ignore", over="ignore"):
            assert _same_bits(_kernel_h(a, hw, tm, n), _full_h(a, hw))


def test_degree_sums_over_each_rows_range_have_the_full_sums_bits():
    rng = np.random.default_rng(3)
    for dense in (False, True):
        a = _block_adjacency(rng, [5, 7, 3], 20, dense)
        a[2, 4] = np.nan
        a[9, 11] = -3.0
        for i, (lo, hi) in enumerate(_ranges(a)):
            full, part = np.float32(0.0), np.float32(0.0)
            for k in range(a.shape[1]):
                full = np.float32(full + a[i, k])
            for k in range(lo, hi + 1):
                part = np.float32(part + a[i, k])
            assert _same_bits(np.array([part]), np.array([full])), i
