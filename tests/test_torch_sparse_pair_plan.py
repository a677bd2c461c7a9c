"""The packed-sparse kernel's launch plan and overflow bucketing
(`kernels/sparse_pair.py` `sparse_pair_plan`, `overflow_buckets`), on the
CPU. The plan is a pure function of the shapes and the card's limits, so
it is checked here at the H100's (132 SMs, 232448 opt-in shared bytes a
block) without a card: one tile per 2-CTA cluster, the grid, the block,
the CTAs an SM holds and the shared-memory layout the kernel carves. The
bucketing is the kernel's per-receiver overflow lists as host code; the
tests check its order, what it keeps and that each row's fmaf chain over
the kept slots has the bits of the chain over every slot."""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.configs.simgnn_aids import CONFIG
from repro_torch.core import batching
from repro_torch.core.simgnn import SimGNNConfig
from repro_torch.data.graphs import query_pairs
from repro_torch.kernels.fused_gcn import RESERVED_SMEM
from repro_torch.kernels.sparse_pair import (SparseLayout, _layout_struct,
                                             overflow_buckets,
                                             sparse_pair_plan)

SMS, OPTIN = 132, 232448
AIDS = CONFIG.feature_dims                        # (29, 128, 64, 32)
NARROW = SimGNNConfig(gcn_dims=(16, 8, 8, 4)).feature_dims
DEEP = (29, 128, 128, 64, 64, 32, 32, 16, 16)     # eight layers
ODD = (29, 24, 20, 16, 12, 10, 8, 6, 5)           # eight, off the float4 tile
SERVED = dict(t=104, nb=64, d=4, e_ov=32, p=16)   # a 256-pair request
HEAD = (CONFIG.ntn_k,) + tuple(CONFIG.fcn_dims) + (1,)   # K, FCN .., 1


def _plan(t=104, nb=64, d=4, e_ov=32, p=16, dims=AIDS, head=HEAD):
    return sparse_pair_plan(t, nb, d, e_ov, p, dims, SMS, OPTIN, head=head)


POOL = ("mean", "c", "att", "hg", "hgp", "head")


def _buffers(plan, nb, d, e_ov, p, dims):
    """(name, start, words) of every buffer the kernel carves."""
    lay = dict(plan.layout)
    k, fcn = HEAD[0], HEAD[1:]
    rows, f = (nb + 3) // 4 * 4, dims[-1]
    words = {"hw": rows * lay["ldh"], "h": rows * lay["ldh"],
             "mean": p * f, "c": p * f, "att": nb, "hg": p * f, "hgp": p * f,
             "head": 8 * 2 * 64, "nw": nb * d, "ovw": e_ov, "mask": nb,
             "pm": p, "nbr": nb * d, "ovs": e_ov, "ovr": e_ov,
             "list": e_ov, "rowoff": nb, "rowcnt": nb, "rowlast": nb,
             "labels": nb, "seg": nb, "live": p + 1, "need": p,
             "segs": p + 1, "headw": _ru4(k * 2 * f) + _ru4(k) + sum(
                 _ru4(a * b) + _ru4(b) for a, b in zip((k,) + fcn[:-1], fcn))}
    return [(k, lay[f"{k}_off"], n) for k, n in words.items()]


def _ru4(x):
    return (x + 3) // 4 * 4


def _disjoint(spans):
    spans = sorted(spans)
    for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
        assert end <= start, (a, b)


def test_served_request_runs_one_wave_of_clusters():
    plan = _plan()
    lay = dict(plan.layout)
    assert lay["hg_off"] < lay["h_off"]       # the pooling reuses HW
    assert plan.route == "cluster" and plan.cluster == 2
    assert plan.grid == 2 * SERVED["t"] == 208 and plan.threads == 256
    assert plan.ctas_per_sm == 2 and plan.waves == 1
    assert plan.ctas_per_sm * (plan.smem_bytes + RESERVED_SMEM) \
        <= OPTIN + RESERVED_SMEM


@pytest.mark.parametrize("t", (1, 2, 3, 104, 133, 1000))
def test_grid_is_two_ctas_a_tile(t):
    plan = _plan(t=t)
    assert plan.grid == 2 * t
    assert plan.waves == -(-2 * t // (SMS * plan.ctas_per_sm))


@pytest.mark.parametrize("d,e_ov", [(4, 8), (4, 16), (4, 32), (4, 64),
                                    (4, 128), (2, 8), (2, 32), (2, 64),
                                    (2, 128), (1, 256)])
def test_spill_and_growth_keep_two_ctas_an_sm(d, e_ov):
    plan = _plan(d=d, e_ov=e_ov)
    assert plan.ctas_per_sm == 2 and plan.waves == 1
    assert dict(plan.layout)["smem_floats"] * 4 == plan.smem_bytes


@pytest.mark.parametrize("dims", (AIDS, NARROW, DEEP, ODD, (29, 32)),
                         ids=("aids", "narrow", "eight_layers",
                              "eight_odd_widths", "one_layer"))
@pytest.mark.parametrize("shape", (SERVED, dict(t=3, nb=64, d=2, e_ov=128,
                                                p=16),
                                   dict(t=1, nb=61, d=3, e_ov=7, p=5)),
                         ids=("served", "spill", "odd"))
def test_every_buffer_is_disjoint_and_inside_the_opt_in_limit(dims, shape):
    plan = _plan(dims=dims, **shape)
    lay = dict(plan.layout)
    assert plan.smem_bytes == 4 * lay["smem_floats"] <= OPTIN
    assert lay["ldh"] % 4 == 0 and lay["ldh"] >= max(dims[1:]) + 4
    spans = {}
    for name, start, words in _buffers(plan, shape["nb"], shape["d"],
                                       shape["e_ov"], shape["p"], dims):
        assert start % 4 == 0, name           # float4 / 16-byte aligned
        assert 0 <= start and start + words <= lay["smem_floats"], name
        spans[name] = (start, start + words, name)
    # HW is dead once the pooling starts, so the pooling and head buffers
    # may lie in it; everything else stays apart the whole launch
    _disjoint([v for k, v in spans.items() if k not in POOL])
    _disjoint([v for k, v in spans.items() if k != "hw"])


def test_the_head_weights_are_given_room_by_their_widths():
    lay = dict(_plan().layout)
    k, fcn = HEAD[0], HEAD[1:]              # (16, 8, 4, 1): 1217 floats
    room = 16 * 64 + 16 + sum(_ru4(a * b) + _ru4(b)
                              for a, b in zip((k,) + fcn[:-1], fcn))
    assert lay["smem_floats"] - lay["headw_off"] == room
    wide = dict(_plan(head=(64, 64, 64, 1)).layout)
    assert wide["smem_floats"] - wide["headw_off"] > room


def test_widths_that_do_not_fit_are_refused_by_name():
    with pytest.raises(ValueError, match=r"widths \(29, 1024, 512\)"):
        _plan(dims=(29, 1024, 512))
    with pytest.raises(ValueError, match=r"head widths \(64, 64"):
        _plan(head=(64,) + (64,) * 8 + (1,), nb=256, p=64)
    with pytest.raises(ValueError, match="GCN layers"):
        _plan(dims=(29,) + (8,) * 9)
    with pytest.raises(ValueError, match="positive"):
        _plan(d=0)


def test_layout_fills_the_c_struct_field_by_field():
    plan = _plan()
    s = _layout_struct(plan)
    assert ctypes.sizeof(SparseLayout) == 4 * 27
    assert [k for k, _ in plan.layout] == [k for k, _ in SparseLayout._fields_]
    for k, v in plan.layout:
        assert getattr(s, k) == v, k


# ------------------------------------------------ the overflow bucketing

def _fma(w, x, acc):
    """float32 fmaf on these operands: the product of two float32 values is
    exact in float64, so one float32 rounding of the float64 sum is fmaf
    wherever the sum is exact (every zero-weight slot)."""
    return np.float32(np.float64(w) * np.float64(x) + np.float64(acc))


def _chain(slots, snd, w, x):
    acc = np.float32(0.0)
    for e in slots:
        acc = _fma(w[e], x[snd[e]], acc)
    return acc


def _bits(v):
    return "nan" if np.isnan(v) else np.float32(v).view(np.uint32)


def test_buckets_keep_ascending_slot_order_and_pads_in_row_0():
    snd = np.array([3, 1, 0, 2, 0, 0, 5, 0, 0], np.int16)
    rcv = np.array([2, 2, 0, 7, 0, 0, 2, 0, 9], np.int16)
    w = np.array([.5, .25, .75, 1., 0., 0., .125, 0., 0.], np.float32)
    rows = overflow_buckets(snd, rcv, w, 8)
    assert rows[2] == [0, 1, 6]          # ascending, receiver 2
    assert rows[7] == [3]
    assert rows[0] == [2, 4]             # a real edge, then one pad of the run
    assert sum(map(len, rows)) == 6      # receiver 9 is not a row: dropped


def test_buckets_drop_only_repeats_of_the_slot_kept_before():
    snd = np.array([0, 0, 1, 0, 0, 1, 1], np.int16)
    rcv = np.zeros(7, np.int16)
    w = np.array([0., 0., 0., 0., -0., .5, .5], np.float32)
    # 1: repeat of 0; 2: another sender; 3: not a repeat of 2; 4: -0 differs
    # from 3's +0; 6: non-zero weight, kept though it repeats 5
    assert overflow_buckets(snd, rcv, w, 4)[0] == [0, 2, 3, 4, 5, 6]


@pytest.mark.parametrize("x0", (0.0, -0.0, 1.5, -2.0, np.inf, -np.inf,
                                np.nan, 1e-45))
def test_dropped_slots_change_no_bit_of_the_row_chain(x0):
    rng = np.random.default_rng(0)
    for _ in range(50):
        e_ov, n = 24, 6
        snd = rng.integers(0, n, e_ov).astype(np.int16)
        snd[rng.random(e_ov) < 0.5] = 0
        rcv = rng.integers(0, 3, e_ov).astype(np.int16)
        w = rng.standard_normal(e_ov).astype(np.float32)
        w[rng.random(e_ov) < 0.6] = 0.0
        w[rng.random(e_ov) < 0.2] = -0.0
        x = rng.standard_normal(n).astype(np.float32)
        x[0] = x0
        x[rng.integers(1, n)] = -0.0
        rows = overflow_buckets(snd, rcv, w, 3)
        for r in range(3):
            every = [e for e in range(e_ov) if rcv[e] == r]
            assert rows[r] == sorted(rows[r]) and set(rows[r]) <= set(every)
            with np.errstate(invalid="ignore"):
                assert _bits(_chain(rows[r], snd, w, x)) == \
                    _bits(_chain(every, snd, w, x))


def test_buckets_of_a_packed_request_keep_every_real_edge():
    pk, _ = batching.pack_pairs(query_pairs(1, 64), 64, slots_per_tile=16,
                                with_edges=True, edge_budget=128,
                                device="cpu")
    for ov in (pk.edges.overflow1, pk.edges.overflow2):
        snd, rcv = ov.senders.numpy(), ov.receivers.numpy()
        w, live = ov.weights.numpy(), ov.edge_mask.numpy() != 0
        assert live.any()
        for t in range(snd.shape[0]):
            rows = overflow_buckets(snd[t], rcv[t], w[t], 64)
            kept = sorted(e for row in rows for e in row)
            real = np.flatnonzero(live[t]).tolist()
            assert set(real) <= set(kept)
            pads = [e for e in kept if not live[t, e]]
            assert len(pads) == (1 if (~live[t]).any() else 0)
            assert all(rcv[t, e] == 0 for e in pads)
            assert torch.equal(torch.tensor(sorted(rows[0])),
                               torch.tensor(rows[0]))
