"""The embedding kernel's launch plan (`kernels/fused_gcn.py`
`fused_gcn_plan`), on the CPU: a pure function of the shapes and the
card's limits, so it is checked here at the H100's (132 SMs, 232448
opt-in shared bytes a block) without a card. The plan is what the wrapper
launches with: route, grid, block, CTAs per SM and the shared-memory
layout the kernel carves."""

import ctypes

import pytest
import torch

from repro_torch.configs.simgnn_aids import CONFIG
from repro_torch.core.simgnn import SimGNNConfig
from repro_torch.kernels.fused_gcn import (RESERVED_SMEM, GcnLayout,
                                           _layout_struct, fused_gcn_plan,
                                           gcn_dims)

SMS, OPTIN = 132, 232448
AIDS = CONFIG.feature_dims                        # (29, 128, 64, 32)
NARROW = SimGNNConfig(gcn_dims=(16, 8, 8, 4)).feature_dims
DEEP = (29, 128, 128, 64, 64, 32, 32, 16, 16)     # eight layers
SERVED = (8, 16, 32, 64)                          # core.batching buckets
OVERSIZE = (128, 256)


def _plan(b, n, dims=AIDS):
    return fused_gcn_plan(b, n, dims, SMS, OPTIN)


def _f_last(lay):
    return lay["dims"][lay["n_gcn"]]


def _buffers(plan):
    """(name, space, start, floats) of every buffer the kernel carves."""
    lay = dict(plan.layout)
    big = "smem" if plan.route == "shared" else "slot"
    out = []
    if lay["weights_in_smem"]:
        out.append(("weights", "smem", 0, lay["w_floats"]))
    for s in range(lay["stages"]):
        out += [(f"mask{s}", "smem", lay["m_off"][s], lay["np"]),
                (f"adj{s}", big, lay["a_off"][s], lay["np"] * lay["lda"]),
                (f"feats{s}", big, lay["f_off"][s], lay["np"] * lay["ldf"])]
    out += [("hw", big, lay["hw_off"], lay["np"] * lay["ldh"]),
            ("h", big, lay["h_off"], lay["np"] * lay["ldh"]),
            ("mean", "smem", lay["mean_off"], _f_last(lay)),
            ("c", "smem", lay["c_off"], _f_last(lay)),
            ("att", "smem", lay["att_s_off"], lay["np"]),
            ("neff", "smem", lay["neff_off"], 1)]
    return out


@pytest.mark.parametrize("n", SERVED)
@pytest.mark.parametrize("b", (1, 37, 1461, 5594))
def test_served_buckets_take_the_shared_route(b, n):
    plan = _plan(b, n)
    assert plan.route == "shared" and plan.weights_in_smem
    assert plan.scratch_floats == 0
    assert plan.stages == 2              # the next graph is staged
    assert plan.smem_bytes <= OPTIN


@pytest.mark.parametrize("n", OVERSIZE)
def test_oversize_buckets_take_the_scratch_route(n):
    plan = _plan(40, n)
    assert plan.route == "scratch"
    lay = dict(plan.layout)
    assert plan.scratch_floats == plan.grid * lay["slot_floats"] > 0
    assert plan.weights_in_smem          # 60.8 KB of AIDS weights still fit


def test_scratch_is_sized_per_resident_cta_not_per_graph():
    plan = _plan(5594, 256)
    assert plan.grid == SMS * plan.ctas_per_sm < 5594
    assert plan.scratch_floats == plan.grid * dict(plan.layout)["slot_floats"]


def test_large_batches_fill_every_sm_and_small_ones_run_a_cta_a_graph():
    b32, b64 = _plan(5594, 32), _plan(1461, 64)
    assert (b32.threads, b32.ctas_per_sm, b32.grid) == (256, 2, 2 * SMS)
    assert (b64.threads, b64.ctas_per_sm, b64.grid) == (512, 1, SMS)
    for b in (1, 7, 37, SMS):
        plan = _plan(b, 32)
        assert (plan.grid, plan.threads) == (b, 512)
    assert _plan(SMS + 1, 32).grid == SMS + 1


def test_one_graph_gets_one_cta():
    for n in SERVED + OVERSIZE:
        assert _plan(1, n).grid == 1


@pytest.mark.parametrize("dims", (AIDS, NARROW, DEEP),
                         ids=("aids", "narrow", "eight_layers"))
@pytest.mark.parametrize("n", SERVED + OVERSIZE)
@pytest.mark.parametrize("b", (1, 133, 5 * SMS + 3))
def test_every_plan_fits_the_card_and_its_buffers_are_disjoint(dims, n, b):
    plan = _plan(b, n, dims)
    lay = dict(plan.layout)
    assert plan.smem_bytes == 4 * lay["smem_floats"] <= OPTIN
    assert plan.threads in (256, 512) and 1 <= plan.grid <= b
    assert plan.grid <= SMS * plan.ctas_per_sm
    assert plan.ctas_per_sm * (plan.smem_bytes + RESERVED_SMEM) \
        <= OPTIN + RESERVED_SMEM
    assert lay["np"] >= n and lay["np"] % 4 == 0
    assert lay["lda"] >= lay["np"] and lay["ldf"] >= dims[0]
    assert lay["ldh"] >= max(dims[1:])
    for ld in ("lda", "ldf", "ldh", "ldatt"):
        assert lay[ld] % 4 == 0
    spaces = {"smem": lay["smem_floats"], "slot": lay["slot_floats"]}
    spans = {}
    for name, space, start, floats in _buffers(plan):
        assert start % 4 == 0, name      # float4 loads and cp.async
        assert 0 <= start and start + floats <= spaces[space], name
        spans.setdefault(space, []).append((start, start + floats, name))
    for ranges in spans.values():
        ranges.sort()
        for (_, end, a), (start, _, b2) in zip(ranges, ranges[1:]):
            assert end <= start, (a, b2)


@pytest.mark.parametrize("dims", (AIDS, NARROW, DEEP),
                         ids=("aids", "narrow", "eight_layers"))
def test_weight_image_is_padded_to_float4_rows(dims):
    lay = dict(_plan(4, 32, dims).layout)
    assert lay["n_gcn"] == len(dims) - 1
    assert lay["dims"] == tuple(dims)
    off = 0
    for l, (fin, fout) in enumerate(zip(dims[:-1], dims[1:])):
        assert lay["ldw"][l] == (fout + 3) // 4 * 4
        assert (lay["w_off"][l], lay["b_off"][l]) == (off,
                                                      off + fin * lay["ldw"][l])
        off = lay["b_off"][l] + lay["ldw"][l]
    assert lay["att_off"] == off
    assert lay["w_floats"] == off + dims[-1] * lay["ldatt"]
    assert lay["w_floats"] % 4 == 0


def test_layout_fills_the_c_struct_field_by_field():
    plan = _plan(5594, 64)
    s = _layout_struct(plan)
    assert ctypes.sizeof(GcnLayout) == 4 * (10 + 9 + 3 * 8 + 2 + 3 * 2 + 8)
    for k, v in plan.layout:
        got = getattr(s, k)
        got = tuple(got[:len(v)]) if isinstance(v, tuple) else got
        assert got == v, k


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="GCN layers"):
        _plan(4, 32, (29,) + (8,) * 9)
    with pytest.raises(ValueError, match="shared"):
        fused_gcn_plan(4, 2048, AIDS, SMS, 4096)


def test_gcn_dims_follow_the_params_tree():
    layers = [{"w": torch.zeros(29, 16), "b": torch.zeros(16)},
              {"w": torch.zeros(16, 8), "b": torch.zeros(8)}]
    assert gcn_dims(29, layers, torch.zeros(8, 8)) == (29, 16, 8)
    with pytest.raises(ValueError, match="layer 1"):
        gcn_dims(29, [layers[0], {"w": torch.zeros(12, 8),
                                  "b": torch.zeros(8)}], torch.zeros(8, 8))
    with pytest.raises(ValueError, match="att"):
        gcn_dims(29, layers, torch.zeros(8, 4))
