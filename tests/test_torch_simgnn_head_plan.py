"""The head kernel's launch plan (`kernels/simgnn_head.py`
`simgnn_head_plan`), on the CPU: a pure function of the shapes and the
card's limits, so it is checked here at the H100's (132 SMs, 232448
opt-in shared bytes a block) without a card. The plan is what the wrapper
launches with: route, grid, tile, CTAs per SM and the shared-memory layout
the kernel carves; the weight image is the layout the kernel indexes."""

import ctypes
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs.simgnn_aids import CONFIG
from repro_torch.core.simgnn import SimGNNConfig, init_simgnn_params
from repro_torch.kernels.fused_gcn import RESERVED_SMEM
from repro_torch.kernels.simgnn_head import (HEAD_F, HeadLayout,
                                             _layout_struct, _weight_image,
                                             simgnn_head_plan)

SMS, OPTIN = 132, 232448
AIDS = (16, 8, 4, 1)                              # K .. 1
NARROW_F = SimGNNConfig(gcn_dims=(16, 8, 8, 4)).gcn_dims[-1]
FCN8 = (16, 48, 40, 32, 24, 16, 8, 4, 1)          # eight FCN layers


TOOL = Path(__file__).resolve().parents[1] / "tools" / \
    "simgnn_head_parent_check.py"


def _parent_check():
    spec = importlib.util.spec_from_file_location("simgnn_head_parent_check",
                                                  TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plan(b, f=32, dims=AIDS, **kw):
    return simgnn_head_plan(b, f, dims[0], dims, SMS, OPTIN, **kw)


def _buffers(plan):
    """(name, start, floats) of every buffer the kernel carves in shared
    memory: the weight image, each row stage's h1 and h2 rows, and the two
    NTN-output / FCN buffers."""
    lay = dict(plan.layout)
    out = [("image", 0, lay["w_floats"])]
    tile_rows = plan.tile * lay["ldh"]
    for s in (0, 1):
        out += [(f"h1 rows {s}", lay["row_off"][s], tile_rows),
                (f"h2 rows {s}", lay["row_off"][s] + tile_rows, tile_rows)]
    out += [(f"ks {i}", lay["ks_off"][i], plan.tile * lay["kld"])
            for i in (0, 1)]
    return out


def test_aids_takes_the_tiled_route_at_every_batch_size():
    for b in range(1, 16385):
        plan = _plan(b)
        assert plan.route == "tiled", b
        assert plan.tiles * plan.tile >= b > (plan.tiles - 1) * plan.tile
        assert 1 <= plan.grid <= min(plan.tiles, SMS * plan.ctas_per_sm)


@pytest.mark.parametrize("b", (1, 7, 256, 1001, 8192))
def test_the_narrow_config_takes_the_warp_route(b):
    plan = _plan(b, f=NARROW_F)
    assert plan.route == "warp" and plan.layout == ()
    assert plan.grid * plan.tile >= b > (plan.grid - 1) * plan.tile


@pytest.mark.parametrize("b", (1, 2, 7, 31, 32, 33, 255, 256, 1001, 4096,
                               4224, 8192, 8193, 8448, 8480, 16384,
                               1 << 20))
def test_the_persistent_tiles_cover_every_pair_once(b):
    plan = _plan(b)
    seen = torch.zeros(b, dtype=torch.int32)
    for cta in range(plan.grid):
        for t in range(cta, plan.tiles, plan.grid):
            lo = t * plan.tile
            seen[lo:min(b, lo + plan.tile)] += 1
    assert bool((seen == 1).all())


def test_tiles_grow_with_the_batch():
    """8-pair tiles while each has an SM of its own (B <= 8 x 132), then
    32-pair tiles, the rerank (B 4096) and the exact scan (B 8192)
    included."""
    assert [_plan(b).tile for b in (1, 256, 1056, 1057, 2112, 2113, 4096,
                                    8192, 16384)] == [8, 8, 8, 32, 32, 32,
                                                      32, 32, 32]
    assert [_plan(b).grid for b in (1, 256, 4096, 8192, 16384)] == [
        1, 32, 128, 256, 2 * SMS]


@pytest.mark.parametrize("dims", (AIDS, FCN8, (40, 8, 4, 1), (48, 8, 4, 1),
                                  (50, 8, 4, 1)),
                         ids=("aids", "fcn8", "k40", "k48", "k50"))
@pytest.mark.parametrize("b", (1, 256, 4096, 8193))
def test_every_plan_fits_the_card_and_its_buffers_are_disjoint(dims, b):
    plan = _plan(b, dims=dims)
    assert plan.route == "tiled"
    lay = dict(plan.layout)
    assert plan.smem_bytes == 4 * lay["smem_floats"] <= OPTIN
    assert plan.ctas_per_sm * (plan.smem_bytes + RESERVED_SMEM) \
        <= OPTIN + RESERVED_SMEM
    assert plan.grid <= SMS * plan.ctas_per_sm
    assert lay["ldh"] % 32 == 4 and lay["kld"] % 2 == 1
    assert lay["kld"] >= max(dims) and lay["tile"] == plan.tile == 8 * plan.pt
    spans = []
    for name, start, floats in _buffers(plan):
        assert start % 4 == 0, name          # float4 loads and cp.async
        assert 0 <= start and start + floats <= lay["smem_floats"], name
        spans.append((start, start + floats, name))
    spans.sort()
    for (_, end, a), (start, _, b2) in zip(spans, spans[1:]):
        assert end <= start, (a, b2)


@pytest.mark.parametrize("dims", (AIDS, FCN8), ids=("aids", "fcn8"))
def test_the_weight_image_layout(dims):
    lay = dict(_plan(64, dims=dims).layout)
    k = dims[0]
    assert (lay["k"], lay["kp"]) == (k, (k + 1) // 2)
    assert lay["v_off"] == k * HEAD_F * HEAD_F
    assert lay["b_off"] == lay["v_off"] + 2 * HEAD_F * k
    off = lay["b_off"] + (k + 3) // 4 * 4
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        assert lay["fcn_w_off"][i] == off
        off += (din * dout + 3) // 4 * 4
        assert lay["fcn_b_off"][i] == off
        off += (dout + 3) // 4 * 4
    assert lay["w_floats"] == off


def test_the_weight_image_holds_what_the_kernel_indexes():
    """W[k, i, l + 4j] at ((k * F + i) * 4 + l) * 8 + j, V, b and every FCN
    layer at the layout's offsets."""
    p = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    image = _weight_image(p["ntn"], p["fcn"], torch.device("cpu"))
    lay = dict(_plan(64).layout)
    assert image.numel() == lay["w_floats"] and image.dtype == torch.float32
    w = p["ntn"]["w"]
    k_, i_, g_ = torch.meshgrid(*(torch.arange(n) for n in w.shape),
                                indexing="ij")
    at = ((k_ * HEAD_F + i_) * 4 + g_ % 4) * 8 + g_ // 4
    assert torch.equal(image[at], w)
    k = w.shape[0]
    v = image[lay["v_off"]:lay["v_off"] + 2 * HEAD_F * k]
    assert torch.equal(v.view(k, 2 * HEAD_F), p["ntn"]["v"])
    assert torch.equal(image[lay["b_off"]:lay["b_off"] + k], p["ntn"]["b"])
    for i, layer in enumerate(p["fcn"]):
        wo, bo = lay["fcn_w_off"][i], lay["fcn_b_off"][i]
        assert torch.equal(image[wo:wo + layer["w"].numel()],
                           layer["w"].reshape(-1))
        assert torch.equal(image[bo:bo + layer["b"].numel()], layer["b"])


def test_layout_fills_the_c_struct_field_by_field():
    plan = _plan(8192)
    s = _layout_struct(plan)
    assert ctypes.sizeof(HeadLayout) == 4 * (3 + 9 + 2 * 8 + 3 + 2 + 2 + 3
                                             + 1)
    for k, v in plan.layout:
        got = getattr(s, k)
        got = tuple(got[:len(v)]) if isinstance(v, tuple) else got
        assert got == v, k


def test_wide_heads_take_smaller_tiles_then_the_warp_route():
    assert _plan(8192, dims=(40, 8, 4, 1)).tile == 32
    assert _plan(8192, dims=(48, 8, 4, 1)).tile == 8
    assert _plan(8192, dims=(64, 8, 4, 1)).route == "warp"


def test_forced_pairs_a_thread():
    for pt in (1, 4):
        plan = _plan(8192, pt=pt)
        assert (plan.pt, plan.tile) == (pt, 8 * pt)
    with pytest.raises(ValueError, match="pairs a thread"):
        _plan(8192, pt=2)


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="FCN"):
        _plan(4, dims=(16,) + (8,) * 9 + (1,))
    with pytest.raises(ValueError, match="FCN"):
        _plan(4, dims=(16, 8, 2))
    with pytest.raises(ValueError, match="FCN"):
        _plan(4, dims=(16, 65, 1))
    with pytest.raises(ValueError, match="positive"):
        _plan(0)


@pytest.mark.parametrize("name", ("no_w_staging", "no_products",
                                  "no_epilogue_loads", "no_fcn",
                                  "half_w_loads"))
def test_each_ablation_of_the_parent_check_edits_the_kernel_once(name):
    """`tools/simgnn_head_parent_check.py --ablations` builds copies of
    `csrc/simgnn_head.cu` with one part of the work cut out by string
    edits: each edit must still find its text exactly once."""
    tool = _parent_check()
    src = (tool.build.CSRC / "simgnn_head.cu").read_text()
    for old, new in tool.ABLATIONS[name]:
        assert src.count(old) == 1 and new != old
