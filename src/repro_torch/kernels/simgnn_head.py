"""Fused NTN + FCN head on graph-embedding pairs — port of
`repro.kernels.simgnn_head`.

hg1/hg2 [B, F] -> [B] similarity scores in (0, 1): the K bilinear NTN
slices, the linear term, ReLU, the FCN stack and the sigmoid. The whole
per-query device cost of a warm exact 1-vs-N search, and the rerank of the
two-stage search.

`simgnn_head` launches the CUDA kernel `csrc/simgnn_head.cu` on CUDA
tensors and runs `simgnn_head_plain` on CPU tensors. `simgnn_head_plan`
(pure Python, a function of the shapes and the card's limits) picks the
route of each launch: the tiled route (F = 32: persistent CTAs walk tiles
of 8 or 32 pairs with the NTN weights resident in shared memory) or
the warp route (any other F, or weights that do not fit: one warp a pair,
PR 12's kernel), and the tiled route's grid and shared-memory layout. Any
B; the JAX wrapper's `block_pairs` padding has no counterpart. A pair's
score is the same bits on either route, at any batch size and position.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.common import layer_pairs, ntn_fcn_block, ntn_operands
from repro_torch.kernels.fused_gcn import RESERVED_SMEM, _ru4, device_limits

#: embedding width and threads of the tiled route's CTAs
HEAD_F = 32
THREADS = 256
#: CTAs an SM by registers (__launch_bounds__(256, 2)), pairs a thread
#: the kernel is built for
CTAS_BY_REGISTERS = 2
PAIRS_A_THREAD = (4, 1)
#: shared row stride of the staged h1/h2 rows: 4 mod 32 floats, so the
#: eight pair rows a warp reads at once fall on distinct banks
LDH = HEAD_F + 4
#: the warp route: pairs (warps) a CTA, CTAs an SM by threads
WARP_PAIRS = 8
WARP_CTAS = 2048 // THREADS


def simgnn_head_plain(hg1, hg2, ntn_params, fcn_params):
    """Plain PyTorch version: [B] scores."""
    f = hg1.shape[-1]
    return ntn_fcn_block(hg1.float(), hg2.float(), *ntn_operands(ntn_params, f),
                         layer_pairs(fcn_params))[:, 0]


@dataclass(frozen=True)
class HeadPlan:
    """One launch of `csrc/simgnn_head.cu`. `layout` holds the C struct
    `HeadLayout`'s fields, in floats (empty on the warp route)."""
    route: str              # "tiled" or "warp"
    grid: int
    threads: int
    tile: int               # pairs a tile (tiled) or a CTA (warp)
    pt: int                 # pairs a thread (tiled; 0 on the warp route)
    tiles: int
    ctas_per_sm: int        # what the plan counts on (shared bytes, registers)
    smem_bytes: int         # dynamic shared bytes
    layout: tuple           # ((field, value), ...)

    def summary(self) -> str:
        if self.route == "warp":
            return (f"warp route (one warp a pair), grid {self.grid} x "
                    f"{self.threads} threads")
        return (f"tiled route, {self.tiles} tile(s) of {self.tile} pairs "
                f"({self.pt} a thread), grid {self.grid} x {self.threads} "
                f"threads, {self.ctas_per_sm} CTA(s)/SM, {self.smem_bytes} "
                f"shared bytes")


def _image_layout(k: int, fcn_dims: tuple) -> dict:
    """Offsets (floats) of the weight image the tiled kernel copies to
    shared offset 0: W [K][F][4][8], V [K][2F], b [ru4(K)], then each FCN
    layer's w [din * dout] and b [dout], each padded to a multiple of 4."""
    v_off = k * HEAD_F * HEAD_F
    b_off = v_off + k * 2 * HEAD_F
    off = b_off + _ru4(k)
    w_offs, b_offs = [], []
    for din, dout in zip(fcn_dims[:-1], fcn_dims[1:]):
        w_offs.append(off)
        off += _ru4(din * dout)
        b_offs.append(off)
        off += _ru4(dout)
    return dict(v_off=v_off, b_off=b_off, w_floats=off,
                fcn_w_off=tuple(w_offs), fcn_b_off=tuple(b_offs))


def _warp_plan(b: int) -> HeadPlan:
    blocks = -(-b // WARP_PAIRS)
    return HeadPlan(route="warp", grid=blocks, threads=THREADS,
                    tile=WARP_PAIRS, pt=0, tiles=blocks,
                    ctas_per_sm=WARP_CTAS, smem_bytes=0, layout=())


@functools.lru_cache(maxsize=256)
def simgnn_head_plan(b: int, f: int, k: int, fcn_dims: tuple, sms: int,
                     smem_optin: int, pt: int | None = None) -> HeadPlan:
    """Route, grid, tile and shared layout of one launch of B pairs of
    width F through an NTN of K slices and an FCN of widths `fcn_dims` =
    (K, .., 1).

    F = 32 takes the tiled route wherever its layout fits the card's
    `smem_optin` bytes a block; any other F, or a layout that does not fit,
    the warp route. Tiles hold 8 * PT pairs: PT 1 while every 8-pair tile
    has an SM of its own (B <= 8 * sms), PT 4 above, and PT 1 where PT
    4's layout does not fit. On an H100 (tools/simgnn_head_parent_check.py
    --time) 8-pair tiles take ~6 us up to B 1056 and ~9 us once SMs hold
    two (each CTA copies the 64 KB NTN tensor), 32-pair tiles ~8 us up to
    B 4096. The grid is min(tiles, sms x CTAs an SM). `pt` forces the
    pairs a thread (for timing the alternatives)."""
    n_fcn = len(fcn_dims) - 1
    if b < 1 or f < 1 or k < 1:
        raise ValueError(f"simgnn_head takes positive sizes, got B {b}, "
                         f"F {f}, K {k}")
    if not 1 <= n_fcn <= build.MAX_FCN or fcn_dims[0] != k or \
            fcn_dims[-1] != 1 or max(fcn_dims) > build.MAX_HEAD:
        raise ValueError(f"kernels take 1..{build.MAX_FCN} FCN layers from "
                         f"K, widths <= {build.MAX_HEAD} ending in 1, got "
                         f"{fcn_dims}")
    if pt is not None and pt not in PAIRS_A_THREAD:
        raise ValueError(f"the tiled kernel is built for {PAIRS_A_THREAD} "
                         f"pairs a thread, got {pt}")
    if f != HEAD_F:
        return _warp_plan(b)
    first = pt or (1 if -(-b // 8) <= sms else 4)
    img = _image_layout(k, fcn_dims)
    widest = max(fcn_dims)
    kld = widest + 1 - widest % 2          # odd: the pair rows' banks differ
    for pt in PAIRS_A_THREAD[PAIRS_A_THREAD.index(first):]:
        # two stages of h1/h2 rows, then the NTN outputs and FCN buffers
        tile = 8 * pt
        rows, ks = 2 * tile * LDH, _ru4(tile * kld)
        row_off = (img["w_floats"], img["w_floats"] + rows)
        ks_off = (row_off[1] + rows, row_off[1] + rows + ks)
        smem_floats = ks_off[1] + ks
        if smem_floats * 4 <= smem_optin:
            break
    else:
        return _warp_plan(b)
    tiles = -(-b // tile)
    smem_bytes = smem_floats * 4
    ctas = min(CTAS_BY_REGISTERS,
               (smem_optin + RESERVED_SMEM) // (smem_bytes + RESERVED_SMEM))
    layout = dict(k=k, kp=(k + 1) // 2, n_fcn=n_fcn,
                  fcn_dims=tuple(fcn_dims),
                  **{n: img[n] for n in ("fcn_w_off", "fcn_b_off", "v_off",
                                         "b_off", "w_floats")},
                  tile=tile, ldh=LDH, row_off=row_off,
                  ks_off=ks_off, kld=kld, smem_floats=smem_floats)
    return HeadPlan(route="tiled", grid=min(tiles, sms * ctas),
                    threads=THREADS, tile=tile, pt=pt, tiles=tiles,
                    ctas_per_sm=ctas, smem_bytes=smem_bytes,
                    layout=tuple(layout.items()))


class HeadLayout(ctypes.Structure):
    """Mirror of `HeadLayout` in `csrc/simgnn_head.cu`."""
    _fields_ = ([(n, ctypes.c_int) for n in ("k", "kp", "n_fcn")]
                + [("fcn_dims", ctypes.c_int * (build.MAX_FCN + 1))]
                + [(n, ctypes.c_int * build.MAX_FCN)
                   for n in ("fcn_w_off", "fcn_b_off")]
                + [(n, ctypes.c_int) for n in ("v_off", "b_off", "w_floats",
                                               "tile", "ldh")]
                + [("row_off", ctypes.c_int * 2), ("ks_off", ctypes.c_int * 2),
                   ("kld", ctypes.c_int), ("smem_floats", ctypes.c_int)])


@functools.lru_cache(maxsize=256)
def _layout_struct(plan: HeadPlan) -> HeadLayout:
    s = HeadLayout()
    for name, v in plan.layout:
        if isinstance(v, tuple):
            arr = getattr(s, name)
            for i, x in enumerate(v):
                arr[i] = x
        else:
            setattr(s, name, v)
    return s


@functools.cache
def _lib():
    """The library with its entry points' signatures set once."""
    lib = build.library("simgnn_head")
    build.check_side_struct(lib, "simgnn_head_layout_size", HeadLayout)
    build.bind(lib.simgnn_head_launch, [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.POINTER(build.SimgnnParams),
        ctypes.c_void_p])
    build.bind(lib.simgnn_head_tiled_launch, [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.POINTER(HeadLayout)]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    build.bind(lib.simgnn_head_occupancy, [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_int)])
    return lib


def occupancy(plan: HeadPlan) -> int:
    """CTAs an SM of the current device holds for a tiled plan, as the
    CUDA runtime computes it (registers included): what `ctas_per_sm`
    counts on, checked on the card."""
    out = ctypes.c_int()
    build.check_launch(_lib().simgnn_head_occupancy(
        plan.pt, plan.smem_bytes, ctypes.byref(out)), "simgnn_head occupancy")
    return out.value


#: weight images by (device, identity and version of every leaf); each
#: entry holds the leaves themselves, so no key's ids can be reused.
_IMAGES: dict[tuple, tuple] = {}
_IMAGES_KEPT = 16


def _weight_image(ntn_params, fcn_params, device) -> torch.Tensor:
    """The float32 weight image of the tiled route (layout `_image_layout`),
    built once per params tree."""
    leaves = [ntn_params[n] for n in ("w", "v", "b")] + [
        t for p in fcn_params for t in (p["w"], p["b"])]
    key = (str(device),) + tuple((id(t), t._version) for t in leaves)
    hit = _IMAGES.get(key)
    if hit is not None:
        return hit[0]

    def flat(t):
        t = t.to(device).float().reshape(-1)
        return F.pad(t, (0, _ru4(t.numel()) - t.numel()))

    w = ntn_params["w"].to(device).float()
    k = w.shape[0]
    # W[k, i, l + 4j] -> [k][i][l][j]: a lane's eight columns are two float4
    parts = [w.reshape(k, HEAD_F, 8, 4).transpose(-1, -2).reshape(-1),
             flat(ntn_params["v"]), flat(ntn_params["b"])]
    for p in fcn_params:
        parts += [flat(p["w"]), flat(p["b"])]
    image = torch.cat(parts).contiguous()
    if len(_IMAGES) >= _IMAGES_KEPT:
        _IMAGES.pop(next(iter(_IMAGES)))
    _IMAGES[key] = (image, leaves)
    return image


def plan_for(b: int, f: int, ntn_params, fcn_params, device) -> HeadPlan:
    """The plan `simgnn_head` launches B pairs of width F with on
    `device`."""
    k = ntn_params["b"].shape[0]
    dims = (k,) + tuple(p["w"].shape[1] for p in fcn_params)
    return simgnn_head_plan(b, f, k, dims, *device_limits(device.index or 0))


def simgnn_head(hg1, hg2, ntn_params, fcn_params):
    """hg1/hg2 [B, F] graph embeddings -> [B] scores. CUDA tensors launch
    `csrc/simgnn_head.cu` with `simgnn_head_plan`'s route (counted in
    `simgnn_head.launches`, the plan kept in `simgnn_head.last_plan`); CPU
    tensors run the plain version."""
    if not on_cuda(hg1, hg2):
        return simgnn_head_plain(hg1, hg2, ntn_params, fcn_params)
    b, f = hg1.shape
    if ntn_params["w"].shape[-1] != f:
        raise ValueError(f"embedding width {f} != the NTN's "
                         f"{ntn_params['w'].shape[-1]}")
    dev = hg1.device
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    p1 = build.checked(hg1, "hg1", torch.float32, (b, f))
    p2 = build.checked(hg2, "hg2", torch.float32, (b, f))
    plan = plan_for(b, f, ntn_params, fcn_params, dev)
    launch(plan, p1, p2, out, ntn_params, fcn_params)
    simgnn_head.launches += 1
    simgnn_head.last_plan = plan
    return out


def launch(plan: HeadPlan, p1: int, p2: int, out: torch.Tensor, ntn_params,
           fcn_params) -> None:
    """One launch of `plan` on the checked h1/h2 pointers into `out`."""
    dev = out.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan.route == "tiled":
        image = _weight_image(ntn_params, fcn_params, dev)
        err = _lib().simgnn_head_tiled_launch(
            p1, p2, out.data_ptr(), out.numel(), image.data_ptr(),
            ctypes.byref(_layout_struct(plan)), plan.pt, plan.grid,
            plan.threads, plan.smem_bytes, stream)
    else:
        params, _keep = build.simgnn_params(
            {"ntn": ntn_params, "fcn": fcn_params}, dev)
        err = _lib().simgnn_head_launch(p1, p2, out.data_ptr(), out.numel(),
                                        ctypes.byref(params), stream)
    build.check_launch(err, "simgnn_head")


simgnn_head.launches = 0
simgnn_head.last_plan = None
