"""Bucketed single-pass pair-score megakernel — port of
`repro.kernels.fused_pair` (DESIGN.md §7).

Per padded graph pair: in-kernel normalization, the GCN stack on dense
one-hot features, per-graph Att pooling, NTN, FCN and sigmoid, the two
sides stacked as in the Pallas body. Serves the bucketed path, the
oversize fallback (power-of-two buckets beyond 64 nodes) and calls too
small to pack.

`fused_pair_score` launches the CUDA kernel `csrc/fused_pair.cu` on CUDA
tensors and runs `fused_pair_score_plain` on CPU tensors.
`fused_pair_plan` (pure Python, a function of the shapes and the card's
limits) picks the route of each launch: the cluster route (one pair per
cluster of 2 cs CTAs, cs CTAs a side, each owning a block of node rows;
its shared-memory layout) or, where its buffers fit no cluster, the single
route (one CTA a pair, A', H and HW in a global scratch buffer allocated
here when they do not fit shared memory). Both give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.common import (gcn_att_block, layer_pairs,
                                        normalize_adjacency_block,
                                        ntn_fcn_block, ntn_operands)
from repro_torch.kernels.fused_gcn import (RESERVED_SMEM, device_limits,
                                           gcn_dims)

#: threads a CTA (SIMGNN_THREADS)
THREADS = 256
#: CTAs an SM holds by registers: __launch_bounds__(256, 2)
CTAS_BY_REGISTERS = 2
#: CTAs a side the cluster route takes, most first (a cluster is 2 cs
#: CTAs, at most the portable 8); a side's block holds 16 rows at least
SIDE_CTAS = (4, 2, 1)
MIN_BLOCK_ROWS = 16


def fused_pair_score_plain(adj1, feats1, mask1, adj2, feats2, mask2,
                           gcn_params, att_w, ntn_params, fcn_params):
    """Plain PyTorch version: [B] scores."""
    b = adj1.shape[0]
    mask = torch.cat([mask1, mask2]).float()
    a_norm = normalize_adjacency_block(torch.cat([adj1, adj2]).float(), mask)
    hg = gcn_att_block(a_norm, torch.cat([feats1, feats2]).float(), mask,
                       layer_pairs(gcn_params), att_w)
    f = hg.shape[-1]
    return ntn_fcn_block(hg[:b], hg[b:], *ntn_operands(ntn_params, f),
                         layer_pairs(fcn_params))[:, 0]


def _ru4(x: int) -> int:
    return (x + 3) // 4 * 4


def row_blocks(rows: int, cs: int) -> tuple:
    """(start, stop) of each of cs CTAs' node rows when `rows` rows are
    split in blocks of ru4(ceil(rows / cs)): the plan's split of the bucket
    (rows = n) and the kernel's of the live rows (rows = nr)."""
    rb = _ru4(-(-rows // cs))
    return tuple((min(rows, q * rb), min(rows, (q + 1) * rb))
                 for q in range(cs))


@dataclass(frozen=True)
class FusedPlan:
    """One launch of `csrc/fused_pair.cu`. `layout` holds the C struct
    `FusedLayout`'s fields (in floats) on the cluster route, and is empty
    on the single route."""
    route: str              # "cluster" or "single"
    cluster: int            # CTAs a pair: 2 cs, or 1 on the single route
    side_ctas: int          # cs: CTAs a side, each owning a row block
    grid: int
    threads: int
    ctas_per_sm: int        # what the plan counts on (shared bytes, registers)
    waves: int              # grid / (SMs x CTAs an SM), rounded up
    smem_bytes: int
    window_rows: int        # HW rows a CTA holds at once (cluster route)
    row_blocks: tuple       # ((start, stop), ...) of the bucket's n rows
    scratch_floats: int     # global scratch of the whole launch
    layout: tuple           # ((field, value), ...)

    def summary(self) -> str:
        if self.route == "single":
            return (f"single route, grid {self.grid} x {self.threads} "
                    f"threads (one CTA a pair), {self.ctas_per_sm} CTA(s)/SM, "
                    f"{self.waves} wave(s), {self.smem_bytes} shared bytes"
                    + (f", scratch {self.scratch_floats * 4} bytes"
                       if self.scratch_floats else ""))
        return (f"cluster route, grid {self.grid} x {self.threads} threads "
                f"in clusters of {self.cluster} ({self.side_ctas} CTA(s) a "
                f"side, row blocks {list(self.row_blocks)}), "
                f"{self.ctas_per_sm} CTA(s)/SM, {self.waves} wave(s), "
                f"{self.smem_bytes} shared bytes, window {self.window_rows} "
                f"rows, W "
                f"{'staged' if dict(self.layout)['w_off'] >= 0 else 'global'}")


def _cluster_layout(n: int, f0: int, dims: tuple, cs: int, smem_optin: int,
                    stage_w: bool) -> dict | None:
    """The cluster route's layout fields at cs CTAs a side, or None when
    its buffers do not fit the opt-in shared memory (a window of 4 rows at
    least). With `stage_w` the kernel copies each layer's W into a shared
    buffer (by cp.async, while the layer before runs); without it the
    products read W from global memory (w_off -1)."""
    f_last, f_max = dims[-1], max(dims)
    np_, rbp = _ru4(n), _ru4(-(-n // cs))
    lda, ldf, ldh = np_ + 4, _ru4(f0) + 4, _ru4(f_max) + 4
    ldp = f_last | 1                     # odd: the Att stage reads columns
    fields = dict(n=n, f0=f0, cs=cs, rbp=rbp, lda=lda, ldf=ldf, ldh=ldh,
                  ldp=ldp, wr=0)
    off = 0

    def carve(name, words):
        nonlocal off
        fields[name] = off
        off += _ru4(words)

    carve("a_off", rbp * lda)
    carve("x_off", rbp * max(ldf, ldh))     # feats rows, then H rows
    carve("hwo_off", rbp * ldh)
    for name, words in (("mask_off", np_), ("inv_off", np_),
                        ("att_off", np_), ("mean_off", f_last),
                        ("c_off", f_last), ("hg_off", f_last),
                        ("hgp_off", 2 * f_last),
                        ("head_off", 2 * build.MAX_HEAD), ("int_off", 4)):
        carve(name, words)
    fields["w_off"] = -1
    if stage_w:
        widths = (f0,) + tuple(dims)
        carve("w_off", max(a * _ru4(b) for a, b in zip(widths, widths[1:])))
    cap = smem_optin // 4
    pool = np_ * ldp
    for pool_apart in (False, True):
        fixed = off + (_ru4(pool) if pool_apart else 0)
        wr = min(np_, (cap - fixed) // ldh // 4 * 4)
        if wr < 4:
            return None
        if pool_apart or wr * ldh >= pool:
            break
    fields["win_off"] = off
    off += wr * ldh
    if pool_apart:
        fields["pool_off"] = off
        off += _ru4(pool)
    else:
        fields["pool_off"] = fields["win_off"]
    fields["wr"] = wr
    fields["smem_floats"] = off
    return fields


#: FusedLayout's fields in C order
LAYOUT_FIELDS = ("n", "f0", "cs", "rbp", "lda", "ldf", "ldh", "ldp", "wr",
                 "a_off", "x_off", "hwo_off", "win_off", "pool_off",
                 "mask_off", "inv_off", "att_off", "mean_off", "c_off",
                 "hg_off", "hgp_off", "head_off", "int_off", "w_off",
                 "smem_floats")


def _single_smem(n: int, dims: tuple, smem_optin: int) -> tuple[int, int]:
    """(shared bytes, scratch floats a pair) of the single route: A', HW
    and H in shared memory when everything fits, else in scratch
    (`fused_pair_scratch_floats`)."""
    big = n * n + 2 * n * max(dims)
    small = 4 * dims[-1] + 3 * n + THREADS // 32 * 2 * build.MAX_HEAD
    if (big + small) * 4 <= smem_optin:
        return (big + small) * 4, 0
    return small * 4, big


@functools.lru_cache(maxsize=256)
def fused_pair_plan(b: int, n: int, f0: int, dims: tuple, ntn_k: int,
                    fcn_dims: tuple, sm_count: int,
                    smem_optin: int) -> FusedPlan:
    """Route, grid, block and shared layout of one launch on B pairs padded
    to n nodes, f0 labels, GCN widths `dims` = (f1, .., f_L), NTN K `ntn_k`
    and FCN widths `fcn_dims` (.., 1).

    The cluster route takes cs = 4, 2 or 1 CTAs a side (blocks of 16 rows
    at least): the most whose grid of 2 cs B CTAs fits one wave, else the
    fewest that fit shared memory. Where no cs fits (the widths' A' and HW
    rows beyond the opt-in limit, at AIDS widths the bucket 512), the
    single route runs the one-CTA-a-pair kernel. Raises ValueError for
    what the kernels do not take."""
    n_gcn = len(dims)
    if not 1 <= n_gcn <= build.MAX_GCN:
        raise ValueError(f"fused_pair takes 1..{build.MAX_GCN} GCN layers, "
                         f"got widths {dims}")
    if min(b, n, f0, ntn_k, *dims, *fcn_dims) < 1:
        raise ValueError(f"fused_pair takes positive sizes, got B {b}, n "
                         f"{n}, f0 {f0}, widths {dims}, K {ntn_k}, FCN "
                         f"{fcn_dims}")
    if max(ntn_k, *fcn_dims) > build.MAX_HEAD or fcn_dims[-1] != 1:
        raise ValueError(f"fused_pair takes NTN K and FCN widths <= "
                         f"{build.MAX_HEAD} ending in 1, got K {ntn_k}, FCN "
                         f"{fcn_dims}")

    def per_sm(smem_bytes):
        return min(CTAS_BY_REGISTERS, (smem_optin + RESERVED_SMEM)
                   // (smem_bytes + RESERVED_SMEM))

    fits = []
    for cs in SIDE_CTAS:
        if cs > 1 and n < MIN_BLOCK_ROWS * cs:
            continue
        fields = _cluster_layout(n, f0, dims, cs, smem_optin, False)
        if fields is None:
            continue
        # W staged in shared memory where that costs no window row and no
        # CTA an SM
        staged = _cluster_layout(n, f0, dims, cs, smem_optin, True)
        if staged is not None and staged["wr"] == fields["wr"] and per_sm(
                4 * staged["smem_floats"]) == per_sm(4 * fields["smem_floats"]):
            fields = staged
        fits.append((cs, fields))
    if fits:
        wave = [x for x in fits
                if 2 * x[0] * b <= sm_count * per_sm(4 * x[1]["smem_floats"])]
        cs, fields = wave[0] if wave else fits[-1]
        smem_bytes = 4 * fields["smem_floats"]
        grid, ctas = 2 * cs * b, per_sm(smem_bytes)
        return FusedPlan(
            route="cluster", cluster=2 * cs, side_ctas=cs, grid=grid,
            threads=THREADS, ctas_per_sm=ctas,
            waves=-(-grid // (sm_count * ctas)), smem_bytes=smem_bytes,
            window_rows=fields["wr"], row_blocks=row_blocks(n, cs),
            scratch_floats=0,
            layout=tuple((k, fields[k]) for k in LAYOUT_FIELDS))
    smem_bytes, scratch = _single_smem(n, dims, smem_optin)
    if smem_bytes > smem_optin:
        raise ValueError(f"fused_pair: bucket {n} at GCN widths {dims} needs "
                         f"{smem_bytes} shared bytes on every route, more "
                         f"than the card's {smem_optin}")
    ctas = max(1, min(2048 // THREADS, (smem_optin + RESERVED_SMEM)
                      // (smem_bytes + RESERVED_SMEM)))
    return FusedPlan(route="single", cluster=1, side_ctas=1, grid=b,
                     threads=THREADS, ctas_per_sm=ctas,
                     waves=-(-b // (sm_count * ctas)), smem_bytes=smem_bytes,
                     window_rows=0, row_blocks=((0, n),),
                     scratch_floats=b * scratch, layout=())


class FusedSide(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("adj", "feats", "mask")]


class FusedLayout(ctypes.Structure):
    """Mirror of `FusedLayout` in `csrc/fused_pair.cu`."""
    _fields_ = [(k, ctypes.c_int) for k in LAYOUT_FIELDS]


@functools.lru_cache(maxsize=256)
def _layout_struct(plan: FusedPlan) -> FusedLayout:
    s = FusedLayout()
    for k, v in plan.layout:
        setattr(s, k, v)
    return s


@functools.cache
def _lib():
    """The library, its structs checked and signatures set once."""
    lib = build.library("fused_pair")
    build.check_side_struct(lib, "fused_side_size", FusedSide)
    build.check_side_struct(lib, "fused_layout_size", FusedLayout)
    build.bind(lib.fused_pair_score_launch, [
        ctypes.POINTER(FusedSide), ctypes.POINTER(FusedSide),
        ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.POINTER(build.SimgnnParams), ctypes.c_void_p])
    build.bind(lib.fused_pair_cluster_launch, [
        ctypes.POINTER(FusedSide), ctypes.POINTER(FusedSide),
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(build.SimgnnParams),
        ctypes.POINTER(FusedLayout), ctypes.c_void_p])
    build.bind(lib.fused_pair_max_clusters,
               [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    return lib


def max_clusters(plan: FusedPlan) -> int:
    """Clusters of a cluster-route plan the current device holds at once,
    as the CUDA runtime computes it (registers included)."""
    out = ctypes.c_int()
    build.check_launch(_lib().fused_pair_max_clusters(
        plan.cluster, plan.smem_bytes, ctypes.byref(out)),
        "fused_pair occupancy")
    return out.value


def plan_for(b: int, n: int, f0: int, gcn_params, att_w, ntn_params,
             fcn_params, device: torch.device) -> FusedPlan:
    """`fused_pair_plan` of a launch with these weights on `device`."""
    dims = gcn_dims(f0, gcn_params, att_w)[1:]
    fcn = tuple(layer["w"].shape[1] for layer in fcn_params)
    return fused_pair_plan(b, n, f0, dims, ntn_params["b"].shape[0], fcn,
                           *device_limits(device.index))


def fused_pair_score(adj1, feats1, mask1, adj2, feats2, mask2, gcn_params,
                     att_w, ntn_params, fcn_params):
    """Raw adjacency / one-hot feats / masks of B padded pairs -> [B]
    scores. CUDA tensors launch `csrc/fused_pair.cu` (counted in
    `fused_pair_score.launches`, with the plan in
    `fused_pair_score.last_plan`); CPU tensors run the plain version."""
    args = (adj1, feats1, mask1, adj2, feats2, mask2)
    if not on_cuda(*args):
        return fused_pair_score_plain(*args, gcn_params, att_w, ntn_params,
                                      fcn_params)
    b, n, _ = adj1.shape
    f0 = feats1.shape[-1]
    dev = adj1.device
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = _lib()
    sides = [FusedSide(
        build.checked(adj, f"adj{s + 1}", torch.float32, (b, n, n)),
        build.checked(ft, f"feats{s + 1}", torch.float32, (b, n, f0)),
        build.checked(msk, f"mask{s + 1}", torch.float32, (b, n)))
        for s, (adj, ft, msk) in enumerate((args[:3], args[3:]))]
    if gcn_params[0]["w"].shape[0] != f0:
        raise ValueError(f"feats width {f0} != first GCN layer's "
                         f"{gcn_params[0]['w'].shape[0]}")
    params, _keep = build.simgnn_params(
        {"gcn": gcn_params, "att": {"w": att_w}, "ntn": ntn_params,
         "fcn": fcn_params}, dev)
    plan = plan_for(b, n, f0, gcn_params, att_w, ntn_params, fcn_params, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan.route == "cluster":
        err = lib.fused_pair_cluster_launch(
            ctypes.byref(sides[0]), ctypes.byref(sides[1]), out.data_ptr(), b,
            ctypes.byref(params), ctypes.byref(_layout_struct(plan)), stream)
    else:
        scratch = (torch.empty(plan.scratch_floats, dtype=torch.float32,
                               device=dev) if plan.scratch_floats else None)
        err = lib.fused_pair_score_launch(
            ctypes.byref(sides[0]), ctypes.byref(sides[1]), out.data_ptr(),
            b, n, f0, None if scratch is None else scratch.data_ptr(),
            ctypes.byref(params), stream)
    build.check_launch(err, "fused_pair")
    fused_pair_score.launches += 1
    fused_pair_score.last_plan = plan
    return out


fused_pair_score.launches = 0
fused_pair_score.last_plan = None
