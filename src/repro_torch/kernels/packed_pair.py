"""Node-packed pair-score megakernel with dense tile adjacency — port of
`repro.kernels.packed_pair` (DESIGN.md §8).

Per packed tile: both sides' block-diagonal raw adjacency normalized in
the kernel to D^-1/2 (A + I) D^-1/2 under the node mask, the GCN stack
with dense aggregation A'·(HW) and a first-layer W1 row gather from int
labels, segment Att pooling over the P pair slots, NTN, FCN and sigmoid.

`packed_pair_score` launches the CUDA kernel `csrc/packed_pair.cu` on CUDA
tensors and runs `packed_pair_score_plain` on CPU tensors.
`packed_pair_plan` (pure Python, a function of the shapes and the card's
limits) picks the route of each launch and fixes its grid, block and
shared-memory layout: the cluster route (one tile per 2-CTA cluster, one
side per CTA; see the source for what bounds it) or, for NB whose buffers
fit no cluster layout, the single route (the one-CTA-per-tile kernel the
cluster route replaced). Both give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.common import (gcn_layers_block, layer_pairs,
                                        normalize_adjacency_block,
                                        ntn_fcn_block, ntn_operands,
                                        segment_att_pool_block)
from repro_torch.kernels.fused_gcn import (RESERVED_SMEM, _ru4,
                                           device_limits, gcn_dims)

#: threads a CTA (SIMGNN_THREADS) and CTAs a tile on the cluster route
#: (one a side)
THREADS = 256
WARPS = THREADS // 32
CLUSTER = 2
#: CTAs an SM holds by registers: __launch_bounds__(256, 2)
CTAS_BY_REGISTERS = 2


def packed_pair_score_plain(adj1, labels1, mask1, seg1, adj2, labels2, mask2,
                            seg2, pair_mask, gcn_params, att_w, ntn_params,
                            fcn_params):
    """Plain PyTorch version: [T, P] pair-slot scores."""
    t, p = pair_mask.shape
    adj = torch.cat([adj1, adj2]).float()
    mask = torch.cat([mask1, mask2]).float()
    a_norm = normalize_adjacency_block(adj, mask)
    h = gcn_layers_block(a_norm, None, mask, layer_pairs(gcn_params),
                         labels=torch.cat([labels1, labels2]))
    hg = segment_att_pool_block(h, mask, torch.cat([seg1, seg2]), att_w, p)
    f = hg.shape[-1]
    scores = ntn_fcn_block(hg[:t].reshape(t * p, f), hg[t:].reshape(t * p, f),
                           *ntn_operands(ntn_params, f),
                           layer_pairs(fcn_params))
    return scores.reshape(t, p) * pair_mask.float()


#: PackedLayout's fields in C order (`csrc/packed_pair.cu`)
LAYOUT_FIELDS = (
    "route", "lda", "ldh", "h_off", "a_off", "hw_off", "mask_off", "inv_off",
    "pm_off", "labels_off", "seg_off", "first_off", "last_off", "live_off",
    "need_off", "segs_off", "neff_off", "mean_off", "c_off", "att_off",
    "hg_off", "hgp_off", "head_off", "w_off", "w_stage", "headw_off",
    "smem_floats")


@dataclass(frozen=True)
class PackedPlan:
    """One launch of `csrc/packed_pair.cu`. `layout` holds the C struct
    `PackedLayout`'s fields (offsets in 4-byte words); on the single route
    only `route` (0) is read."""
    route: str              # "cluster" or "single"
    cluster: int            # CTAs a tile: 2, or 1 on the single route
    grid: int
    threads: int
    ctas_per_sm: int        # what the plan counts on (shared bytes, registers)
    waves: int              # grid / (SMs x CTAs an SM), rounded up
    smem_bytes: int
    layout: tuple           # ((field, value), ...) in LAYOUT_FIELDS order

    def summary(self) -> str:
        if self.route == "single":
            return (f"single route, grid {self.grid} x {self.threads} "
                    f"threads (one CTA a tile), {self.ctas_per_sm} CTA(s)/SM, "
                    f"{self.waves} wave(s), {self.smem_bytes} shared bytes")
        lay = dict(self.layout)
        staged = [l for l in range(1, 32) if lay["w_stage"] >> l & 1]
        head_in = lay["headw_off"] < lay["mask_off"]
        return (f"cluster route, grid {self.grid} x {self.threads} threads "
                f"in clusters of {self.cluster}, {self.ctas_per_sm} CTA(s)/SM, "
                f"{self.waves} wave(s), {self.smem_bytes} shared bytes, W of "
                f"layers {staged or 'none'} staged, head weights "
                f"{'in the layer buffers' if head_in else 'apart'}")


def head_words(f: int, head: tuple) -> int:
    """Floats of the head's weight copy in shared memory (the kernel's
    stage_head): NTN W [K, F, F], V [K, 2F], b [K], then each FCN layer's
    W and b, each padded to a multiple of 4."""
    k = head[0]
    return (_ru4(k * f * f) + _ru4(k * 2 * f) + _ru4(k) + sum(
        _ru4(a * b) + _ru4(b) for a, b in zip(head[:-1], head[1:])))


def _single_smem(nb: int, p: int, dims: tuple) -> int:
    """Shared bytes of the single route (the kernel's packed_smem_bytes)."""
    f_last, f_max = dims[-1], max(dims[1:])
    return 4 * (nb * nb + 2 * nb * f_max + 4 * p * f_last + 3 * nb
                + WARPS * 2 * build.MAX_HEAD + 2 * nb)


def _cluster_layout(nb: int, p: int, dims: tuple, head: tuple,
                    smem_optin: int) -> dict | None:
    """The cluster route's layout fields, or None when its buffers do not
    fit the opt-in shared memory."""
    rows, f = _ru4(nb), dims[-1]
    fields = {"route": 1, "lda": rows + 4, "ldh": _ru4(max(dims[1:])) + 4}

    def carve(start, buffers):
        off = start
        for name, words in buffers:
            fields[name] = off
            off += _ru4(words)
        return off

    def size(buffers):
        return sum(_ru4(words) for _, words in buffers)

    off = carve(0, (("h_off", rows * fields["ldh"]),
                    ("a_off", rows * fields["lda"]),
                    ("hw_off", rows * fields["ldh"])))
    # dead once the last aggregation is done: all past the last H (row
    # stride F | 1) up to the end of HW
    dead_lo, dead_hi = _ru4(rows * (f | 1)), off
    off = carve(off, (
        ("mask_off", nb), ("inv_off", nb), ("pm_off", p), ("labels_off", nb),
        ("seg_off", nb), ("first_off", nb), ("last_off", nb),
        ("live_off", p + 1), ("need_off", p), ("segs_off", p + 1),
        ("neff_off", 1)))
    pool = (("mean_off", p * f), ("c_off", p * f), ("att_off", nb),
            ("hg_off", p * f), ("hgp_off", p * f),
            ("head_off", WARPS * 2 * build.MAX_HEAD))
    weights = _ru4(head_words(f, head))
    if dead_lo + weights <= dead_hi:
        fields["headw_off"] = dead_lo
        lo = dead_lo + weights
    else:
        fields["headw_off"] = off
        off += weights
        lo = dead_lo
    if lo + size(pool) <= dead_hi:
        carve(lo, pool)
    else:
        off = carve(off, pool)
    if 4 * off > smem_optin:
        return None

    def per_sm(words):
        return min(CTAS_BY_REGISTERS, (smem_optin + RESERVED_SMEM)
                   // (4 * words + RESERVED_SMEM))
    # W_l (l >= 1) staged in shared memory where that costs no CTA an SM:
    # one buffer of the largest such W, every layer whose W fits it staged
    sizes = {l: dims[l] * _ru4(dims[l + 1]) for l in range(1, len(dims) - 1)}
    room = [s for s in sorted(set(sizes.values()), reverse=True)
            if 4 * (off + s) <= smem_optin and per_sm(off + s) == per_sm(off)]
    fields["w_off"], fields["w_stage"] = -1, 0
    if room:
        fields["w_off"] = off
        off += room[0]
        fields["w_stage"] = sum(1 << l for l, s in sizes.items()
                                if s <= room[0])
    fields["smem_floats"] = off
    return fields


@functools.lru_cache(maxsize=256)
def packed_pair_plan(t: int, nb: int, p: int, dims: tuple, sm_count: int,
                     smem_optin: int, *, head: tuple) -> PackedPlan:
    """Route, grid, block and shared layout of one launch on T tiles of NB
    nodes and P pair slots a side, GCN widths `dims` = (labels, f1, ..,
    f_L) and head widths `head` = (K, FCN widths .., 1).

    The cluster route (grid 2T in 2-CTA clusters) where its buffers fit the
    card's opt-in shared memory, else the single route (grid T) where the
    replaced kernel's do; the choice depends on the shapes alone. Raises
    ValueError for what the kernels do not take, naming the widths when no
    route's buffers fit. `sm_count` and the CTAs an SM holds give the
    waves."""
    n_gcn = len(dims) - 1
    if not 1 <= n_gcn <= build.MAX_GCN:
        raise ValueError(f"packed_pair takes 1..{build.MAX_GCN} GCN layers, "
                         f"got widths {dims}")
    if min(t, nb, p, *dims, *head) < 1:
        raise ValueError(f"packed_pair takes positive sizes, got T {t}, NB "
                         f"{nb}, P {p}, widths {dims}, head {head}")
    if max(head) > build.MAX_HEAD or head[-1] != 1:
        raise ValueError(f"packed_pair takes NTN K and FCN widths <= "
                         f"{build.MAX_HEAD} ending in 1, got head {head}")
    fields = _cluster_layout(nb, p, dims, head, smem_optin)
    if fields is not None:
        smem_bytes = 4 * fields["smem_floats"]
        ctas = min(CTAS_BY_REGISTERS, (smem_optin + RESERVED_SMEM)
                   // (smem_bytes + RESERVED_SMEM))
        grid = CLUSTER * t
        return PackedPlan(route="cluster", cluster=CLUSTER, grid=grid,
                          threads=THREADS, ctas_per_sm=ctas,
                          waves=-(-grid // (sm_count * ctas)),
                          smem_bytes=smem_bytes,
                          layout=tuple((k, fields[k]) for k in LAYOUT_FIELDS))
    smem_bytes = _single_smem(nb, p, dims)
    if smem_bytes > smem_optin:
        raise ValueError(f"packed_pair: GCN widths {dims} and head widths "
                         f"{head} at NB {nb}, P {p} need {smem_bytes} shared "
                         f"bytes a CTA on every route, more than the card's "
                         f"{smem_optin}")
    ctas = max(1, min(2048 // THREADS, (smem_optin + RESERVED_SMEM)
                      // (smem_bytes + RESERVED_SMEM)))
    layout = dict.fromkeys(LAYOUT_FIELDS, 0)
    return PackedPlan(route="single", cluster=1, grid=t, threads=THREADS,
                      ctas_per_sm=ctas, waves=-(-t // (sm_count * ctas)),
                      smem_bytes=smem_bytes, layout=tuple(layout.items()))


class PackedSide(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("adj", "labels", "mask", "seg")]


class PackedLayout(ctypes.Structure):
    """Mirror of `PackedLayout` in `csrc/packed_pair.cu`."""
    _fields_ = [(k, ctypes.c_int) for k in LAYOUT_FIELDS]


@functools.lru_cache(maxsize=256)
def _layout_struct(plan: PackedPlan) -> PackedLayout:
    s = PackedLayout()
    for k, v in plan.layout:
        setattr(s, k, v)
    return s


@functools.cache
def _lib():
    """The library, its structs checked and signatures set once."""
    lib = build.library("packed_pair")
    build.check_side_struct(lib, "packed_side_size", PackedSide)
    build.check_side_struct(lib, "packed_layout_size", PackedLayout)
    build.bind(lib.packed_pair_score_launch, [
        ctypes.POINTER(PackedSide), ctypes.POINTER(PackedSide),
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.POINTER(build.SimgnnParams), ctypes.c_void_p,
        ctypes.POINTER(PackedLayout)])
    build.bind(lib.packed_pair_max_clusters,
               [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    return lib


def max_clusters(plan: PackedPlan) -> int:
    """2-CTA clusters of a cluster-route plan the current device holds at
    once, as the CUDA runtime computes it (registers included): one wave
    when it is at least T."""
    out = ctypes.c_int()
    build.check_launch(_lib().packed_pair_max_clusters(
        plan.smem_bytes, ctypes.byref(out)), "packed_pair occupancy")
    return out.value


def plan_for(t: int, nb: int, p: int, gcn_params, att_w, ntn_params,
             fcn_params, device: torch.device) -> PackedPlan:
    """`packed_pair_plan` of a launch with these weights on `device`."""
    dims = gcn_dims(gcn_params[0]["w"].shape[0], gcn_params, att_w)
    head = (ntn_params["b"].shape[0],) + tuple(
        layer["w"].shape[1] for layer in fcn_params)
    return packed_pair_plan(t, nb, p, dims, *device_limits(device.index),
                            head=head)


def packed_pair_score(adj1, labels1, mask1, seg1, adj2, labels2, mask2, seg2,
                      pair_mask, gcn_params, att_w, ntn_params, fcn_params):
    """Packed tiles (pack_pairs layout) -> [T, P] pair-slot scores. CUDA
    tensors launch `csrc/packed_pair.cu` (counted in
    `packed_pair_score.launches`, with the plan in
    `packed_pair_score.last_plan`); CPU tensors run the plain version."""
    args = (adj1, labels1, mask1, seg1, adj2, labels2, mask2, seg2, pair_mask)
    if not on_cuda(*args):
        return packed_pair_score_plain(*args, gcn_params, att_w, ntn_params,
                                       fcn_params)
    t, nb = mask1.shape
    p = pair_mask.shape[-1]
    dev = mask1.device
    out = torch.empty((t, p), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    sides = [PackedSide(
        build.checked(adj, f"adj{s + 1}", torch.float32, (t, nb, nb)),
        build.checked(lab, f"labels{s + 1}", torch.int32, (t, nb)),
        build.checked(msk, f"mask{s + 1}", torch.float32, (t, nb)),
        build.checked(seg, f"seg{s + 1}", torch.int32, (t, nb)))
        for s, (adj, lab, msk, seg) in enumerate((args[:4], args[4:8]))]
    pm = build.checked(pair_mask, "pair_mask", torch.float32, (t, p))
    params, _keep = build.simgnn_params(
        {"gcn": gcn_params, "att": {"w": att_w}, "ntn": ntn_params,
         "fcn": fcn_params}, dev)
    plan = plan_for(t, nb, p, gcn_params, att_w, ntn_params, fcn_params, dev)
    err = _lib().packed_pair_score_launch(
        ctypes.byref(sides[0]), ctypes.byref(sides[1]), pm, out.data_ptr(), t,
        nb, p, ctypes.byref(params),
        torch.cuda.current_stream(dev).cuda_stream,
        ctypes.byref(_layout_struct(plan)))
    build.check_launch(err, "packed_pair")
    packed_pair_score.launches += 1
    packed_pair_score.last_plan = plan
    return out


packed_pair_score.launches = 0
packed_pair_score.last_plan = None
