"""Edge-centric packed-sparse (packed-CSR) pair-score megakernel — port of
`repro.kernels.sparse_pair` (DESIGN.md §9).

Same dataflow as the packed-dense kernel — FFD-packed segment-id tiles,
segment Att pooling, NTN/FCN on tile-aligned pair slots, nothing but final
scores leaving the kernel — but each GCN layer aggregates from the tile's
host-built A' non-zeros: D ELLPACK neighbour planes plus a small COO
overflow list (`core.batching.packed_pair_edges`), with the first layer a
W1 row gather from int labels.

`sparse_pair_score` launches the CUDA kernel `csrc/sparse_pair.cu` on CUDA
tensors (one tile per 2-CTA cluster, one side per CTA; see the source for
what bounds it) and runs `sparse_pair_score_plain` on CPU tensors.
`sparse_pair_plan` (pure Python, a function of the shapes and the card's
limits) fixes the grid, block and shared-memory layout of each launch;
`overflow_buckets` is the kernel's per-receiver overflow bucketing as host
code. Pad edge slots point at node 0 with zero weight, pad nodes carry
mask 0 / segment 0, and pad pair slots are zeroed by `pair_mask`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.common import (gcn_layers_edge_block, layer_pairs,
                                        ntn_fcn_block, ntn_operands,
                                        segment_att_pool_block)
from repro_torch.kernels.fused_gcn import (RESERVED_SMEM, device_limits,
                                           gcn_dims)

#: threads a CTA (SIMGNN_THREADS) and CTAs a tile (the cluster: one a side)
THREADS = 256
CLUSTER = 2
#: CTAs an SM holds by registers: __launch_bounds__(256, 2)
CTAS_BY_REGISTERS = 2


def sparse_pair_score_plain(nbr1, nbr_w1, ov_snd1, ov_rcv1, ov_w1, labels1,
                            mask1, seg1, nbr2, nbr_w2, ov_snd2, ov_rcv2,
                            ov_w2, labels2, mask2, seg2, pair_mask,
                            gcn_params, att_w, ntn_params, fcn_params):
    """Plain PyTorch version: [T, P] pair-slot scores, both sides stacked
    into one [2T, ...] block as the Pallas body does."""
    t, p = pair_mask.shape

    def cat(a, b):
        return torch.cat([a, b])

    mask = cat(mask1, mask2).float()
    h = gcn_layers_edge_block(cat(nbr1, nbr2), cat(nbr_w1, nbr_w2),
                              cat(ov_snd1, ov_snd2), cat(ov_rcv1, ov_rcv2),
                              cat(ov_w1, ov_w2), None, mask,
                              layer_pairs(gcn_params),
                              labels=cat(labels1, labels2))
    hg = segment_att_pool_block(h, mask, cat(seg1, seg2), att_w, p)
    f = hg.shape[-1]
    scores = ntn_fcn_block(hg[:t].reshape(t * p, f), hg[t:].reshape(t * p, f),
                           *ntn_operands(ntn_params, f),
                           layer_pairs(fcn_params))
    return scores.reshape(t, p) * pair_mask.float()


def overflow_buckets(ov_snd, ov_rcv, ov_w, nb: int) -> list[list[int]]:
    """One tile side's COO overflow slots bucketed by receiver, as the
    kernel buckets them: for each row i < nb the slots e with ov_rcv[e] ==
    i in ascending slot order, less each zero-weight slot that repeats the
    slot before it in its row (same sender, same weight bits; a run of
    such slots keeps its first).
    Slots whose receiver is not a row are dropped (the one-CTA kernel's
    scan never matched them); pad slots (receiver 0, weight 0) stay in row
    0's list, one of each run. fmaf(±0, x, ov) is ov + (±0 or NaN), exact,
    and applying it twice gives what applying it once gives, for every x
    and ov, so each row's fmaf chain keeps its bits."""
    snd, rcv = np.asarray(ov_snd).astype(np.int64), np.asarray(ov_rcv)
    bits = np.asarray(ov_w, np.float32).view(np.uint32)
    rows: list[list[int]] = [[] for _ in range(nb)]
    for e, r in enumerate(rcv.astype(np.int64)):
        if not 0 <= r < nb:
            continue
        row = rows[r]
        if row and (bits[e] & 0x7FFFFFFF) == 0 \
                and snd[e] == snd[row[-1]] and bits[e] == bits[row[-1]]:
            continue
        row.append(e)
    return rows


def _ru4(x: int) -> int:
    return (x + 3) // 4 * 4


@dataclass(frozen=True)
class SparsePlan:
    """One launch of `csrc/sparse_pair.cu`. `layout` holds the C struct
    `SparseLayout`'s fields (offsets in 4-byte words)."""
    route: str              # "cluster": one tile per 2-CTA cluster
    cluster: int            # CTAs a tile
    grid: int               # CTAs: cluster x T
    threads: int
    ctas_per_sm: int        # what the plan counts on (shared bytes, registers)
    waves: int              # grid / (SMs x CTAs an SM), rounded up
    smem_bytes: int
    layout: tuple           # ((field, value), ...)

    def summary(self) -> str:
        return (f"{self.route} route, grid {self.grid} x {self.threads} "
                f"threads in clusters of {self.cluster}, "
                f"{self.ctas_per_sm} CTA(s)/SM, {self.waves} wave(s), "
                f"{self.smem_bytes} shared bytes")


@functools.lru_cache(maxsize=256)
def sparse_pair_plan(t: int, nb: int, d: int, e_ov: int, p: int, dims: tuple,
                     sm_count: int, smem_optin: int, *,
                     head: tuple) -> SparsePlan:
    """Grid, block and shared layout of one launch on T tiles of NB nodes,
    D ELL planes, E_ov overflow slots and P pair slots a side, GCN widths
    `dims` = (labels, f1, .., f_L) and head widths `head` = (K, FCN widths
    .., 1) (the kernel copies the NTN V and b and the FCN into shared
    memory). Raises ValueError for what the kernel does not take, naming
    the widths when its buffers do not fit the card's opt-in shared
    memory. The layout depends on the shapes alone; `sm_count` and the
    CTAs an SM holds give the waves."""
    n_gcn = len(dims) - 1
    if not 1 <= n_gcn <= build.MAX_GCN:
        raise ValueError(f"sparse_pair takes 1..{build.MAX_GCN} GCN layers, "
                         f"got widths {dims}")
    if min(t, nb, d, p, *dims) < 1 or e_ov < 0:
        raise ValueError(f"sparse_pair takes positive sizes, got T {t}, NB "
                         f"{nb}, D {d}, E_ov {e_ov}, P {p}, widths {dims}")
    f_last = dims[-1]
    ldh = _ru4(max(dims[1:])) + 4          # 4 mod 32 at the served widths
    rows = _ru4(nb)                        # the products read ru4(NB) rows
    fields = {"ldh": ldh}

    def carve(start, buffers):
        off = start
        for name, words in buffers:
            fields[name] = off
            off += _ru4(words)
        return off

    pool = (("mean_off", p * f_last), ("c_off", p * f_last),
            ("att_off", nb), ("hg_off", p * f_last), ("hgp_off", p * f_last),
            ("head_off", THREADS // 32 * 2 * build.MAX_HEAD))
    off = carve(0, (("hw_off", rows * ldh), ("h_off", rows * ldh)))
    # the pooling and head buffers live in HW when they fit: HW is dead
    # once the last aggregation has read it
    if carve(0, pool) > rows * ldh:
        off = carve(off, pool)
    off = carve(off, (
        ("nw_off", nb * d), ("ovw_off", e_ov), ("mask_off", nb),
        ("pm_off", p), ("nbr_off", nb * d), ("ovs_off", e_ov),
        ("ovr_off", e_ov), ("list_off", e_ov), ("rowoff_off", nb),
        ("rowcnt_off", nb), ("rowlast_off", nb), ("labels_off", nb),
        ("seg_off", nb), ("live_off", p + 1), ("need_off", p),
        ("segs_off", p + 1)))
    off = carve(off, (("headw_off", _ru4(head[0] * 2 * f_last) + _ru4(
        head[0]) + sum(_ru4(a * b) + _ru4(b)
                       for a, b in zip(head[:-1], head[1:]))),))
    fields["smem_floats"] = off
    smem_bytes = 4 * off
    if smem_bytes > smem_optin:
        raise ValueError(
            f"sparse_pair: GCN widths {dims} and head widths {head} at NB "
            f"{nb}, D {d}, E_ov {e_ov}, P {p} need {smem_bytes} shared bytes "
            f"a CTA, more than the card's {smem_optin}")
    per_sm = min(CTAS_BY_REGISTERS, (smem_optin + RESERVED_SMEM)
                 // (smem_bytes + RESERVED_SMEM))
    grid = CLUSTER * t
    return SparsePlan(route="cluster", cluster=CLUSTER, grid=grid,
                      threads=THREADS, ctas_per_sm=per_sm,
                      waves=-(-grid // (sm_count * per_sm)),
                      smem_bytes=smem_bytes, layout=tuple(fields.items()))


class SparseLayout(ctypes.Structure):
    """Mirror of `SparseLayout` in `csrc/sparse_pair.cu`."""
    _fields_ = [(k, ctypes.c_int) for k in (
        "ldh", "hw_off", "h_off", "mean_off", "c_off", "att_off", "hg_off",
        "hgp_off", "head_off", "nw_off", "ovw_off", "mask_off", "pm_off",
        "nbr_off", "ovs_off", "ovr_off", "list_off", "rowoff_off",
        "rowcnt_off", "rowlast_off", "labels_off", "seg_off", "live_off",
        "need_off", "segs_off", "headw_off", "smem_floats")]


@functools.lru_cache(maxsize=256)
def _layout_struct(plan: SparsePlan) -> SparseLayout:
    s = SparseLayout()
    for k, v in plan.layout:
        setattr(s, k, v)
    return s


class SparseSide(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in
                ("nbr", "nw", "ovs", "ovr", "ovw", "labels", "mask", "seg")]


@functools.cache
def _lib():
    """The library, its structs checked and signatures set once."""
    lib = build.library("sparse_pair")
    build.check_side_struct(lib, "sparse_side_size", SparseSide)
    build.check_side_struct(lib, "sparse_layout_size", SparseLayout)
    build.bind(lib.sparse_pair_score_launch, [
        ctypes.POINTER(SparseSide), ctypes.POINTER(SparseSide),
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.POINTER(build.SimgnnParams), ctypes.c_void_p,
        ctypes.POINTER(SparseLayout)])
    build.bind(lib.sparse_pair_max_clusters,
               [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    return lib


def max_clusters(plan: SparsePlan) -> int:
    """2-CTA clusters the current device holds at once for this plan, as
    the CUDA runtime computes it (registers included): one wave when it is
    at least T."""
    out = ctypes.c_int()
    build.check_launch(_lib().sparse_pair_max_clusters(
        plan.smem_bytes, ctypes.byref(out)), "sparse_pair occupancy")
    return out.value


def sparse_pair_score(nbr1, nbr_w1, ov_snd1, ov_rcv1, ov_w1, labels1, mask1,
                      seg1, nbr2, nbr_w2, ov_snd2, ov_rcv2, ov_w2, labels2,
                      mask2, seg2, pair_mask, gcn_params, att_w, ntn_params,
                      fcn_params):
    """Packed tiles in packed-CSR edge form -> [T, P] pair-slot scores.
    CUDA tensors launch `csrc/sparse_pair.cu` (counted in
    `sparse_pair_score.launches`, with the plan in
    `sparse_pair_score.last_plan`); CPU tensors run the plain version."""
    args = (nbr1, nbr_w1, ov_snd1, ov_rcv1, ov_w1, labels1, mask1, seg1,
            nbr2, nbr_w2, ov_snd2, ov_rcv2, ov_w2, labels2, mask2, seg2,
            pair_mask)
    if not on_cuda(*args):
        return sparse_pair_score_plain(*args, gcn_params, att_w, ntn_params,
                                       fcn_params)
    t, nb = mask1.shape
    e = nbr1.shape[-1]
    e_ov = ov_snd1.shape[-1]
    p = pair_mask.shape[-1]
    if e % nb:
        raise ValueError(f"edge planes of {e} slots are not {nb}-node rows")
    dev = mask1.device
    out = torch.empty((t, p), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    dims = gcn_dims(gcn_params[0]["w"].shape[0], gcn_params, att_w)
    head = (ntn_params["b"].shape[0],) + tuple(
        layer["w"].shape[1] for layer in fcn_params)
    plan = sparse_pair_plan(t, nb, e // nb, e_ov, p, dims,
                            *device_limits(dev.index), head=head)
    sides = []
    for s, (nbr, nw, ovs, ovr, ovw, lab, msk, seg) in enumerate(
            (args[:8], args[8:16])):
        sides.append(SparseSide(
            build.checked(nbr, f"nbr{s + 1}", torch.int16, (t, e)),
            build.checked(nw, f"nbr_w{s + 1}", torch.float32, (t, e)),
            build.checked(ovs, f"ov_snd{s + 1}", torch.int16, (t, e_ov)),
            build.checked(ovr, f"ov_rcv{s + 1}", torch.int16, (t, e_ov)),
            build.checked(ovw, f"ov_w{s + 1}", torch.float32, (t, e_ov)),
            build.checked(lab, f"labels{s + 1}", torch.int32, (t, nb)),
            build.checked(msk, f"mask{s + 1}", torch.float32, (t, nb)),
            build.checked(seg, f"seg{s + 1}", torch.int32, (t, nb))))
    pm = build.checked(pair_mask, "pair_mask", torch.float32, (t, p))
    params, _keep = build.simgnn_params(
        {"gcn": gcn_params, "att": {"w": att_w}, "ntn": ntn_params,
         "fcn": fcn_params}, dev)
    err = _lib().sparse_pair_score_launch(
        ctypes.byref(sides[0]), ctypes.byref(sides[1]), pm, out.data_ptr(), t,
        nb, e // nb, e_ov, p, ctypes.byref(params),
        torch.cuda.current_stream(dev).cuda_stream,
        ctypes.byref(_layout_struct(plan)))
    build.check_launch(err, "sparse_pair")
    sparse_pair_score.launches += 1
    sparse_pair_score.last_plan = plan
    return out


sparse_pair_score.launches = 0
sparse_pair_score.last_plan = None
