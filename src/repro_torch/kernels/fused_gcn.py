"""Fused GCN stack + Att pooling (graph embeddings) — port of
`repro.kernels.fused_gcn`.

Per padded graph: every GCN layer on the pre-normalised A' (layer 0 a dense
product on the one-hot features, as the Pallas body computes it), then the
Att pooling; [B, F_last] embeddings out. Serves the embedding cache's
embed stage, the search index and the `two_kernel` path's first stage.

`fused_gcn_att` launches the CUDA kernel `csrc/fused_gcn.cu` on CUDA
tensors and runs `fused_gcn_att_plain` on CPU tensors. The kernel runs
persistent CTAs that keep the whole weight set in shared memory and stage
the next graph while the current one computes; `fused_gcn_plan` (pure
Python, a function of the shapes and the card's limits) decides the route,
grid, block and shared-memory layout of each launch. On the card a graph's
embedding is the same bits whatever its batch companions and bucket width.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.device import on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.common import gcn_att_block, layer_pairs

#: shared bytes the card keeps beside each resident block's dynamic
#: allocation; an SM holds `smem_optin + RESERVED_SMEM` bytes in all.
RESERVED_SMEM = 1024
#: CTAs an SM holds at each block size by registers: the kernel's
#: __launch_bounds__(512) caps a thread at 128 registers.
CTAS_BY_THREADS = {256: 2, 512: 1}


def fused_gcn_att_plain(adj_norm, feats, mask, gcn_params, att_w):
    """Plain PyTorch version: [B, F_last] embeddings."""
    return gcn_att_block(adj_norm.float(), feats.float(), mask.float(),
                         layer_pairs(gcn_params), att_w)


def _ru4(x: int) -> int:
    return (x + 3) // 4 * 4


@dataclass(frozen=True)
class GcnPlan:
    """One launch of `csrc/fused_gcn.cu`. `layout` holds the C struct
    `GcnLayout`'s fields, in floats."""
    route: str              # "shared": all buffers in shared memory;
                            # "scratch": A', feats, HW, H in global scratch
    grid: int               # persistent CTAs
    threads: int
    ctas_per_sm: int        # what the plan counts on (shared bytes, registers)
    smem_bytes: int
    stages: int             # input buffers: 2 stages the next graph
    weights_in_smem: bool
    scratch_floats: int     # global scratch of the whole grid
    layout: tuple           # ((field, value), ...)

    def summary(self) -> str:
        return (f"{self.route} route, grid {self.grid} x {self.threads} "
                f"threads, {self.ctas_per_sm} CTA(s)/SM, {self.smem_bytes} "
                f"shared bytes, {self.stages} input stage(s), weights "
                f"{'resident' if self.weights_in_smem else 'in global'}"
                + (f", scratch {self.scratch_floats * 4} bytes"
                   if self.scratch_floats else ""))


def _image_layout(dims) -> tuple[list, list, list, int, int, int]:
    """(w_off, b_off, ldw per layer, att_off, ldatt, floats) of the padded
    weight image: W_l [f_l][ru4(f_{l+1})], b_l [ru4(f_{l+1})], then the Att
    W [F][ru4(F)], each zero-padded."""
    w_off, b_off, ldw, off = [], [], [], 0
    for fin, fout in zip(dims[:-1], dims[1:]):
        ldw.append(_ru4(fout))
        w_off.append(off)
        off += fin * ldw[-1]
        b_off.append(off)
        off += ldw[-1]
    ldatt = _ru4(dims[-1])
    return w_off, b_off, ldw, off, ldatt, off + dims[-1] * ldatt


@functools.lru_cache(maxsize=256)
def fused_gcn_plan(b: int, n: int, dims: tuple, sm_count: int,
                   smem_optin: int) -> GcnPlan:
    """Route, grid, block and shared layout of one launch of B graphs
    padded to n nodes, GCN widths `dims` = (f0, f1, .., f_L).

    The shared route keeps the weight image, A', feats, mask, HW and H in
    shared memory, with the next graph's inputs staged beside the current
    ones (2 stages) unless one stage lets more CTAs share an SM. Where
    nothing fits, the scratch route puts A', feats, HW and H in a slot of
    global scratch per CTA and keeps the weights in shared memory where
    they fit. Batches of at most `sm_count` graphs run one 512-thread CTA
    per graph; larger ones run 256-thread CTAs where two fit an SM, else
    512. The grid is min(B, sm_count x CTAs per SM)."""
    n_gcn = len(dims) - 1
    if not 1 <= n_gcn <= build.MAX_GCN or b < 1 or n < 1 or min(dims) < 1:
        raise ValueError(f"fused_gcn takes 1..{build.MAX_GCN} GCN layers "
                         f"and positive sizes, got B {b}, n {n}, dims {dims}")
    w_off, b_off, ldw, att_off, ldatt, w_floats = _image_layout(dims)
    f_last = dims[-1]
    np_ = _ru4(n)
    lda, ldf, ldh = np_ + 4, _ru4(dims[0]) + 4, _ru4(max(dims[1:])) + 4
    a_sz, f_sz, h_sz = np_ * lda, np_ * ldf, np_ * ldh

    def carve(stages, weights, big_in_smem):
        """(layout fields, smem floats, slot floats)."""
        off = w_floats if weights else 0
        m_off = [off, off + np_ * (stages - 1)]
        off += np_ * stages
        mean_off, c_off = off, off + _ru4(f_last)
        att_s_off = c_off + _ru4(f_last)
        neff_off = att_s_off + np_
        off = neff_off + 4
        big = off if big_in_smem else 0
        a_off = [big, big + a_sz * (stages - 1)]
        big += a_sz * stages
        f_off = [big, big + f_sz * (stages - 1)]
        big += f_sz * stages
        hw_off, h_off = big, big + h_sz
        big += 2 * h_sz
        smem, slot = (big, 0) if big_in_smem else (off, big)
        fields = dict(
            n=n, f0=dims[0], np=np_, lda=lda, ldf=ldf, ldh=ldh,
            n_gcn=n_gcn, att_off=att_off, ldatt=ldatt, w_floats=w_floats,
            dims=tuple(dims), ldw=tuple(ldw), w_off=tuple(w_off),
            b_off=tuple(b_off), weights_in_smem=int(weights), stages=stages,
            a_off=tuple(a_off), f_off=tuple(f_off), m_off=tuple(m_off),
            hw_off=hw_off, h_off=h_off, mean_off=mean_off, c_off=c_off,
            att_s_off=att_s_off, neff_off=neff_off, smem_floats=smem,
            slot_floats=slot)
        return fields, smem, slot

    def ctas(smem_bytes, threads):
        return min(CTAS_BY_THREADS[threads],
                   (smem_optin + RESERVED_SMEM) // (smem_bytes
                                                    + RESERVED_SMEM))

    best = None
    for stages in (2, 1):
        fields, smem, _ = carve(stages, True, True)
        if smem * 4 <= smem_optin:
            key = ctas(smem * 4, 256)
            if best is None or key > best[0]:
                best = (key, fields, smem)
    if best is not None:
        route, (_, fields, smem), slot = "shared", best, 0
    else:
        route = "scratch"
        fields, smem, slot = carve(1, True, False)
        if smem * 4 > smem_optin:
            fields, smem, slot = carve(1, False, False)
        if smem * 4 > smem_optin:
            raise ValueError(f"fused_gcn: bucket {n} needs {smem * 4} shared "
                             f"bytes, more than the card's {smem_optin}")
    smem_bytes = smem * 4
    threads = 512 if b <= sm_count or ctas(smem_bytes, 256) < 2 else 256
    per_sm = ctas(smem_bytes, threads)
    grid = min(b, sm_count * per_sm)
    return GcnPlan(route=route, grid=grid, threads=threads,
                   ctas_per_sm=per_sm, smem_bytes=smem_bytes,
                   stages=fields["stages"],
                   weights_in_smem=bool(fields["weights_in_smem"]),
                   scratch_floats=grid * slot,
                   layout=tuple(fields.items()))


class GcnLayout(ctypes.Structure):
    """Mirror of `GcnLayout` in `csrc/fused_gcn.cu`."""
    _fields_ = ([(k, ctypes.c_int) for k in ("n", "f0", "np", "lda", "ldf",
                                             "ldh", "n_gcn", "att_off",
                                             "ldatt", "w_floats")]
                + [("dims", ctypes.c_int * (build.MAX_GCN + 1))]
                + [(k, ctypes.c_int * build.MAX_GCN)
                   for k in ("ldw", "w_off", "b_off")]
                + [(k, ctypes.c_int) for k in ("weights_in_smem", "stages")]
                + [(k, ctypes.c_int * 2) for k in ("a_off", "f_off", "m_off")]
                + [(k, ctypes.c_int) for k in ("hw_off", "h_off", "mean_off",
                                               "c_off", "att_s_off",
                                               "neff_off", "smem_floats",
                                               "slot_floats")])


@functools.lru_cache(maxsize=256)
def _layout_struct(plan: GcnPlan) -> GcnLayout:
    s = GcnLayout()
    for k, v in plan.layout:
        if isinstance(v, tuple):
            arr = getattr(s, k)
            for i, x in enumerate(v):
                arr[i] = x
        else:
            setattr(s, k, v)
    return s


@functools.cache
def _lib():
    """The library with its entry points' signatures set once."""
    lib = build.library("fused_gcn")
    build.check_side_struct(lib, "fused_gcn_layout_size", GcnLayout)
    build.bind(lib.fused_gcn_launch, [ctypes.c_void_p] * 4 + [ctypes.c_int] + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(GcnLayout)] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p])
    build.bind(lib.fused_gcn_device_limits,
               [ctypes.POINTER(ctypes.c_int)] * 2)
    build.bind(lib.fused_gcn_occupancy, [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)])
    return lib


@functools.cache
def device_limits(index: int) -> tuple[int, int]:
    """(SMs, opt-in shared bytes a block may use) of CUDA device `index`."""
    sms, optin = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        build.check_launch(_lib().fused_gcn_device_limits(
            ctypes.byref(sms), ctypes.byref(optin)), "fused_gcn limits")
    return sms.value, optin.value


def occupancy(plan: GcnPlan) -> int:
    """CTAs an SM of the current device holds for this plan, as the CUDA
    runtime computes it (registers included): what `ctas_per_sm` counts
    on, checked on the card."""
    out = ctypes.c_int()
    build.check_launch(_lib().fused_gcn_occupancy(
        int(plan.route == "scratch"), plan.threads, plan.smem_bytes,
        ctypes.byref(out)), "fused_gcn occupancy")
    return out.value


#: weight images by (device, identity and version of every leaf); each
#: entry holds the leaves themselves, so no key's ids can be reused.
_IMAGES: dict[tuple, tuple] = {}
_IMAGES_KEPT = 16


def _weight_image(gcn_params, att_w, device) -> torch.Tensor:
    """The padded float32 weight image the kernel copies to shared memory
    (layout `_image_layout`), built once per params tree."""
    leaves = [t for p in gcn_params for t in (p["w"], p["b"])] + [att_w]
    key = (str(device),) + tuple((id(t), t._version) for t in leaves)
    hit = _IMAGES.get(key)
    if hit is not None:
        return hit[0]
    parts = []
    for p in gcn_params:
        w = p["w"].to(device).float()
        pad = _ru4(w.shape[1]) - w.shape[1]
        parts += [F.pad(w, (0, pad)).reshape(-1),
                  F.pad(p["b"].to(device).float().reshape(-1), (0, pad))]
    a = att_w.to(device).float()
    parts.append(F.pad(a, (0, _ru4(a.shape[1]) - a.shape[1])).reshape(-1))
    image = torch.cat(parts).contiguous()
    if len(_IMAGES) >= _IMAGES_KEPT:
        _IMAGES.pop(next(iter(_IMAGES)))
    _IMAGES[key] = (image, leaves)
    return image


def gcn_dims(feats_width: int, gcn_params, att_w) -> tuple:
    """(f0, f1, .., f_L) of a params tree, checked layer by layer."""
    dims = (feats_width,) + tuple(p["w"].shape[1] for p in gcn_params)
    for i, p in enumerate(gcn_params):
        if tuple(p["w"].shape) != dims[i:i + 2] or p["b"].numel() != dims[
                i + 1]:
            raise ValueError(f"GCN layer {i}: w {tuple(p['w'].shape)}, b "
                             f"{tuple(p['b'].shape)} do not follow widths "
                             f"{dims}")
    if tuple(att_w.shape) != (dims[-1], dims[-1]):
        raise ValueError(f"att w {tuple(att_w.shape)} is not "
                         f"[{dims[-1]}, {dims[-1]}]")
    return dims


def fused_gcn_att(adj_norm, feats, mask, gcn_params, att_w):
    """Pre-normalised A' [B, N, N], one-hot feats [B, N, F0], mask [B, N]
    -> [B, F_last] graph embeddings. CUDA tensors launch
    `csrc/fused_gcn.cu` (counted in `fused_gcn_att.launches`); CPU tensors
    run the plain version."""
    if not on_cuda(adj_norm, feats, mask):
        return fused_gcn_att_plain(adj_norm, feats, mask, gcn_params, att_w)
    b, n, _ = adj_norm.shape
    f0 = feats.shape[-1]
    if gcn_params[0]["w"].shape[0] != f0:
        raise ValueError(f"feats width {f0} != first GCN layer's "
                         f"{gcn_params[0]['w'].shape[0]}")
    dims = gcn_dims(f0, gcn_params, att_w)
    dev = adj_norm.device
    out = torch.empty((b, dims[-1]), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    ptrs = (build.checked(adj_norm, "adj_norm", torch.float32, (b, n, n)),
            build.checked(feats, "feats", torch.float32, (b, n, f0)),
            build.checked(mask, "mask", torch.float32, (b, n)))
    plan = fused_gcn_plan(b, n, dims, *device_limits(dev.index))
    image = _weight_image(gcn_params, att_w, dev)
    scratch = (torch.empty(plan.scratch_floats, dtype=torch.float32,
                           device=dev) if plan.scratch_floats else None)
    err = _lib().fused_gcn_launch(
        *ptrs, out.data_ptr(), b, image.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        ctypes.byref(_layout_struct(plan)), plan.grid, plan.threads,
        plan.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "fused_gcn")
    fused_gcn_att.launches += 1
    return out


fused_gcn_att.launches = 0
