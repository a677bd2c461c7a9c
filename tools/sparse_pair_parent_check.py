"""Hold `csrc/sparse_pair.cu` against an earlier version of the same source,
bit for bit, and time the two side by side on one NVIDIA GPU.

    python3 tools/sparse_pair_parent_check.py PARENT.cu [--time]

PARENT.cu is the one-CTA-per-tile kernel this design replaced (its C
interface: `sparse_pair_score_launch(s1, s2, pmask, out, T, nb, d, e_ov,
p, SimgnnParams*, stream)`), for example extracted with `git show
<rev>:src/repro_torch/csrc/sparse_pair.cu`. It is built with the port's
nvcc flags beside the current library. Both run on the same inputs: the
served 256-pair requests (arrays captured from
`simgnn_query_server(use_kernels=True)`), the D = 2 spill case, E_ov of 64
and 128, D = 1, overflow slots shuffled within each tile (pads between
real edges, receivers out of order, -0 weights), all-pad tiles mixed with
live ones and alone, pair slots masked out whose nodes are not, T of 1, 2
and 3, the narrow config, 1-, 2- and 8-layer stacks (odd widths), a W2
that is not 16-byte aligned, NaN and ±inf in W1, W2, the Att W and the
NTN W, and bf16 params. "Equal" is `torch.equal` on the values with NaN
in the same places (the bit patterns are compared too and reported). With
`--time`, the served request, the spill case and the narrow config are
timed parent, current, current, parent: CUDA events around 20
back-to-back calls through the same host path (`launcher`; host launch
gaps included), and around a CUDA graph of 20 launches (device time).
Writes
`chiprun_out/sparse_pair_parent.json`; exits 1 if any case differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.simgnn_aids import CONFIG  # noqa: E402
from repro_torch.core import batching  # noqa: E402
from repro_torch.core.simgnn import (SimGNNConfig,  # noqa: E402
                                     init_simgnn_params)
from repro_torch.data.graphs import query_pairs  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import sparse_pair as sp  # noqa: E402
from repro_torch.kernels.fused_gcn import device_limits  # noqa: E402
from repro_torch.kernels.sparse_pair import (SparseSide,  # noqa: E402
                                             sparse_pair_score)
from repro_torch.serve.batching import simgnn_query_server  # noqa: E402

BATCH = 256


def launcher(launch, planned: bool):
    """A call of a `sparse_pair_score_launch` as a function of (arrays,
    weights) doing the same host work for either kernel (side structs,
    params struct, output, and for the current kernel its plan), so that
    back-to-back calls of the two compare kernels, not wrappers."""
    def run(arrays, gcn, att, ntn, fcn):
        t, nb = arrays[6].shape
        e, e_ov, p = arrays[0].shape[-1], arrays[2].shape[-1], \
            arrays[16].shape[-1]
        sides = [SparseSide(*(x.data_ptr() for x in arrays[s:s + 8]))
                 for s in (0, 8)]
        prm, _keep = build.simgnn_params(
            {"gcn": gcn, "att": {"w": att}, "ntn": ntn, "fcn": fcn},
            arrays[0].device)
        y = torch.empty((t, p), device=arrays[0].device)
        extra = ()
        if planned:
            dims = (gcn[0]["w"].shape[0],) + tuple(x["w"].shape[1]
                                                   for x in gcn)
            head = (ntn["b"].shape[0],) + tuple(x["w"].shape[1] for x in fcn)
            plan = sp.sparse_pair_plan(t, nb, e // nb, e_ov, p, dims,
                                       *device_limits(arrays[0].device.index),
                                       head=head)
            extra = (ctypes.byref(sp._layout_struct(plan)),)
        build.check_launch(launch(
            ctypes.byref(sides[0]), ctypes.byref(sides[1]),
            arrays[16].data_ptr(), y.data_ptr(), t, nb, e // nb, e_ov, p,
            ctypes.byref(prm), torch.cuda.current_stream().cuda_stream,
            *extra), "sparse_pair")
        return y
    return run


def parent_launcher(src: Path):
    """The earlier kernel's launch as a function of (arrays, weights)."""
    out = build.BUILD_ROOT / "parent"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "sparse_pair_parent.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    build.check_side_struct(lib, "sparse_side_size", SparseSide)
    return launcher(build.bind(lib.sparse_pair_score_launch, [
        ctypes.POINTER(SparseSide), ctypes.POINTER(SparseSide),
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.POINTER(build.SimgnnParams), ctypes.c_void_p]), False)


def graph_ms(fn, iters: int = 20) -> float:
    """Mean ms a call from CUDA events around one replay of a CUDA graph of
    `iters` back-to-back calls (no host gaps between the launches)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def same_values(x, y) -> bool:
    nx, ny = torch.isnan(x), torch.isnan(y)
    return bool(torch.equal(nx, ny) and torch.equal(x[~nx], y[~ny]))


def weights(cfg=CONFIG, seed=0, dtype="float32"):
    p = init_simgnn_params(torch.Generator().manual_seed(seed),
                           cfg._replace(dtype=dtype), device="cuda")
    return [dict(x) for x in p["gcn"]], p["att"]["w"], dict(p["ntn"]), \
        [dict(x) for x in p["fcn"]]


def packed(pairs, dev, **kw):
    """The kernel's 17 arrays of a `pack_pairs` batch (64-node tiles, 16
    pair slots)."""
    pk, _ = batching.pack_pairs(pairs, 64, slots_per_tile=16,
                                with_edges=True, device=dev, **kw)
    e = pk.edges
    return [x.contiguous() for x in (
        e.edges1.senders, e.edges1.weights, e.overflow1.senders,
        e.overflow1.receivers, e.overflow1.weights, pk.labels1, pk.mask1,
        pk.seg1, e.edges2.senders, e.edges2.weights, e.overflow2.senders,
        e.overflow2.receivers, e.overflow2.weights, pk.labels2, pk.mask2,
        pk.seg2, pk.pair_mask)]


def served_requests(n_requests: int) -> list:
    """The arrays `simgnn_query_server(use_kernels=True)` hands the kernel
    for the first requests of 256 pairs of `query_pairs(1, 2048)`."""
    params = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG,
                                device="cuda")
    score = simgnn_query_server(params, CONFIG, use_kernels=True)
    seen, real = [], ops.sparse_pair_score

    def capture(*args):
        seen.append([a.clone() for a in args[:17]])
        return real(*args)
    ops.sparse_pair_score = capture
    try:
        stream = query_pairs(1, BATCH * n_requests)
        for i in range(n_requests):
            score(stream[i * BATCH:(i + 1) * BATCH])
    finally:
        ops.sparse_pair_score = real
    assert len(seen) == n_requests, len(seen)
    return seen


def with_pad_tiles(arrays, where):
    """`arrays` with all-pad tiles (zero planes, masks and pair mask)
    inserted before the tiles listed in `where`."""
    out = []
    for x in arrays:
        parts, last = [], 0
        for i in sorted(where):
            parts += [x[last:i], torch.zeros_like(x[:1])]
            last = i
        parts.append(x[last:])
        out.append(torch.cat(parts).contiguous())
    return out


def shuffled_overflow(arrays, seed):
    """The overflow slots of every tile in a random order, and the pad
    slots' weights made -0 in half the tiles."""
    rng = np.random.default_rng(seed)
    out = list(arrays)
    for s in (0, 8):
        t, e_ov = out[s + 2].shape
        perm = torch.from_numpy(np.argsort(rng.random((t, e_ov)), 1)).to(
            out[s].device)
        for k in (2, 3, 4):
            out[s + k] = torch.gather(out[s + k], 1, perm).contiguous()
        w = out[s + 4].clone()
        neg = torch.from_numpy(rng.random(t) < 0.5).to(w.device)[:, None]
        w[(w == 0) & neg] = -0.0
        out[s + 4] = w
    return out


def cases(dev):
    """(label, arrays, weights) of every case held bit for bit."""
    aids = weights()
    served = served_requests(2)
    for i, arrays in enumerate(served):
        yield (f"served request {i} (T {arrays[0].shape[0]}, E_ov "
               f"{arrays[2].shape[-1]})", arrays, aids)
    pairs = query_pairs(1, BATCH)
    spill = packed(pairs, dev, edge_budget=128)
    yield f"D 2 spill (E_ov {spill[2].shape[-1]})", spill, aids
    yield f"D 1 (E_ov {packed(pairs, dev, edge_budget=64)[2].shape[-1]})", \
        packed(pairs, dev, edge_budget=64), aids
    for ov in (64, 128):
        arr = packed(pairs, dev, edge_budget=256, overflow_budget=ov)
        assert arr[2].shape[-1] == ov
        yield f"E_ov {ov}", arr, aids
        yield f"E_ov {ov}, D 2", packed(pairs, dev, edge_budget=128,
                                        overflow_budget=ov), aids
    yield "shuffled overflow slots, D 2", shuffled_overflow(spill, 1), aids
    yield "shuffled overflow slots, D 1", shuffled_overflow(
        packed(pairs, dev, edge_budget=64), 2), aids
    main = served[0]
    yield "all-pad tiles mixed with live ones", with_pad_tiles(
        main, (0, 5, 17, main[0].shape[0])), aids
    yield "three all-pad tiles", [torch.zeros_like(x[:3]) for x in main], aids
    dead = [x.clone() for x in main]
    dead[16][::3, 0] = 0.0        # slots whose nodes stay masked in
    yield "live nodes in pad pair slots", dead, aids
    for t in (1, 2, 3):
        yield f"T {t}", [x[:t].contiguous() for x in main], aids
    yield "T 2, one tile all-pad", with_pad_tiles(
        [x[:1] for x in main], (1,)), aids
    yield "narrow gcn (16,8,8,4)", main, weights(
        SimGNNConfig(gcn_dims=(16, 8, 8, 4)), 1)
    for dims in ((32,), (64, 32), (24, 20, 16, 12, 10, 8, 6, 5),
                 (128,) * 8):
        yield f"gcn {dims}", main, weights(SimGNNConfig(gcn_dims=dims), 2)
    yield "bf16 params", main, weights(dtype="bfloat16")
    gcn, att, ntn, fcn = weights()
    flat = torch.empty(gcn[1]["w"].numel() + 1, device=dev)
    flat[1:] = gcn[1]["w"].reshape(-1)
    off = [dict(x) for x in gcn]
    off[1]["w"] = flat[1:].view(gcn[1]["w"].shape)
    yield "W2 off 16-byte alignment", main, (off, att, ntn, fcn)
    label0 = int(main[5][0, 0])                 # tile 0's node 0, lhs

    def poisoned(what, at, value):
        g, a, n, f = weights()
        if what == "att":
            a = a.clone()
            a[at] = value
        elif what == "ntn":
            n["w"] = n["w"].clone()
            n["w"][at] = value
        else:
            layer = int(what[-1])
            g[layer]["w"] = g[layer]["w"].clone()
            g[layer]["w"][at] = value
        return g, a, n, f
    for value in (float("nan"), float("inf"), -float("inf")):
        for what, at in (("w0", (label0, 3)), ("w0", (7, 100)),
                         ("w1", (70, 2)), ("att", (4, 4)),
                         ("ntn", (3, 5, 6))):
            yield (f"{value} in {what}{at}", main,
                   poisoned(what, at, value))
        yield f"{value} in W1, D 2 spill", spill, poisoned(
            "w0", (label0, 3), value)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path)
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    parent = parent_launcher(args.parent)
    results, bad = [], 0
    for label, arrays, w in cases(dev):
        got = sparse_pair_score(*arrays, *w)
        want = parent(arrays, *w)
        torch.cuda.synchronize()
        eq = same_values(got, want)
        bits = bool(torch.equal(got.view(torch.int32),
                                want.view(torch.int32)))
        bad += not eq
        nan = int(torch.isnan(got).sum())
        plan = sparse_pair_score.last_plan
        results.append({"case": label, "shape": list(got.shape),
                        "equal": eq, "same_bit_patterns": bits, "nan": nan,
                        "plan": plan.summary() if plan else None})
        print(f"{'equal' if eq else 'DIFFERS'}"
              f"{'' if bits else ' (bit patterns differ)'}: {label} "
              f"{tuple(got.shape)} ({nan} NaN)")
    timing = []
    if args.time:
        current = launcher(sp._lib().sparse_pair_score_launch, True)
        w = weights()
        served = served_requests(1)[0]
        pairs = query_pairs(1, BATCH)
        for label, arrays, wt in (
                ("served request", served, w),
                ("D 2 spill", packed(pairs, dev, edge_budget=128), w),
                ("narrow gcn (16,8,8,4)", served,
                 weights(SimGNNConfig(gcn_dims=(16, 8, 8, 4)), 1))):

            def ms(fn, iters=20):
                fn()
                torch.cuda.synchronize()
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                for _ in range(iters):
                    fn()
                e.record()
                e.synchronize()
                return s.elapsed_time(e) / iters
            old = lambda: parent(arrays, *wt)              # noqa: E731
            new = lambda: current(arrays, *wt)             # noqa: E731
            t = [ms(old), ms(new), ms(new), ms(old)]
            g = [graph_ms(old), graph_ms(new), graph_ms(new), graph_ms(old)]
            timing.append({"case": label, "tiles": arrays[0].shape[0],
                           "plan": sparse_pair_score.last_plan.summary(),
                           "parent_ms": [t[0], t[3]],
                           "current_ms": [t[1], t[2]],
                           "graph_parent_ms": [g[0], g[3]],
                           "graph_current_ms": [g[1], g[2]]})
            print(f"time {label} (T {arrays[0].shape[0]}): back-to-back "
                  f"calls parent {t[0]:.4f} / {t[3]:.4f} ms, current "
                  f"{t[1]:.4f} / {t[2]:.4f} ms; CUDA graph parent "
                  f"{g[0]:.4f} / {g[3]:.4f} ms, current {g[1]:.4f} / "
                  f"{g[2]:.4f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "sparse_pair_parent.json").write_text(json.dumps(
        {"card": smi, "cases": results, "timing": timing}, indent=1))
    print(f"card: {smi}; {len(results) - bad} of {len(results)} cases equal")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
