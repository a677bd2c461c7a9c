"""Hold `csrc/packed_pair.cu` against an earlier version of the same source,
bit for bit, and time the two side by side on one NVIDIA GPU.

    python3 tools/packed_pair_parent_check.py PARENT.cu [--time]

PARENT.cu is the one-CTA-per-tile kernel this design replaced (its C
interface: `packed_pair_score_launch(s1, s2, pmask, out, T, nb, p,
SimgnnParams*, stream)`), for example extracted with `git show
<rev>:src/repro_torch/csrc/packed_pair.cu`. It is built with the port's
nvcc flags beside the current library. Both run on the same inputs: the
arrays `simgnn_query_server` hands the kernel for the first requests of
256 pairs of the AIDS stream (`query_pairs(1, ...)`, path forced to
`packed_dense`) and of the average-degree-8 stream (`search_pairs(5, ...,
avg_degree=8.0)`, auto path), all-pad tiles mixed with live ones and
alone, T of 1, 2 and 3, raw adjacencies that are not block-diagonal (a
dense random 0/1 tile, random weights in [-1, 1]), -0 in the adjacency
and the weights, pair slots masked out whose nodes are not, NB 30 (scalar
adjacency loads), the narrow config, 1-, 2- and 8-layer stacks (odd
widths), a W2 that is not 16-byte aligned, NaN and ±inf in W1 (the pad
rows' label 0 among them), W2, the Att W and the NTN W, bf16 params, and
a head wide enough (NTN K 40) that NB 64 takes the single route. "Equal"
is `torch.equal` on the values with NaN in the same places (the bit
patterns are compared too and reported). With `--time`, an AIDS request,
an average-degree-8 request and the narrow config are timed parent,
current, current, parent: CUDA events around 20 back-to-back calls
through the same host path (`launcher`; host launch gaps included), and
around a CUDA graph of 20 launches (device time). Writes
`chiprun_out/packed_pair_parent.json`; exits 1 if any case differs.
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
from repro_torch.data.graphs import query_pairs, search_pairs  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import packed_pair as pp  # noqa: E402
from repro_torch.kernels.packed_pair import (PackedSide,  # noqa: E402
                                             packed_pair_score)
from repro_torch.serve.batching import simgnn_query_server  # noqa: E402

BATCH = 256


def launcher(launch, planned: bool):
    """A call of a `packed_pair_score_launch` as a function of (arrays,
    weights) doing the same host work for either kernel (side structs,
    params struct, output, and for the current kernel its plan), so that
    back-to-back calls of the two compare kernels, not wrappers."""
    def run(arrays, gcn, att, ntn, fcn):
        t, nb = arrays[2].shape
        p = arrays[8].shape[-1]
        sides = [PackedSide(*(x.data_ptr() for x in arrays[s:s + 4]))
                 for s in (0, 4)]
        prm, _keep = build.simgnn_params(
            {"gcn": gcn, "att": {"w": att}, "ntn": ntn, "fcn": fcn},
            arrays[0].device)
        y = torch.empty((t, p), device=arrays[0].device)
        extra = ()
        if planned:
            plan = pp.plan_for(t, nb, p, gcn, att, ntn, fcn, arrays[0].device)
            extra = (ctypes.byref(pp._layout_struct(plan)),)
        build.check_launch(launch(
            ctypes.byref(sides[0]), ctypes.byref(sides[1]),
            arrays[8].data_ptr(), y.data_ptr(), t, nb, p, ctypes.byref(prm),
            torch.cuda.current_stream().cuda_stream, *extra), "packed_pair")
        return y
    return run


def parent_launcher(src: Path):
    """The earlier kernel's launch as a function of (arrays, weights)."""
    out = build.BUILD_ROOT / "parent"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "packed_pair_parent.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    build.check_side_struct(lib, "packed_side_size", PackedSide)
    return launcher(build.bind(lib.packed_pair_score_launch, [
        ctypes.POINTER(PackedSide), ctypes.POINTER(PackedSide),
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
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


def packed(pairs, dev, nb=64):
    """The kernel's 9 arrays of a `pack_pairs` batch (NB-node tiles, 16
    pair slots)."""
    pk, _ = batching.pack_pairs(pairs, nb, slots_per_tile=16, device=dev)
    return [x.contiguous() for x in (
        pk.adj1, pk.labels1, pk.mask1, pk.seg1, pk.adj2, pk.labels2,
        pk.mask2, pk.seg2, pk.pair_mask)]


def served_requests(stream, n_requests: int, path: str) -> list:
    """The arrays `simgnn_query_server` (on `path`) hands the kernel for
    the first requests of 256 pairs of `stream`."""
    params = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG,
                                device="cuda")
    score = simgnn_query_server(params, CONFIG, path=path)
    seen, real = [], ops.packed_pair_score

    def capture(*args):
        seen.append([a.clone() for a in args[:9]])
        return real(*args)
    ops.packed_pair_score = capture
    try:
        for i in range(n_requests):
            score(stream[i * BATCH:(i + 1) * BATCH])
            assert score.last_plan.path == "packed_dense", score.last_plan
    finally:
        ops.packed_pair_score = real
    assert len(seen) == n_requests, len(seen)
    return seen


def aids_requests(n: int) -> list:
    return served_requests(query_pairs(1, BATCH * n), n, "packed_dense")


def dense_requests(n: int) -> list:
    return served_requests(search_pairs(5, BATCH * n, avg_degree=8.0), n,
                           "auto")


def with_pad_tiles(arrays, where):
    """`arrays` with all-pad tiles (zero adjacency, masks and pair mask)
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


def rewired(arrays, seed, fill):
    """`arrays` with every tile's adjacency of both sides replaced by
    `fill(rng, nb)` over all NB x NB cells (masks, labels and segments
    kept), so that a row's nonzero columns cross graph boundaries."""
    rng = np.random.default_rng(seed)
    out = list(arrays)
    for s in (0, 4):
        t, nb, _ = out[s].shape
        out[s] = torch.from_numpy(np.stack([fill(rng, nb) for _ in range(t)])
                                  ).to(out[s].device).contiguous()
    return out


def dense_01(rng, nb):
    a = (rng.random((nb, nb)) < 0.5).astype(np.float32)
    return np.triu(a, 1) + np.triu(a, 1).T


def uniform(rng, nb):
    return rng.uniform(-1.0, 1.0, (nb, nb)).astype(np.float32)


def negative_zeros(arrays):
    """-0 in every zero adjacency cell of both sides."""
    out = list(arrays)
    for s in (0, 4):
        a = out[s].clone()
        a[a == 0] = -0.0
        out[s] = a
    return out


def cases(dev):
    """(label, arrays, weights) of every case held bit for bit."""
    aids = weights()
    served = aids_requests(2)
    for i, arrays in enumerate(served):
        yield f"AIDS request {i} (T {arrays[0].shape[0]})", arrays, aids
    for i, arrays in enumerate(dense_requests(2)):
        yield (f"average-degree-8 request {i} (T {arrays[0].shape[0]})",
               arrays, aids)
    main = served[0]
    yield "all-pad tiles mixed with live ones", with_pad_tiles(
        main, (0, 5, 17, main[0].shape[0])), aids
    yield "three all-pad tiles", [torch.zeros_like(x[:3]) for x in main], aids
    for t in (1, 2, 3):
        yield f"T {t}", [x[:t].contiguous() for x in main], aids
    yield "T 2, one tile all-pad", with_pad_tiles(
        [x[:1] for x in main], (1,)), aids
    yield "dense random 0/1 adjacency", rewired(main, 1, dense_01), aids
    yield "random adjacency weights in [-1, 1]", rewired(main, 2,
                                                          uniform), aids
    yield "-0 in the adjacency", negative_zeros(main), aids
    dead = [x.clone() for x in main]
    dead[8][::3, 0] = 0.0         # slots whose nodes stay masked in
    yield "live nodes in pad pair slots", dead, aids
    small = [pr for pr in query_pairs(1, 4 * BATCH)
             if max(g["adj"].shape[0] for g in pr) <= 30][:BATCH]
    yield "NB 30 (scalar adjacency loads)", packed(small, dev, 30), aids
    yield "narrow gcn (16,8,8,4)", main, weights(
        SimGNNConfig(gcn_dims=(16, 8, 8, 4)), 1)
    for dims in ((32,), (64, 32), (24, 20, 16, 12, 10, 8, 6, 5),
                 (128,) * 8):
        yield f"gcn {dims}", main, weights(SimGNNConfig(gcn_dims=dims), 2)
    yield "bf16 params", main, weights(dtype="bfloat16")
    wide = SimGNNConfig(ntn_k=40)
    yield "NTN K 40 (the single route at NB 64)", main, weights(wide, 3)
    gcn, att, ntn, fcn = weights()
    flat = torch.empty(gcn[1]["w"].numel() + 1, device=dev)
    flat[1:] = gcn[1]["w"].reshape(-1)
    off = [dict(x) for x in gcn]
    off[1]["w"] = flat[1:].view(gcn[1]["w"].shape)
    yield "W2 off 16-byte alignment", main, (off, att, ntn, fcn)
    g, a, n, f = weights()
    g = [dict(x) for x in g]
    for layer in g:
        w = layer["w"].clone()
        w[::3] = -0.0
        layer["w"] = w
    n["w"] = n["w"].clone()
    n["w"][:, ::4] = -0.0
    yield "-0 weights (W rows, NTN W)", main, (g, a, n, f)
    label0 = int(main[1][0, 0])                 # tile 0's node 0, lhs

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
        for what, at in (("w0", (label0, 3)), ("w0", (0, 5)),
                         ("w0", (7, 100)), ("w1", (70, 2)),
                         ("w2", (5, 31)), ("att", (4, 4)),
                         ("ntn", (3, 5, 6))):
            yield (f"{value} in {what}{at}", main,
                   poisoned(what, at, value))


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
        got = packed_pair_score(*arrays, *w)
        want = parent(arrays, *w)
        torch.cuda.synchronize()
        eq = same_values(got, want)
        bits = bool(torch.equal(got.view(torch.int32),
                                want.view(torch.int32)))
        bad += not eq
        nan = int(torch.isnan(got).sum())
        plan = packed_pair_score.last_plan
        results.append({"case": label, "shape": list(got.shape),
                        "equal": eq, "same_bit_patterns": bits, "nan": nan,
                        "plan": plan.summary()})
        print(f"{'equal' if eq else 'DIFFERS'}"
              f"{'' if bits else ' (bit patterns differ)'}: {label} "
              f"{tuple(got.shape)} ({nan} NaN; {plan.route} route)")
    timing = []
    if args.time:
        current = launcher(pp._lib().packed_pair_score_launch, True)
        w = weights()
        for label, arrays, wt in (
                ("AIDS request", aids_requests(1)[0], w),
                ("average-degree-8 request", dense_requests(1)[0], w),
                ("narrow gcn (16,8,8,4)", aids_requests(1)[0],
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
            packed_pair_score(*arrays, *wt)
            timing.append({"case": label, "tiles": arrays[0].shape[0],
                           "plan": packed_pair_score.last_plan.summary(),
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
    (out / "packed_pair_parent.json").write_text(json.dumps(
        {"card": smi, "cases": results, "timing": timing}, indent=1))
    print(f"card: {smi}; {len(results) - bad} of {len(results)} cases equal")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
