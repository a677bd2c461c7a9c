"""Hold `csrc/fused_pair.cu` against an earlier version of the same source,
bit for bit, and time the two side by side on one NVIDIA GPU.

    python3 tools/fused_pair_parent_check.py PARENT.cu [--time]

PARENT.cu is the one-CTA-per-pair kernel this design replaced (its C
interface: `fused_pair_score_launch(s1, s2, out, B, n, f0, scratch,
SimgnnParams*, stream)`, with the scratch floats a pair from
`fused_pair_scratch_floats(n, SimgnnParams*)`), for example extracted with
`git show <rev>:src/repro_torch/csrc/fused_pair.cu`. It is built with the
port's nvcc flags beside the current library. Both run on the same inputs:
the four buckets (8, 16, 32, 64) of the forced 256-pair request
(`query_pairs(1, 2048)[:256]` through `bucket_pairs`), B of 1, 2 and 3 at
buckets 16, 32 and 64, 2048 pairs at bucket 32, the oversize buckets 128,
256 and 512, masks with holes, a pair of very different sizes, all-zero
masks (with and without features), NaN and inf in the raw adjacency of
masked-out rows, the narrow config, 1- and 8-layer stacks (odd widths),
NaN and ±inf in W0, W1, the Att W and the NTN W, and bf16 params. "Equal"
is `torch.equal` on the values with NaN in the same places (the bit
patterns are compared too and reported). With `--time`, bucket 64 (39
pairs), one pair at bucket 32, the 130-node pair at bucket 256, the
forced request's other buckets and one and three pairs at bucket 64 are
timed parent, current, current, parent: CUDA events around 20
back-to-back calls through the same host path (`launcher`; host launch
gaps included), and around a CUDA graph of 20 launches (device time).
Writes `chiprun_out/fused_pair_parent.json`; exits 1 if any case differs.
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
from repro_torch.data.graphs import (edit_graph, query_pairs,  # noqa: E402
                                     random_graph)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import fused_pair as fp  # noqa: E402
from repro_torch.kernels.fused_pair import (FusedSide,  # noqa: E402
                                            fused_pair_score)

sys.path.insert(0, str(ROOT / "tools"))
from sparse_pair_parent_check import graph_ms, same_values  # noqa: E402


def launcher(current: bool, lib=None):
    """A call of either kernel as a function of (arrays, weights) doing the
    same host work (side structs, params struct, output, the plan or the
    scratch buffer), so that back-to-back calls of the two compare
    kernels, not wrappers."""
    def run(arrays, gcn, att, ntn, fcn):
        b, n, _ = arrays[0].shape
        f0 = arrays[1].shape[-1]
        dev = arrays[0].device
        sides = [FusedSide(*(x.data_ptr() for x in arrays[s:s + 3]))
                 for s in (0, 3)]
        prm, _keep = build.simgnn_params(
            {"gcn": gcn, "att": {"w": att}, "ntn": ntn, "fcn": fcn}, dev)
        y = torch.empty((b,), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        if current:
            plan = fp.plan_for(b, n, f0, gcn, att, ntn, fcn, dev)
            if plan.route == "cluster":
                err = fp._lib().fused_pair_cluster_launch(
                    ctypes.byref(sides[0]), ctypes.byref(sides[1]),
                    y.data_ptr(), b, ctypes.byref(prm),
                    ctypes.byref(fp._layout_struct(plan)), stream)
            else:
                s = (torch.empty(plan.scratch_floats, device=dev)
                     if plan.scratch_floats else None)
                err = fp._lib().fused_pair_score_launch(
                    ctypes.byref(sides[0]), ctypes.byref(sides[1]),
                    y.data_ptr(), b, n, f0,
                    None if s is None else s.data_ptr(), ctypes.byref(prm),
                    stream)
        else:
            per = lib.fused_pair_scratch_floats(n, ctypes.byref(prm))
            s = torch.empty(b * per, device=dev) if per else None
            err = lib.fused_pair_score_launch(
                ctypes.byref(sides[0]), ctypes.byref(sides[1]), y.data_ptr(),
                b, n, f0, None if s is None else s.data_ptr(),
                ctypes.byref(prm), stream)
        build.check_launch(err, "fused_pair")
        return y
    return run


def parent_launcher(src: Path):
    """The earlier kernel's launch as a function of (arrays, weights)."""
    out = build.BUILD_ROOT / "parent"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "fused_pair_parent.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    build.check_side_struct(lib, "fused_side_size", FusedSide)
    build.bind(lib.fused_pair_scratch_floats,
               [ctypes.c_int, ctypes.POINTER(build.SimgnnParams)],
               restype=ctypes.c_longlong)
    build.bind(lib.fused_pair_score_launch, [
        ctypes.POINTER(FusedSide), ctypes.POINTER(FusedSide),
        ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.POINTER(build.SimgnnParams), ctypes.c_void_p])
    return launcher(False, lib)


def weights(cfg=CONFIG, seed=0, dtype="float32"):
    p = init_simgnn_params(torch.Generator().manual_seed(seed),
                           cfg._replace(dtype=dtype), device="cuda")
    return [dict(x) for x in p["gcn"]], p["att"]["w"], dict(p["ntn"]), \
        [dict(x) for x in p["fcn"]]


def arrays_of(bucket):
    lhs, rhs, _ = bucket
    return [x.contiguous() for x in (lhs.adj, lhs.feats, lhs.mask, rhs.adj,
                                     rhs.feats, rhs.mask)]


def forced_buckets(dev) -> dict:
    """Bucket -> arrays of the forced 256-pair request."""
    pairs = query_pairs(1, 2048)[:256]
    return {k: arrays_of(v) for k, v in batching.bucket_pairs(
        pairs, CONFIG.n_node_labels, allow_oversize=True, device=dev).items()}


def oversize(dev, sizes, seed=7) -> dict:
    """Bucket -> arrays of one pair (a graph of each size and an edit of
    it) per size."""
    rng = np.random.default_rng(seed)
    out = {}
    for n in sizes:
        g = random_graph(rng, n)
        out.update({k: arrays_of(v) for k, v in batching.bucket_pairs(
            [(g, edit_graph(rng, g, 3))], CONFIG.n_node_labels,
            allow_oversize=True, device=dev).items()})
    return out


def take(arrays, b):
    return [x[:b].contiguous() for x in arrays]


def cases(dev):
    """(label, arrays, weights) of every case held bit for bit."""
    aids = weights()
    forced = forced_buckets(dev)
    for k in sorted(forced):
        yield f"forced request bucket {k} (B {forced[k][0].shape[0]})", \
            forced[k], aids
    for k in (16, 32, 64):
        for b in (1, 2, 3):
            yield f"B {b} at bucket {k}", take(forced[k], b), aids
    many = [torch.cat([x] * 11)[:2048].contiguous() for x in forced[32]]
    yield "2048 pairs at bucket 32", many, aids
    big = oversize(dev, (100, 130, 300))
    assert sorted(big) == [128, 256, 512], sorted(big)
    for k in sorted(big):
        n_live = int(big[k][2].sum())
        yield f"oversize bucket {k} ({n_live} live nodes)", big[k], aids
    holes = [x.clone() for x in forced[64]]
    holes[2][:, 3::7] = 0.0
    holes[5][:, 1::5] = 0.0
    yield "bucket 64, masks with holes", holes, aids
    rng = np.random.default_rng(11)
    lop = batching.bucket_pairs([(random_graph(rng, 60), random_graph(rng, 5)),
                                 (random_graph(rng, 4), random_graph(rng, 58))],
                                CONFIG.n_node_labels, device=dev)
    yield "lopsided pairs (60 vs 5, 4 vs 58 nodes)", arrays_of(lop[64]), aids
    zero = [x.clone() for x in forced[32][:6]]
    zero[2][:] = 0.0
    zero[5][::2] = 0.0
    yield "all-zero masks (features kept)", zero, aids
    yield "all-zero pairs", [torch.zeros_like(x[:3]) for x in forced[32]], \
        aids
    for value in (float("nan"), float("inf")):
        for k in (32, 64):
            poisoned = [x.clone() for x in forced[k]]
            for s in (0, 3):
                adj, mask = poisoned[s], poisoned[s + 2]
                dead = mask == 0                       # [B, n]
                row = dead.unsqueeze(-1).expand_as(adj).clone()
                row[::2] = False                       # half the pairs
                adj[row & (torch.rand(adj.shape, device=dev) < 0.05)] = value
            yield f"{value} in the raw adjacency of masked-out rows, " \
                  f"bucket {k}", poisoned, aids
    yield "narrow gcn (16,8,8,4)", forced[32], weights(
        SimGNNConfig(gcn_dims=(16, 8, 8, 4)), 1)
    yield "narrow gcn (16,8,8,4), bucket 256", big[256], weights(
        SimGNNConfig(gcn_dims=(16, 8, 8, 4)), 1)
    for dims in ((32,), (24, 20, 16, 12, 10, 8, 6, 5), (128,) * 8):
        for k in (32, 64):
            yield f"gcn {dims}, bucket {k}", forced[k], weights(
                SimGNNConfig(gcn_dims=dims), 2)
    yield "bf16 params", forced[64], weights(dtype="bfloat16")
    yield "bf16 params, bucket 32", forced[32], weights(dtype="bfloat16")
    lab = int(forced[64][1][0, 0].argmax())          # pair 0's node 0, lhs

    def poisoned_w(what, at, value):
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
        for what, at in (("w0", (lab, 3)), ("w0", (7, 100)),
                         ("w1", (70, 2)), ("att", (4, 4)),
                         ("ntn", (3, 5, 6))):
            for k in (32, 64):
                yield (f"{value} in {what}{at}, bucket {k}", forced[k],
                       poisoned_w(what, at, value))
        yield f"{value} in w0, bucket 256", big[256], poisoned_w(
            "w0", (lab, 3), value)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path)
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.manual_seed(0)
    parent = parent_launcher(args.parent)
    results, bad = [], 0
    for label, arrays, w in cases(dev):
        got = fused_pair_score(*arrays, *w)
        want = parent(arrays, *w)
        torch.cuda.synchronize()
        eq = same_values(got, want)
        bits = bool(torch.equal(got.view(torch.int32),
                                want.view(torch.int32)))
        bad += not eq
        nan = int(torch.isnan(got).sum())
        plan = fused_pair_score.last_plan
        results.append({"case": label, "shape": list(got.shape),
                        "equal": eq, "same_bit_patterns": bits, "nan": nan,
                        "plan": plan.summary()})
        print(f"{'equal' if eq else 'DIFFERS'}"
              f"{'' if bits else ' (bit patterns differ)'}: {label} "
              f"{tuple(got.shape)} ({nan} NaN); {plan.summary()}")
    timing = []
    if args.time:
        current = launcher(True)
        w = weights()
        forced = forced_buckets(dev)
        big = oversize(dev, (130,))
        for label, arrays in (("bucket 64 (39 pairs)", forced[64]),
                              ("one pair at bucket 32", take(forced[32], 1)),
                              ("130-node pair at bucket 256", big[256]),
                              ("bucket 8 (2 pairs)", forced[8]),
                              ("bucket 16 (22 pairs)", forced[16]),
                              ("bucket 32 (193 pairs)", forced[32]),
                              ("one pair at bucket 64", take(forced[64], 1)),
                              ("3 pairs at bucket 64", take(forced[64], 3))):

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
            old = lambda: parent(arrays, *w)              # noqa: E731
            new = lambda: current(arrays, *w)             # noqa: E731
            t = [ms(old), ms(new), ms(new), ms(old)]
            g = [graph_ms(old), graph_ms(new), graph_ms(new), graph_ms(old)]
            fused_pair_score(*arrays, *w)
            timing.append({"case": label, "pairs": arrays[0].shape[0],
                           "bucket": arrays[0].shape[1],
                           "plan": fused_pair_score.last_plan.summary(),
                           "parent_ms": [t[0], t[3]],
                           "current_ms": [t[1], t[2]],
                           "graph_parent_ms": [g[0], g[3]],
                           "graph_current_ms": [g[1], g[2]]})
            print(f"time {label}: back-to-back calls parent {t[0]:.4f} / "
                  f"{t[3]:.4f} ms, current {t[1]:.4f} / {t[2]:.4f} ms; CUDA "
                  f"graph parent {g[0]:.4f} / {g[3]:.4f} ms, current "
                  f"{g[1]:.4f} / {g[2]:.4f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fused_pair_parent.json").write_text(json.dumps(
        {"card": smi, "cases": results, "timing": timing}, indent=1))
    print(f"card: {smi}; {len(results) - bad} of {len(results)} cases equal")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
