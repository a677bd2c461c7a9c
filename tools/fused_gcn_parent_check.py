"""Hold `csrc/fused_gcn.cu` against an earlier version of the same source,
bit for bit, and time the two side by side on one NVIDIA GPU.

    python3 tools/fused_gcn_parent_check.py PARENT.cu [--time]

PARENT.cu is the one-CTA-per-graph kernel this design replaced (its C
interface: `fused_gcn_scratch_floats(n, SimgnnParams*)` and
`fused_gcn_launch(adj, feats, mask, out, B, n, f0, scratch, SimgnnParams*,
stream)`), for example extracted with `git show <rev>:src/repro_torch/
csrc/fused_gcn.cu`. It is built with the port's nvcc flags beside the
current library. Both run on the same inputs: the search corpus's buckets
(`zipf_corpus(2, 8192)`), the query batches and single queries of the
search phase, buckets 128 and 256, the narrow config, batches around the
persistent grid, one- and eight-layer stacks, NaN and inf weights,
overflowing weights, inputs whose pad rows are not zero, buckets that are
not multiples of 4 and inputs that are not 16-byte aligned. "Equal" is
`torch.equal` on the values with NaN in the same places. With `--time`,
each search-phase launch shape is timed parent, current, current, parent
(CUDA events around 20 back-to-back launches). Writes
`chiprun_out/fused_gcn_parent.json`; exits 1 if any case differs.
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
from repro_torch.core.batching import bucket_for, pad_graphs  # noqa: E402
from repro_torch.core.gcn import normalized_adjacency  # noqa: E402
from repro_torch.core.simgnn import (SimGNNConfig,  # noqa: E402
                                     init_simgnn_params)
from repro_torch.data.graphs import (random_graph, zipf_corpus,  # noqa: E402
                                     zipf_query_stream)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fused_gcn import fused_gcn_att  # noqa: E402


def parent_launcher(src: Path):
    """The earlier kernel's launch as a function of (arrays, gcn, att)."""
    out = build.BUILD_ROOT / "parent"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "fused_gcn_parent.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    need = build.bind(lib.fused_gcn_scratch_floats,
                      [ctypes.c_int, ctypes.POINTER(build.SimgnnParams)],
                      restype=ctypes.c_longlong)
    launch = build.bind(lib.fused_gcn_launch, [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p,
                             ctypes.POINTER(build.SimgnnParams),
                             ctypes.c_void_p])

    def run(adj, feats, mask, gcn, att):
        b, n, _ = adj.shape
        p, _keep = build.simgnn_params({"gcn": gcn, "att": {"w": att}},
                                       adj.device)
        per = need(n, ctypes.byref(p))
        scratch = (torch.empty(b * per, device=adj.device) if per else None)
        y = torch.empty((b, gcn[-1]["w"].shape[1]), device=adj.device)
        build.check_launch(launch(
            adj.data_ptr(), feats.data_ptr(), mask.data_ptr(), y.data_ptr(),
            b, n, feats.shape[-1],
            None if scratch is None else scratch.data_ptr(), ctypes.byref(p),
            torch.cuda.current_stream().cuda_stream), "parent fused_gcn")
        return y
    return run


def same_bits(x, y) -> bool:
    nx, ny = torch.isnan(x), torch.isnan(y)
    return bool(torch.equal(nx, ny) and torch.equal(x[~nx], y[~ny]))


def embed_in(graphs, bucket, dev, n_labels=29):
    b = pad_graphs(graphs, n_labels, bucket, device=dev)
    return normalized_adjacency(b.adj, b.mask), b.feats, b.mask


def params(dims=(128, 64, 32), seed=0, n_labels=29):
    cfg = SimGNNConfig(n_node_labels=n_labels, gcn_dims=dims)
    p = init_simgnn_params(torch.Generator().manual_seed(seed), cfg,
                           device="cuda")
    return [dict(x) for x in p["gcn"]], p["att"]["w"]


def cases(dev):
    """(label, arrays, gcn, att) of every case held bit for bit."""
    rng = np.random.default_rng(5)
    aids = params()
    corpus = zipf_corpus(2, 8192)
    stream = zipf_query_stream(3, 2, n_corpus=16)
    queries = [next(stream)["query"] for _ in range(64)]
    by = {}
    for g in corpus:
        by.setdefault(bucket_for(g["adj"].shape[0], allow_oversize=True),
                      []).append(g)
    for b, gs in sorted(by.items()):
        yield f"corpus bucket {b} ({len(gs)} graphs)", embed_in(gs, b, dev), \
            *aids
    qb = {}
    for q in queries:
        qb.setdefault(bucket_for(q["adj"].shape[0], allow_oversize=True),
                      []).append(q)
    for b, qs in sorted(qb.items()):
        yield f"query batch bucket {b} ({len(qs)})", embed_in(qs, b, dev), \
            *aids
    for i, q in enumerate(queries[:8]):
        b = bucket_for(q["adj"].shape[0], allow_oversize=True)
        yield f"one query {i} at bucket {b}", embed_in([q], b, dev), *aids
    big = [random_graph(rng, int(n)) for n in (70, 100, 128)]
    yield "bucket 128", embed_in(big, 128, dev), *aids
    yield "bucket 256 (130 nodes)", embed_in(
        [random_graph(np.random.default_rng(7), 130)], 256, dev), *aids
    narrow = params((16, 8, 8, 4), 1)
    for b in (8, 16, 32, 64, 128, 256):
        sizes = rng.integers(max(1, b // 2), b + 1, 9)
        yield f"narrow bucket {b}", embed_in(
            [random_graph(rng, int(n)) for n in sizes], b, dev), *narrow
    for n_b in (1, 7, 131, 132, 133, 264, 5 * 132 + 3):
        sizes = rng.integers(3, 33, n_b)
        yield f"B {n_b} at bucket 32", embed_in(
            [random_graph(rng, int(n)) for n in sizes], 32, dev), *aids
    g32 = embed_in([random_graph(rng, int(n)) for n in (5, 17, 32, 29, 1)],
                   32, dev)
    g64 = embed_in([random_graph(rng, int(n)) for n in (33, 64, 40)], 64, dev)
    for dims in ((32,), (24, 20, 16, 12, 10, 8, 6, 5), (128,) * 8, (256, 256)):
        for lbl, arr in (("32", g32), ("64", g64)):
            yield f"gcn {dims} bucket {lbl}", arr, *params(dims, 2)

    def poisoned(layer, what, value, at):
        gcn, att = params()
        if what == "att":
            att = att.clone()
            att[at] = value
        else:
            gcn[layer][what] = gcn[layer][what].clone()
            gcn[layer][what][at] = value
        return gcn, att
    for value in (float("nan"), float("inf"), -float("inf")):
        for layer, what, at in ((0, "w", (3, 5)), (1, "w", (70, 2)),
                                (2, "b", 7), (0, "b", 1), (0, "att", (4, 4))):
            for lbl, arr in (("32", g32), ("64", g64)):
                yield (f"{value} in {what}[{layer}]{at} bucket {lbl}", arr,
                       *poisoned(layer, what, value, at))
    gcn, att = params()
    huge = [dict(p, w=p["w"] * 1e30) for p in gcn]
    yield "overflowing weights", g32, huge, att
    a, f, m = (x.clone() for x in g32)
    a[1, 2, 3] = float("nan")
    yield "NaN in one graph's A'", (a, f, m), gcn, att
    a, f, m = (x.clone() for x in g32)
    a[0, 20, 1] = 0.5                     # pad row of a 5-node graph
    a[0, 2, 25] = -0.25                   # pad column
    f[2, 31, 0] = 1.0
    m[1, 30] = 1.0                        # a masked-in pad row
    m[3, 10] = 0.0                        # a hole in a real graph
    yield "pad rows that are not zero", (a, f, m), gcn, att
    dense = torch.from_numpy(rng.standard_normal((6, 64, 64)).astype(
        np.float32)).to(dev)
    feats = torch.from_numpy(rng.random((6, 64, 29)).astype(np.float32)).to(dev)
    mask = torch.from_numpy((rng.random((6, 64)) < 0.7).astype(
        np.float32)).to(dev)
    yield "dense random inputs", (dense, feats, mask), gcn, att
    for n_odd in (13, 30, 50):
        yield f"bucket {n_odd}", embed_in(
            [random_graph(rng, int(n)) for n in (n_odd, 3, n_odd - 2)],
            n_odd, dev), gcn, att

    def offset(x):
        flat = torch.empty(x.numel() + 1, device=dev)
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)
    yield "inputs off 16-byte alignment", tuple(offset(x) for x in g32), \
        gcn, att
    g36 = embed_in([random_graph(rng, int(n)) for n in (9, 33, 20)], 64, dev,
                   n_labels=32)
    yield "32 labels (16-byte feats rows)", g36, *params((64, 32), 3, 32)


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
    for label, arrays, gcn, att in cases(dev):
        got = fused_gcn_att(*arrays, gcn, att)
        want = parent(*arrays, gcn, att)
        torch.cuda.synchronize()
        eq = same_bits(got, want)
        bad += not eq
        nan = int(torch.isnan(got).sum())
        results.append({"case": label, "shape": list(got.shape),
                        "equal": eq, "nan": nan})
        print(f"{'equal' if eq else 'DIFFERS'}: {label} {tuple(got.shape)}"
              f" ({nan} NaN)")
    timing = []
    if args.time:
        gcn, att = params()
        corpus = zipf_corpus(2, 8192)
        stream = zipf_query_stream(3, 2, n_corpus=16)
        queries = [next(stream)["query"] for _ in range(64)]
        shapes = {}
        for g in corpus:
            shapes.setdefault(bucket_for(g["adj"].shape[0],
                                         allow_oversize=True), []).append(g)
        runs = [(f"corpus bucket {b}", gs, b) for b, gs in sorted(
            shapes.items())]
        runs += [("one graph at bucket 32", [queries[0]], 32)]
        qb = {}
        for q in queries:
            qb.setdefault(bucket_for(q["adj"].shape[0]), []).append(q)
        runs += [(f"query batch bucket {b}", qs, b)
                 for b, qs in sorted(qb.items())]
        for label, gs, b in runs:
            arrays = embed_in(gs, b, dev)

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
            old = lambda: parent(*arrays, gcn, att)        # noqa: E731
            new = lambda: fused_gcn_att(*arrays, gcn, att)  # noqa: E731
            t = [ms(old), ms(new), ms(new), ms(old)]
            timing.append({"case": label, "graphs": len(gs), "bucket": b,
                           "parent_ms": [t[0], t[3]],
                           "current_ms": [t[1], t[2]]})
            print(f"time {label} ({len(gs)} graphs): parent {t[0]:.4f} / "
                  f"{t[3]:.4f} ms, current {t[1]:.4f} / {t[2]:.4f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fused_gcn_parent.json").write_text(json.dumps(
        {"card": smi, "cases": results, "timing": timing}, indent=1))
    print(f"card: {smi}; {len(results) - bad} of {len(results)} cases equal")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
