"""Hold the top-M scans of `csrc/retrieval.cu` against an earlier version of
the same source, bit for bit, and time the two side by side on one NVIDIA
GPU.

    python3 tools/topm_parent_check.py PARENT.cu [--time]

PARENT.cu is an earlier source with the same C entry points
(`topm_dot_launch(qv, corpus, Q, N, F, cols, M, ps, pi, out_s, out_i,
stream)` and `topm_ntn_launch(...)`, the two-pass sort route of each scan,
`topm_list_entries(Q, N, cols, M)`, and, for `--time`, the dot scan's
`topm_select_launch` with the layout struct it was built with), for example
extracted with `git show <rev>:src/repro_torch/csrc/retrieval.cu`. It is
built with the port's nvcc flags beside the current library.

Every case runs the dot scan (the package's `blocked_topm`, on the route
its plan picks) against the parent's sort route, and the NTN scan three
ways: the package's `blocked_topm_ntn` (the route `topm_ntn_plan` picks),
the current source's sort route forced, and the parent's sort route.
The shared cases: the served shapes (Q, N, M, block_cols) = (64, 8192, 64,
256) and (1, 8192, 8192, 256), block_cols 8, 64 and 1024, Q of 1, 3, 5,
65 and 127 (not multiples of the queries a CTA), N not a multiple of the
chunk, M of 1, 32, 33, above block_cols, 255, 256, 257 (the sort route)
and M = N, duplicated rows in other chunks and other CTAs of a cluster,
coarse integer data (ties everywhere), rows whose dot scores are -0 and +0,
+inf and -inf entries, NaN rows, an all-NaN corpus, F of 4, 5, 33 and 64,
and a corpus and a query one float past a 16-byte boundary. The NTN
scan's own cases: K 40, FCN stacks of other depths (16-16-8-4-1, 16-8-1,
16-1) and one wider than the select route holds (16-48-1), NaN and +-inf
in uq, in dq, in the FCN weights and in corpus rows, logits of -0 and +0
(the last layer's products underflow to a zero of their sign, its bias
-0), weights of -1, 0 and 1 on small integers (ties across chunks and
CTAs), duplicated rows, Q of 1, 3, 5 and 127, and uq, dq and the corpus
one float past 16 bytes. "Equal" is the same indices and the same int32
bit patterns of the scores. With `--time`, the served shape (64, 8192, 64,
block 256) is timed parent, current, current, parent for both scans (the
parent's dot select route and NTN sort route) from CUDA events around one
replay of a CUDA graph of 20 calls (device time, no host gaps) and from a
`torch.profiler` trace of 20 calls (each kernel's time), and so is the M
= N shape. Writes `chiprun_out/topm_parent.json`; exits 1 if any case
differs.
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
from repro_torch.core.simgnn import (SimGNNConfig,  # noqa: E402
                                     init_simgnn_params)
from repro_torch.kernels import build, retrieval  # noqa: E402

SERVED = (64, 8192, 64, 256)
SERVED_M_EQ_N = (1, 8192, 8192, 256)


class ParentLayout(ctypes.Structure):
    """The select route's layout struct before the NTN phase (no queries
    a CTA, no NTN region): what c96f873's `topm_select_launch` takes."""
    _fields_ = ([(n, ctypes.c_int) for n in ("chunk", "ld", "lds", "cs",
                                             "per", "r")]
                + [("stage_off", ctypes.c_int * 2)]
                + [(n, ctypes.c_int) for n in ("sc_off", "queue_off",
                                               "thr_off", "bar_off",
                                               "list_off", "gather_off",
                                               "smem_words")])


def parent_library(src: Path) -> ctypes.CDLL:
    out = build.BUILD_ROOT / "parent"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "retrieval_parent.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(so), str(src)], check=True,
                   stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    build.bind(lib.topm_dot_launch, [ptr, ptr] + [i32] * 5 + [ptr] * 5)
    build.bind(lib.topm_ntn_launch, [ptr] * 3 + [i32] * 6 + [ptr] * 4
               + [ctypes.POINTER(build.SimgnnParams), ptr])
    build.bind(lib.topm_list_entries, [i32] * 4, ctypes.c_longlong)
    return lib


def parent_scans(lib):
    """(dot, dot_select, ntn) of the earlier source, with the wrappers'
    arguments: the dot scan's sort route, its select route on the current
    plan's layout (None where the source has no such entry point), and
    the NTN scan's sort route."""
    def buffers(q, n, m, cols, dev):
        e = lib.topm_list_entries(q, n, cols, m)
        return (torch.empty(e, device=dev),
                torch.empty(e, dtype=torch.int32, device=dev),
                torch.empty((q, m), device=dev),
                torch.empty((q, m), dtype=torch.int32, device=dev))

    def dot(qv, corpus, m, cols):
        (q, f), n = qv.shape, corpus.shape[0]
        m = min(m, n)
        ps, pi, s, i = buffers(q, n, m, cols, qv.device)
        build.check_launch(lib.topm_dot_launch(
            qv.data_ptr(), corpus.data_ptr(), q, n, f, cols, m,
            ps.data_ptr(), pi.data_ptr(), s.data_ptr(), i.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "parent topm")
        return s, i

    def ntn(uq, dq, corpus, fcn, m, cols):
        (q, k), (n, f) = dq.shape, corpus.shape
        m = min(m, n)
        prm, _keep = build.simgnn_params({"fcn": fcn}, uq.device)
        ps, pi, s, i = buffers(q, n, m, cols, uq.device)
        build.check_launch(lib.topm_ntn_launch(
            uq.data_ptr(), dq.data_ptr(), corpus.data_ptr(), q, n, f, k,
            cols, m, ps.data_ptr(), pi.data_ptr(), s.data_ptr(),
            i.data_ptr(), ctypes.byref(prm),
            torch.cuda.current_stream().cuda_stream), "parent topm_ntn")
        return s, i

    dot_select = None
    if hasattr(lib, "topm_layout_size") and \
            lib.topm_layout_size() == ctypes.sizeof(ParentLayout):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        build.bind(lib.topm_select_launch, [ptr, ptr] + [i32] * 4
                   + [ptr] * 2 + [ctypes.POINTER(ParentLayout), ptr])

        def dot_select(qv, corpus, m, cols):
            (q, f), n = qv.shape, corpus.shape[0]
            plan = retrieval.plan_for(q, n, f, m, cols, qv.device)
            assert plan.route == "select" and plan.queries == 4, plan
            lay = ParentLayout()
            for name, v in plan.layout:
                if name == "stage_off":
                    lay.stage_off[0], lay.stage_off[1] = v
                elif name not in ("qb", "ntn_off"):
                    setattr(lay, name, v)
            s = torch.empty((q, m), device=qv.device)
            i = torch.empty((q, m), dtype=torch.int32, device=qv.device)
            build.check_launch(lib.topm_select_launch(
                qv.data_ptr(), corpus.data_ptr(), q, n, f, m, s.data_ptr(),
                i.data_ptr(), ctypes.byref(lay),
                torch.cuda.current_stream().cuda_stream), "parent select")
            return s, i
    return dot, dot_select, ntn


def current_ntn_sort(uq, dq, corpus, fcn, m, cols):
    """The current source's NTN sort route, forced."""
    (q, k), (n, f) = dq.shape, corpus.shape
    m = min(m, n)
    dims = (k,) + tuple(int(p["w"].shape[1]) for p in fcn)
    plan = retrieval.topm_ntn_plan(q, n, f, dims, m, cols,
                                   *retrieval.device_limits(0), route="sort")
    prm, _keep = build.simgnn_params({"fcn": fcn}, uq.device)
    s = torch.empty((q, m), device=uq.device)
    i = torch.empty((q, m), dtype=torch.int32, device=uq.device)
    retrieval.launch_ntn(plan, uq.data_ptr(), dq.data_ptr(),
                         corpus.data_ptr(), q, n, f, k, m, prm, s, i)
    return s, i


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


def profiler_ms(fn, iters: int = 20) -> float:
    """Device ms a call of the top-M kernels `fn` launches, from a
    `torch.profiler` trace of `iters` warm calls: each kernel's time
    averaged over the launches the trace kept, summed over the kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "device_time_total", getattr(
        e, "cuda_time_total", 0.0)) / e.count
        for e in prof.key_averages() if "topm" in e.key and e.count) / 1e3


def off16(x: torch.Tensor) -> torch.Tensor:
    """`x`'s values in a contiguous view one float past a 16-byte
    boundary."""
    flat = torch.empty(x.numel() + 1, device=x.device)
    flat[1:] = x.reshape(-1)
    out = flat[1:].view(x.shape)
    assert out.data_ptr() % 16 == 4
    return out


def data(q, n, f=32, seed=0, kind="normal"):
    rng = np.random.default_rng(seed)
    qv = rng.standard_normal((q, f)).astype(np.float32)
    corpus = rng.standard_normal((n, f)).astype(np.float32)
    if kind == "coarse":
        qv, corpus = (rng.integers(-2, 3, x.shape).astype(np.float32)
                      for x in (qv, corpus))
    elif kind == "signed_zero":
        # every product of a tiny row underflows to a zero of its sign, so
        # its score is -0 or +0 by the sign of the last product
        qv = rng.choice(np.float32([-0.375, -0.25, -0.125, 0.125, 0.25,
                                    0.375]), qv.shape)
        tiny = np.float32(1.4e-45)
        corpus[::2] = np.where(rng.random(corpus[::2].shape) < 0.5, -tiny,
                               tiny)
        corpus[1::2] = -np.abs(corpus[1::2])
        qv = np.abs(qv)                    # the zeros rank first
        qv[:, -1] *= np.where(rng.random(q) < 0.5, -1, 1)
    elif kind == "ties":
        corpus[n // 2:n // 2 + 100] = corpus[:100]      # another cluster rank
        corpus[300:340] = corpus[:40]                   # the same CTA
    elif kind == "inf":
        corpus[[3, 700, 701, n - 1]] = np.inf
        corpus[[5, 250, n // 2], 7] = -np.inf
    elif kind == "nan":
        corpus[[4, 17, 31, n // 2, n - 2]] = np.nan
    elif kind == "all_nan":
        corpus[:] = np.nan
    return (torch.from_numpy(qv).cuda(), torch.from_numpy(corpus).cuda())


def cases():
    """(label, qv, corpus, m, block_cols) of every case held bit for bit."""
    qv, corpus = data(64, 8192)
    yield "served (64, 8192, 64, block 256)", qv, corpus, 64, 256
    yield "served M = N (1, 8192, 8192, block 256)", qv[:1], corpus, 8192, 256
    for cols in (8, 64, 1024):
        yield f"(64, 8192, 64) block {cols}", qv, corpus, 64, cols
    for q in (1, 3, 5, 65, 127):
        big = data(q, 8192, seed=q)
        yield f"Q {q} (8192, 64, block 256)", *big, 64, 256
    for n, cols in ((137, 32), (8191, 256), (1000, 64), (300, 1024)):
        yield f"N {n} (Q 5, M 10, block {cols})", *data(5, n, seed=n), 10, cols
    for m in (1, 32, 33, 100, 255, 256, 257):
        yield f"M {m} (Q 9, N 4000, block 64)", *data(9, 4000, seed=m), m, 64
    yield "M = N = 137 (block 32)", *data(5, 137, seed=2), 137, 32
    yield "M = N = 300 (sort route, block 64)", *data(5, 300, seed=3), 300, 64
    yield "M 100 > block 32", *data(5, 137, seed=4), 100, 32
    for kind, shape in (("ties", (4, 8192, 64, 256)),
                        ("ties", (4, 600, 100, 64)),
                        ("coarse", (64, 8192, 64, 256)),
                        ("coarse", (1, 8192, 8192, 256)),
                        ("coarse", (7, 1000, 256, 128)),
                        ("signed_zero", (5, 600, 250, 64)),
                        ("signed_zero", (64, 8192, 64, 256)),
                        ("inf", (6, 1000, 100, 64)),
                        ("nan", (3, 8192, 64, 256)),
                        ("nan", (3, 40, 40, 16)),
                        ("all_nan", (3, 8, 8, 8)),
                        ("all_nan", (5, 8192, 64, 256))):
        q, n, m, cols = shape
        yield f"{kind} {shape}", *data(q, n, seed=7, kind=kind), m, cols
    for f in (4, 5, 33, 64):
        yield (f"F {f} (64, 8192, 64, block 256)",
               *data(64, 8192, f=f, seed=f), 64, 256)
    yield "F 64, M 256, block 1024", *data(8, 8192, f=64, seed=9), 256, 1024
    qv, corpus = data(64, 8192, seed=11)
    yield "corpus one float past 16 bytes", qv, off16(corpus), 64, 256
    yield "qv one float past 16 bytes", off16(qv), corpus, 64, 256
    yield "both off 16 bytes, M = N", off16(qv[:1]), off16(corpus), 8192, 256


def ntn_params(f: int, seed: int = 5, **cfg):
    """(ntn, fcn) of a SimGNN head at width F (the AIDS config at F 32 and
    no overrides), FCN biases drawn too so that every bias add counts."""
    cfg = CONFIG._replace(**cfg) if f == 32 else SimGNNConfig(
        gcn_dims=(64, f), **cfg)
    p = init_simgnn_params(torch.Generator().manual_seed(seed), cfg,
                           device="cuda")
    gen = torch.Generator().manual_seed(seed + 1)
    for layer in p["fcn"]:
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen).cuda()
    return p["ntn"], p["fcn"]


def collapse(ntn, qv):
    return tuple(torch.from_numpy(x).cuda() for x in
                 retrieval.collapse_query_ntn(ntn, qv.cpu().numpy()))


def ntn_cases():
    """(label, uq, dq, corpus, fcn, m, block_cols) of the NTN scan's own
    cases, held bit for bit across both routes and the parent."""
    qv, corpus = data(64, 8192, seed=21)
    heads = {"K 40": dict(ntn_k=40),
             "FCN 16-16-8-4-1": dict(fcn_dims=(16, 8, 4)),
             "FCN 16-8-1": dict(fcn_dims=(8,)),
             "FCN 16-1": dict(fcn_dims=()),
             "FCN 16-48-1 (wider than the select route holds)":
                 dict(fcn_dims=(48,))}
    for label, cfg in heads.items():
        ntn, fcn = ntn_params(32, **cfg)
        uq, dq = collapse(ntn, qv)
        yield f"{label} (64, 8192, 64, block 256)", uq, dq, corpus, fcn, 64, 256
    ntn, fcn = ntn_params(32, ntn_k=40)
    for q, n, m, cols in ((5, 1000, 1, 64), (3, 4000, 256, 128),
                          (127, 8192, 33, 256)):
        qv2, c2 = data(q, n, seed=q + n)
        yield (f"K 40 (Q {q}, N {n}, M {m}, block {cols})", *collapse(ntn, qv2),
               c2, fcn, m, cols)
    ntn, fcn = ntn_params(32)
    uq, dq = collapse(ntn, qv)
    bad = uq.clone()
    bad[3, 5], bad[7, 100], bad[9, 17], bad[9, 300] = (
        float("nan"), float("inf"), float("-inf"), float("inf"))
    yield "NaN and +-inf in uq", bad, dq, corpus, fcn, 64, 256
    bad = dq.clone()
    bad[2, 3], bad[4, 0], bad[5, 15] = (float("nan"), float("inf"),
                                        float("-inf"))
    yield "NaN and +-inf in dq", uq, bad, corpus, fcn, 64, 256
    for where, (layer, part, at) in (("W1", (0, "w", (3, 2))),
                                     ("W2", (1, "w", (5, 1))),
                                     ("b3", (2, "b", (0,)))):
        for v in (float("inf"), float("nan")):
            fbad = [{k: t.clone() for k, t in p.items()} for p in fcn]
            fbad[layer][part][at] = v
            yield f"{v} in the FCN's {where}", uq, dq, corpus, fbad, 64, 256
    c = corpus.clone()
    c[[4, 17, 31, 4096]] = float("nan")
    c[[3, 700, 8191]] = float("inf")
    c[[5, 250], 7] = float("-inf")
    yield "NaN and +-inf corpus rows", uq, dq, c, fcn, 64, 256
    # logits of -0 and +0: the last layer's products underflow to a zero
    # of their sign; its bias is -0, so a logit is -0 exactly when its
    # last product's zero is
    zero = [{k: t.clone() for k, t in p.items()} for p in fcn]
    zero[1]["w"] *= 1e-25
    zero[1]["b"][:] = 0.0
    zero[2]["w"] *= 1e-25
    zero[2]["b"][:] = -0.0
    for q, n, m, cols in ((64, 8192, 64, 256), (5, 256, 256, 64)):
        qz, cz = data(q, n, seed=3)
        yield (f"logits of -0 and +0 (Q {q}, N {n}, M {m})",
               *collapse(ntn, qz), cz, zero, m, cols)
    # small integers and weights of -1, 0, 1: exact logits, ties across
    # chunks and CTAs; duplicated rows in other ranks and the same CTA
    sign_ntn = {k: torch.sign(t) for k, t in ntn.items()}
    sign_fcn = [{k: torch.sign(t) for k, t in p.items()} for p in fcn]
    for q, n, m, cols in ((64, 8192, 64, 256), (5, 1000, 256, 64),
                          (3, 8192, 1, 256)):
        qc, cc = data(q, n, seed=q, kind="coarse")
        yield (f"coarse, weights -1/0/1 (Q {q}, N {n}, M {m})",
               *collapse(sign_ntn, qc), cc, sign_fcn, m, cols)
    qt, ct = data(6, 8192, seed=8, kind="ties")
    yield "duplicated rows (Q 6, 8192, 64)", *collapse(ntn, qt), ct, fcn, 64, 256
    uq, dq = collapse(ntn, qv)
    yield ("uq, dq and corpus one float past 16 bytes", off16(uq), off16(dq),
           off16(corpus), fcn, 64, 256)


def same(got, want) -> bool:
    return bool(torch.equal(got[1], want[1]) and torch.equal(
        got[0].view(torch.int32), want[0].view(torch.int32)))


def ntn_three(p_ntn, uq, dq, corpus, fcn, m, cols) -> dict:
    """The NTN scan through the package's route, the current sort route
    and the parent's: {"ntn_equal", "ntn_route", "ntn_plan"}."""
    got = retrieval.blocked_topm_ntn(uq, dq, corpus, fcn, m, block_cols=cols)
    plan = retrieval.blocked_topm_ntn.last_plan
    sort = current_ntn_sort(uq, dq, corpus, fcn, m, cols)
    want = p_ntn(uq, dq, corpus, fcn, m, cols)
    torch.cuda.synchronize()
    return {"ntn_equal": same(got, want) and same(sort, want),
            "ntn_route": plan.route, "ntn_plan": plan.summary()}


def timed(label, shape, old, new) -> dict:
    """parent, current, current, parent: CUDA graph and profiler ms."""
    g = [graph_ms(old), graph_ms(new), graph_ms(new), graph_ms(old)]
    p = [profiler_ms(old), profiler_ms(new), profiler_ms(new),
         profiler_ms(old)]
    print(f"time {label} {shape}: CUDA graph parent {g[0]:.5f} / "
          f"{g[3]:.5f} ms, current {g[1]:.5f} / {g[2]:.5f} ms; profiler "
          f"parent {p[0]:.5f} / {p[3]:.5f} ms, current {p[1]:.5f} / "
          f"{p[2]:.5f} ms")
    return {"scan": label, "shape": list(shape),
            "graph_parent_ms": [g[0], g[3]], "graph_current_ms": [g[1], g[2]],
            "profiler_parent_ms": [p[0], p[3]],
            "profiler_current_ms": [p[1], p[2]]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path)
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    p_dot, p_dot_select, p_ntn = parent_scans(parent_library(args.parent))
    results, bad, weights = [], 0, {}
    for label, qv, corpus, m, cols in cases():
        got = retrieval.blocked_topm(qv, corpus, m, block_cols=cols)
        plan = retrieval.blocked_topm.last_plan
        want = p_dot(qv, corpus, m, cols)
        f = qv.shape[1]
        if f not in weights:
            weights[f] = ntn_params(f)
        ntn, fcn = weights[f]
        uq, dq = collapse(ntn, qv)
        torch.cuda.synchronize()
        dot_eq = same(got, want)
        ntn_r = ntn_three(p_ntn, uq, dq, corpus, fcn, m, cols)
        eq = dot_eq and ntn_r["ntn_equal"]
        bad += not eq
        results.append({"case": label, "shape": [*qv.shape, corpus.shape[0],
                                                 got[0].shape[1], cols],
                        "equal": eq, "dot_equal": dot_eq, "route": plan.route,
                        "plan": plan.summary(), **ntn_r})
        print(f"{'equal' if eq else 'DIFFERS'}: {label} (dot "
              f"{'same bits' if dot_eq else 'DIFFERS'} on the {plan.route} "
              f"route, NTN {'same bits' if ntn_r['ntn_equal'] else 'DIFFERS'}"
              f" on the {ntn_r['ntn_route']} route and the sort route)")
    for label, uq, dq, corpus, fcn, m, cols in ntn_cases():
        r = ntn_three(p_ntn, uq, dq, corpus, fcn, m, cols)
        bad += not r["ntn_equal"]
        results.append({"case": "NTN: " + label,
                        "shape": [uq.shape[0], dq.shape[1], corpus.shape[0],
                                  corpus.shape[1], m, cols],
                        "equal": r["ntn_equal"], **r})
        print(f"{'equal' if r['ntn_equal'] else 'DIFFERS'}: NTN {label} (on "
              f"the {r['ntn_route']} route and the sort route)")
    timing = []
    if args.time:
        ntn, fcn = ntn_params(32)
        for q, n, m, cols in (SERVED, SERVED_M_EQ_N):
            qv, corpus = data(q, n, seed=1)
            uq, dq = collapse(ntn, qv)
            dot_old = (p_dot_select if p_dot_select is not None
                       and m <= retrieval.MAX_SELECT else p_dot)
            timing.append(dict(timed(
                "dot", (q, n, m, cols),
                lambda: dot_old(qv, corpus, m, cols),
                lambda: retrieval.blocked_topm(qv, corpus, m,
                                               block_cols=cols)),
                plan=retrieval.blocked_topm.last_plan.summary()))
            timing.append(dict(timed(
                "ntn", (q, n, m, cols),
                lambda: p_ntn(uq, dq, corpus, fcn, m, cols),
                lambda: retrieval.blocked_topm_ntn(uq, dq, corpus, fcn, m,
                                                   block_cols=cols)),
                plan=retrieval.blocked_topm_ntn.last_plan.summary()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "topm_parent.json").write_text(json.dumps(
        {"card": smi, "cases": results, "timing": timing}, indent=1))
    print(f"card: {smi}; {len(results) - bad} of {len(results)} cases equal")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
