"""Where the top-M scans' CTAs spend their time, stage by stage, on one
NVIDIA GPU.

    python3 tools/topm_stages.py [SOURCE.cu]

Builds `csrc/retrieval.cu` (or SOURCE.cu, a variant with the same C
interface and stage marks) with `TOPM_STAGES` defined: thread 0 of each CTA
then sums `clock64()` cycles by stage (the `TOPM_LAP` marks in the source),
and each CTA of the sort route's merge pass records its first and last
cycle. Runs these launches and prints each stage's SM cycles (median and
largest over the CTAs), the whole CTA's, and how the CTAs were placed on
SMs:

  * the dot scan at the served shape (Q, N, M, block_cols) = (64, 8192, 64,
    256) on the select route: the copies issued, staging waits, dots, the
    reads of the bounds the cluster published, selection (and inside it
    thread 0's warp's queue drains, cycles and number), the final queue
    drain, the CTA's merge and push to rank 0, the cluster barrier and the
    cluster merge (rank 0); the stage build adds a barrier after each
    chunk's selection, so its cycles are not booked to the next chunk's
    wait;
  * the same shape forced onto the sort route (the two-pass kernels, kept
    unchanged in the same source): the query load, thread 0's row loads,
    dots and key stores, the tile's barrier, the bitonic sort, the list
    writes, then the merge pass;
  * the M = N shape (1, 8192, 8192, 256), which the plan sends to the sort
    route;
  * the NTN scan (the SimGNN-AIDS head, random weights) at the served
    shape on the select route, the same stages with the NTN phase in
    place of the dots and, inside it, thread 0's cycles in the slices'
    chains with the first FCN layer and in the later FCN layers; then each
    (queries a CTA, cluster) pair of `NTN_CANDIDATES` at the same shape,
    its CTA cycles and placement from the stage build, and its time from
    CUDA events around a CUDA graph of 20 launches of the package's build,
    with the clusters the card holds at once.

Each stage build's result is checked against the package kernel's bit for
bit. Writes `chiprun_out/topm_stages.json`.
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

from repro_torch.kernels import build, retrieval  # noqa: E402

SLOTS = 20          # TOPM_STAGE_SLOTS
#: (stage, slot) in the order a CTA runs them
SELECT = [("first copies issued", 12), ("queries, list init", 0),
          ("staging waits", 1), ("dots", 2),
          ("next copies issued, arrive", 11), ("bound reads", 8),
          ("selection", 3), ("final queue drain", 4),
          ("CTA merge, push to rank 0", 5), ("cluster barrier", 6),
          ("cluster merge (rank 0)", 7)]
NTN_SELECT = [("first copies issued", 12), ("query operands, list init", 0),
              ("staging waits", 1), ("NTN phase", 2),
              ("next copies issued, arrive", 11), ("bound reads", 8),
              ("selection", 3), ("final queue drain", 4),
              ("CTA merge, push to rank 0", 5), ("cluster barrier", 6),
              ("cluster merge (rank 0)", 7)]
#: thread 0's spans inside a phase or the selection: (name, cycles slot,
#: count slot)
SPANS = {"dot": [("drains (thread 0's warp)", 9, 10)],
         "ntn": [("drains (thread 0's warp)", 9, 10),
                 ("slices and FCN layer 1 (thread 0)", 16, 17),
                 ("FCN layers 2.. (thread 0)", 18, 19)]}
#: (queries a CTA, CTAs a cluster) of the NTN scan timed at the served
#: shape beside the plan's own
NTN_CANDIDATES = ((1, 2), (1, 4), (1, 8), (2, 2), (2, 4), (4, 8))
SORT = [("query load", 0), ("row loads (thread 0)", 1),
        ("dots (thread 0)", 2), ("key stores (thread 0)", 3),
        ("tile barrier", 4), ("bitonic sort", 5),
        ("list writes (thread 0)", 6)]


def stage_library(src: Path) -> ctypes.CDLL:
    out = build.BUILD_ROOT / "stages"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "topm_stages.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DTOPM_STAGES",
                    "-I", str(build.CSRC), "-o", str(so), str(src)],
                   check=True, stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(so))
    build.check_side_struct(lib, "topm_layout_size", retrieval.TopmLayout)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    build.bind(lib.topm_select_launch, [ptr, ptr] + [i32] * 4 + [ptr] * 2
               + [ctypes.POINTER(retrieval.TopmLayout), ptr])
    build.bind(lib.topm_dot_launch, [ptr, ptr] + [i32] * 5 + [ptr] * 5)
    build.bind(lib.topm_ntn_select_launch, [ptr] * 3 + [i32] * 5 + [ptr] * 2
               + [ctypes.POINTER(build.SimgnnParams),
                  ctypes.POINTER(retrieval.TopmLayout), ptr])
    build.bind(lib.topm_stage_buffers, [ptr, ptr])
    return lib


def run(lib, plan, q, m, launch):
    """One launch of `plan` through the stage build (`launch(s, i,
    stream)` calls the entry point) -> (scores, indices, [CTAs, SLOTS]
    stamps, [merge CTAs, 2] merge stamps or None)."""
    dev = torch.device("cuda")
    s = torch.empty((q, m), device=dev)
    i = torch.empty((q, m), dtype=torch.int32, device=dev)
    if plan.route == "select":
        ctas, merge_ctas = plan.grid[0], 0
    else:
        ctas = plan.grid[0] * plan.grid[1]
        per_q = plan.list_entries // q
        merge_ctas = q * -(-per_q // retrieval.SORT_THREADS)
    stamps = torch.zeros((ctas, SLOTS), dtype=torch.int64, device=dev)
    merge = torch.zeros((max(merge_ctas, 1), 2), dtype=torch.int64,
                        device=dev)
    build.check_launch(lib.topm_stage_buffers(stamps.data_ptr(),
                                              merge.data_ptr()), "stages")
    build.check_launch(launch(s, i, torch.cuda.current_stream().cuda_stream),
                       "topm stages")
    torch.cuda.synchronize()
    return s, i, stamps.cpu().numpy(), (merge.cpu().numpy() if merge_ctas
                                        else None)


def dot_launch(lib, plan, qv, corpus, m):
    (q, f), n = qv.shape, corpus.shape[0]

    def go(s, i, stream):
        if plan.route == "select":
            return lib.topm_select_launch(
                qv.data_ptr(), corpus.data_ptr(), q, n, f, m, s.data_ptr(),
                i.data_ptr(), ctypes.byref(retrieval._layout_struct(plan)),
                stream)
        ps = torch.empty(plan.list_entries, device=qv.device)
        pi = torch.empty(plan.list_entries, dtype=torch.int32,
                         device=qv.device)
        return lib.topm_dot_launch(
            qv.data_ptr(), corpus.data_ptr(), q, n, f, plan.chunk, m,
            ps.data_ptr(), pi.data_ptr(), s.data_ptr(), i.data_ptr(), stream)
    return go


def ntn_launch(lib, plan, uq, dq, corpus, params, m):
    (q, k), (n, f) = dq.shape, corpus.shape

    def go(s, i, stream):
        return lib.topm_ntn_select_launch(
            uq.data_ptr(), dq.data_ptr(), corpus.data_ptr(), q, n, f, k, m,
            s.data_ptr(), i.data_ptr(), ctypes.byref(params),
            ctypes.byref(retrieval._layout_struct(plan)), stream)
    return go


def report(label, lib, plan, q, m, launch, want, spans=()) -> dict:
    for _ in range(3):                        # warm: the last launch counts
        s, i, st, mg = run(lib, plan, q, m, launch)
    assert torch.equal(i, want[1]) and torch.equal(
        s.view(torch.int32), want[0].view(torch.int32)), \
        f"{label}: stage build differs"
    names = (SORT if plan.route == "sort" else
             SELECT if plan.scoring == "dot" else NTN_SELECT)
    out = {"case": label, "plan": plan.summary(), "ctas": int(len(st)),
           "stages": []}
    print(f"{label}: {plan.summary()}; SM cycles a CTA, median / largest "
          f"over {len(st)} CTAs")
    for name, k in names:
        d = st[:, k]
        out["stages"].append({"stage": name, "median": int(np.median(d)),
                              "max": int(d.max())})
        print(f"  {name:>34}: {int(np.median(d)):7d} / {int(d.max()):7d}")
    for name, k, c in spans:
        d, n = st[:, k], st[:, c]
        out[name] = {"median": int(np.median(d)), "max": int(d.max()),
                     "count_median": int(np.median(n))}
        print(f"  {name:>34}: {int(np.median(d)):7d} / {int(d.max()):7d} "
              f"({int(np.median(n))} spans)")
    tot = st[:, [k for _, k in names]].sum(axis=1)
    out["total"] = {"median": int(np.median(tot)), "max": int(tot.max())}
    sm = st[:, 14]
    out["placement"] = {
        "sms": int(len(set(sm.tolist()))),
        "ctas_an_sm_histogram": np.bincount(
            np.bincount(sm.astype(np.int64))).tolist(),
        "start_spread_ns": int(st[:, 15].max() - st[:, 15].min())}
    if plan.route == "select":
        rank0 = st[::plan.cluster, 7]
        out["rank0_cluster_merge"] = {"median": int(np.median(rank0)),
                                      "max": int(rank0.max())}
    print(f"  {'whole CTA':>34}: {out['total']['median']:7d} / "
          f"{out['total']['max']:7d}; {out['placement']}")
    if mg is not None:
        d = mg[:, 1] - mg[:, 0]
        out["merge_pass"] = {"ctas": int(len(d)), "median": int(np.median(d)),
                             "max": int(d.max())}
        print(f"  {'merge pass, a CTA':>34}: {int(np.median(d)):7d} / "
              f"{int(d.max()):7d} over {len(d)} CTAs")
    return out


def ntn_candidates(lib, limits, uq, dq, corpus, fcn, params, want) -> list:
    """Each (queries a CTA, cluster) of the NTN scan at the served shape:
    CTA cycles and placement (stage build), CUDA-graph ms (package
    build), clusters the card holds."""
    from topm_parent_check import graph_ms

    (q, k), (n, f) = dq.shape, corpus.shape
    dims = (k,) + tuple(int(p["w"].shape[1]) for p in fcn)
    own = retrieval.topm_ntn_plan(q, n, f, dims, 64, 256, *limits)
    rows = []
    for qb, cs in dict.fromkeys(NTN_CANDIDATES + ((own.queries,
                                                   own.cluster),)):
        plan = retrieval._ntn_select_plan(q, n, f, dims, 64, 256, *limits,
                                          qb=qb, cs=cs)
        r = report(f"NTN candidate: {qb} queries a CTA, clusters of {cs}",
                   lib, plan, q, 64, ntn_launch(lib, plan, uq, dq, corpus,
                                                params, 64), want,
                   SPANS["ntn"])
        s, i = (torch.empty_like(x) for x in want)
        ms = graph_ms(lambda: retrieval.launch_ntn(
            plan, uq.data_ptr(), dq.data_ptr(), corpus.data_ptr(), q, n, f, k,
            64, params, s, i))
        assert torch.equal(i, want[1]) and torch.equal(
            s.view(torch.int32), want[0].view(torch.int32)), (qb, cs)
        r.update(queries=qb, cluster=cs, graph_ms=ms, own=plan == own,
                 resident_clusters=retrieval.max_clusters(plan, f))
        print(f"  CUDA graph {ms:.5f} ms a launch; the card holds "
              f"{r['resident_clusters']} clusters at once"
              f"{' (the plan)' if r['own'] else ''}")
        rows.append(r)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("source", type=Path, nargs="?",
                    default=build.CSRC / "retrieval.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "tools"))
    from topm_parent_check import collapse, ntn_params

    lib = stage_library(args.source)
    limits = retrieval.device_limits(0)
    rng = np.random.default_rng(0)
    qv = torch.from_numpy(rng.standard_normal((64, 32)).astype(
        np.float32)).cuda()
    corpus = torch.from_numpy(rng.standard_normal((8192, 32)).astype(
        np.float32)).cuda()
    served = retrieval.topm_plan(64, 8192, 32, 64, 256, *limits)
    assert served.route == "select", served
    sort = retrieval.topm_plan(64, 8192, 32, 64, 256, *limits, route="sort")
    m_eq_n = retrieval.topm_plan(1, 8192, 32, 8192, 256, *limits)
    assert m_eq_n.route == "sort", m_eq_n
    want = retrieval.blocked_topm(qv, corpus, 64, block_cols=256)
    q1 = qv[:1].contiguous()
    cases = [report("served (64, 8192, 64, block 256), select route", lib,
                    served, 64, 64, dot_launch(lib, served, qv, corpus, 64),
                    want, SPANS["dot"]),
             report("served shape, sort route", lib, sort, 64, 64,
                    dot_launch(lib, sort, qv, corpus, 64), want),
             report("M = N (1, 8192, 8192, block 256), sort route", lib,
                    m_eq_n, 1, 8192, dot_launch(lib, m_eq_n, q1, corpus, 8192),
                    retrieval.blocked_topm(q1, corpus, 8192, block_cols=256))]
    ntn, fcn = ntn_params(32)
    uq, dq = collapse(ntn, qv)
    params, _keep = build.simgnn_params({"fcn": fcn}, qv.device)
    want = retrieval.blocked_topm_ntn(uq, dq, corpus, fcn, 64, block_cols=256)
    plan = retrieval.blocked_topm_ntn.last_plan
    assert plan.route == "select" and plan.scoring == "ntn_served", plan
    cases.append(report("NTN scan, served (64, 8192, 64, block 256), select "
                        "route", lib, plan, 64, 64,
                        ntn_launch(lib, plan, uq, dq, corpus, params, 64),
                        want, SPANS["ntn"]))
    candidates = ntn_candidates(lib, limits, uq, dq, corpus, fcn, params,
                                want)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "topm_stages.json").write_text(json.dumps(
        {"card": smi, "source": str(args.source), "cases": cases,
         "ntn_candidates": candidates}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
