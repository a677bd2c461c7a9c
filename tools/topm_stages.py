"""Where the dot scan's CTAs spend their time, stage by stage, on one NVIDIA
GPU.

    python3 tools/topm_stages.py [SOURCE.cu]

Builds `csrc/retrieval.cu` (or SOURCE.cu, a variant with the same C
interface and stage marks) with `TOPM_STAGES` defined: thread 0 of each CTA
then sums `clock64()` cycles by stage (the `TOPM_LAP` marks in the source),
and each CTA of the sort route's merge pass records its first and last
cycle. Runs three launches and prints each stage's SM cycles (median and
largest over the CTAs), the whole CTA's, and how the CTAs were placed on
SMs:

  * the served shape (Q, N, M, block_cols) = (64, 8192, 64, 256) on the
    select route: the copies issued, staging waits, dots, the reads of the
    bounds the cluster published, selection (and inside it thread 0's
    warp's queue drains, cycles and number), the final queue drain, the
    CTA's merge and push to rank 0, the cluster barrier and the cluster
    merge (rank 0);
    the stage build adds a barrier after each chunk's selection, so its
    cycles are not booked to the next chunk's wait;
  * the same shape forced onto the sort route (the replaced two-pass
    kernels, kept unchanged in the same source): the query load, thread
    0's row loads, dots and key stores, the tile's barrier, the bitonic
    sort, the list writes, then the merge pass;
  * the M = N shape (1, 8192, 8192, 256), which the plan sends to the sort
    route.

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

SLOTS = 16          # TOPM_STAGE_SLOTS
#: (stage, slot) in the order a CTA runs them
SELECT = [("first copies issued", 12), ("queries, list init", 0),
          ("staging waits", 1), ("dots", 2),
          ("next copies issued, arrive", 11), ("bound reads", 8),
          ("selection", 3), ("final queue drain", 4),
          ("CTA merge, push to rank 0", 5), ("cluster barrier", 6),
          ("cluster merge (rank 0)", 7)]
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
    build.bind(lib.topm_stage_buffers, [ptr, ptr])
    return lib


def run(lib, plan, qv, corpus, m):
    """One launch of `plan` through the stage build -> (scores, indices,
    [CTAs, SLOTS] stamps, [merge CTAs, 2] merge stamps or None)."""
    (q, f), n = qv.shape, corpus.shape[0]
    dev = qv.device
    s = torch.empty((q, m), device=dev)
    i = torch.empty((q, m), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
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
    if plan.route == "select":
        err = lib.topm_select_launch(
            qv.data_ptr(), corpus.data_ptr(), q, n, f, m, s.data_ptr(),
            i.data_ptr(), ctypes.byref(retrieval._layout_struct(plan)),
            stream)
    else:
        ps = torch.empty(plan.list_entries, device=dev)
        pi = torch.empty(plan.list_entries, dtype=torch.int32, device=dev)
        err = lib.topm_dot_launch(
            qv.data_ptr(), corpus.data_ptr(), q, n, f, plan.chunk, m,
            ps.data_ptr(), pi.data_ptr(), s.data_ptr(), i.data_ptr(), stream)
    build.check_launch(err, "topm stages")
    torch.cuda.synchronize()
    return s, i, stamps.cpu().numpy(), (merge.cpu().numpy() if merge_ctas
                                        else None)


def report(label, lib, plan, qv, corpus, m) -> dict:
    want = retrieval.blocked_topm(qv, corpus, m, block_cols=256)
    for _ in range(3):                        # warm: the last launch counts
        s, i, st, mg = run(lib, plan, qv, corpus, m)
    assert torch.equal(i, want[1]) and torch.equal(
        s.view(torch.int32), want[0].view(torch.int32)), \
        f"{label}: stage build differs"
    names = SELECT if plan.route == "select" else SORT
    out = {"case": label, "plan": plan.summary(), "ctas": int(len(st)),
           "stages": []}
    print(f"{label}: {plan.summary()}; SM cycles a CTA, median / largest "
          f"over {len(st)} CTAs")
    for name, k in names:
        d = st[:, k]
        out["stages"].append({"stage": name, "median": int(np.median(d)),
                              "max": int(d.max())})
        print(f"  {name:>30}: {int(np.median(d)):7d} / {int(d.max()):7d}")
    if plan.route == "select":
        for name, k in (("drain cycles (thread 0's warp)", 9),
                        ("drains (thread 0's warp)", 10)):
            d = st[:, k]
            out[name] = {"median": int(np.median(d)), "max": int(d.max())}
            print(f"  {name:>30}: {int(np.median(d)):7d} / {int(d.max()):7d}")
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
    print(f"  {'whole CTA':>30}: {out['total']['median']:7d} / "
          f"{out['total']['max']:7d}; {out['placement']}")
    if mg is not None:
        d = mg[:, 1] - mg[:, 0]
        out["merge_pass"] = {"ctas": int(len(d)), "median": int(np.median(d)),
                             "max": int(d.max())}
        print(f"  {'merge pass, a CTA':>30}: {int(np.median(d)):7d} / "
              f"{int(d.max()):7d} over {len(d)} CTAs")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("source", type=Path, nargs="?",
                    default=build.CSRC / "retrieval.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
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
    cases = [report("served (64, 8192, 64, block 256), select route", lib,
                    served, qv, corpus, 64),
             report("served shape, sort route (the replaced kernels)", lib,
                    sort, qv, corpus, 64),
             report("M = N (1, 8192, 8192, block 256), sort route", lib,
                    m_eq_n, qv[:1].contiguous(), corpus, 8192)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "topm_stages.json").write_text(json.dumps(
        {"card": smi, "source": str(args.source), "cases": cases}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
