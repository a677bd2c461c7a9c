"""Where a CTA of the packed-sparse kernel spends its time, stage by stage,
on one NVIDIA GPU.

    python3 tools/sparse_pair_stages.py [SOURCE.cu]

Builds `csrc/sparse_pair.cu` (or SOURCE.cu, a variant with the same C
interface and stage marks) with `SPARSE_PAIR_STAGES` defined: thread 0 of
each CTA then records `clock64()` as each barrier-separated stage ends
(the `SP_STAGE` marks in the source), with its SM. Runs the launch plan of
`kernels/sparse_pair.py` on the served 256-pair request (arrays captured
from `simgnn_query_server(use_kernels=True)`), its first tile alone and
the D = 2 spill case, and prints each stage's SM cycles (median and
largest over the CTAs of live tiles), the whole CTA's, and how the CTAs
were placed on SMs. The stage build checks its scores against the
package kernel's bit for bit. Writes `chiprun_out/sparse_pair_stages.json`.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import sparse_pair as sp  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "sparse_pair_parent_check", ROOT / "tools" / "sparse_pair_parent_check.py")
pc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pc)

SLOTS = 32          # SP_STAGES
#: (name, slot) in the order a CTA passes them; slot 3 is warp 0's (the
#: overflow bucketing), the others end with a barrier of the whole CTA.
HEAD = [("live slots", 1), ("staging", 2), ("bucketing (warp 0)", 3),
        ("layer 0 gather", 4)]
TAIL = [("pool mean", 21), ("pool context", 22), ("pool Att", 23),
        ("pool sums", 24), ("cluster barrier", 25), ("peer copy", 26),
        ("NTN slices", 27), ("FCN", 28), ("cluster wait", 29)]


def stages_of(n_gcn: int) -> list:
    out = list(HEAD)
    out.append(("aggregation, layer 0", 6))
    for layer in range(1, n_gcn):
        out += [(f"H W, layer {layer}", 5 + 2 * layer),
                (f"aggregation, layer {layer}", 6 + 2 * layer)]
    return out + TAIL


def stage_launcher(src: Path):
    """The stage build's launch as a function of (arrays, weights) ->
    (scores, [2T, SLOTS] int64 stamps)."""
    out = build.BUILD_ROOT / "stages"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "sparse_pair_stages.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DSPARSE_PAIR_STAGES",
                    "-I", str(build.CSRC), "-o", str(so), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    launch = pc.launcher(build.bind(lib.sparse_pair_score_launch, [
        ctypes.POINTER(sp.SparseSide), ctypes.POINTER(sp.SparseSide),
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.POINTER(build.SimgnnParams), ctypes.c_void_p,
        ctypes.POINTER(sp.SparseLayout)]), True)
    set_buf = build.bind(lib.sparse_pair_stage_buffer, [ctypes.c_void_p])

    def run(arrays, *weights):
        stamps = torch.zeros((2 * arrays[0].shape[0], SLOTS),
                             dtype=torch.int64, device="cuda")
        build.check_launch(set_buf(stamps.data_ptr()), "stage buffer")
        y = launch(arrays, *weights)
        torch.cuda.synchronize()
        return y, stamps.cpu().numpy()
    return run


def report(label, arrays, weights, run) -> dict:
    want = sp.sparse_pair_score(*arrays, *weights)
    for _ in range(3):                         # warm: the last launch counts
        got, st = run(arrays, *weights)
    assert pc.same_values(got, want), f"{label}: stage build differs"
    live = np.repeat(arrays[16].sum(-1).cpu().numpy() != 0, 2)
    rows = st[live]
    names = stages_of(len(weights[0]))
    out = {"case": label, "tiles": int(arrays[0].shape[0]),
           "ctas_timed": int(len(rows)), "stages": []}
    print(f"{label}: {len(rows)} CTAs of live tiles; SM cycles median / "
          f"largest")
    prev = 0
    for name, slot in names:
        ref = 2 if slot == 3 else prev       # warp 0's stage starts at 2
        d = rows[:, slot] - rows[:, ref]
        out["stages"].append({"stage": name, "median": int(np.median(d)),
                              "max": int(d.max())})
        print(f"  {name:>26}: {int(np.median(d)):7d} / {int(d.max()):7d}")
        if slot != 3:
            prev = slot
    tot = rows[:, 29] - rows[:, 0]
    out["total"] = {"median": int(np.median(tot)), "max": int(tot.max())}
    sm = st[:, 30]
    per_sm = np.bincount(np.bincount(sm.astype(np.int64)))
    out["placement"] = {
        "sms": int(len(set(sm.tolist()))),
        "ctas_an_sm_histogram": per_sm.tolist(),
        "clusters_on_one_sm": int((sm[0::2] == sm[1::2]).sum()),
        "start_spread_ns": int(st[:, 31].max() - st[:, 31].min())}
    print(f"  {'whole CTA':>26}: {out['total']['median']:7d} / "
          f"{out['total']['max']:7d}; {out['placement']}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("source", type=Path, nargs="?",
                    default=build.CSRC / "sparse_pair.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    run = stage_launcher(args.source)
    w = pc.weights()
    served = pc.served_requests(1)[0]
    spill = pc.packed(pc.query_pairs(1, pc.BATCH), torch.device("cuda"),
                      edge_budget=128)
    cases = [report("served request", served, w, run),
             report("its first tile alone", [x[:1].contiguous()
                                             for x in served], w, run),
             report("D 2 spill", spill, w, run)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "sparse_pair_stages.json").write_text(json.dumps(
        {"card": smi, "source": str(args.source), "cases": cases}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
