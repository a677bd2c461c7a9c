"""Where a CTA of the packed-dense kernel's cluster route spends its time,
stage by stage, on one NVIDIA GPU.

    python3 tools/packed_pair_stages.py [SOURCE.cu]

Builds `csrc/packed_pair.cu` (or SOURCE.cu, a variant with the same C
interface and stage marks) with `PACKED_PAIR_STAGES` defined: thread 0 of
each cluster-route CTA then records `clock64()` as each barrier-separated
stage ends (the `PP_STAGE` marks in the source), with its SM. Runs the
launch plan of `kernels/packed_pair.py` on an AIDS request (the arrays
`simgnn_query_server` hands the kernel on `packed_dense`), its first tile
alone and an average-degree-8 request, and prints each stage's SM cycles
(median and largest over the CTAs of live tiles), the whole CTA's, and how
the CTAs were placed on SMs. The stage build checks its scores against the
package kernel's bit for bit. Writes `chiprun_out/packed_pair_stages.json`.
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
from repro_torch.kernels import packed_pair as pp  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "packed_pair_parent_check", ROOT / "tools" / "packed_pair_parent_check.py")
pc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pc)

SLOTS = 32          # PP_STAGES
HEAD = [("live slots, loads", 1), ("raw A', layer 0 gather", 2),
        ("ballots, degrees", 3), ("normalization", 4)]
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
    so = out / "packed_pair_stages.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DPACKED_PAIR_STAGES",
                    "-I", str(build.CSRC), "-o", str(so), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    launch = pc.launcher(build.bind(lib.packed_pair_score_launch, [
        ctypes.POINTER(pp.PackedSide), ctypes.POINTER(pp.PackedSide),
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.POINTER(build.SimgnnParams), ctypes.c_void_p,
        ctypes.POINTER(pp.PackedLayout)]), True)
    set_buf = build.bind(lib.packed_pair_stage_buffer, [ctypes.c_void_p])

    def run(arrays, *weights):
        stamps = torch.zeros((2 * arrays[0].shape[0], SLOTS),
                             dtype=torch.int64, device="cuda")
        build.check_launch(set_buf(stamps.data_ptr()), "stage buffer")
        y = launch(arrays, *weights)
        torch.cuda.synchronize()
        return y, stamps.cpu().numpy()
    return run


def report(label, arrays, weights, run) -> dict:
    want = pp.packed_pair_score(*arrays, *weights)
    assert pp.packed_pair_score.last_plan.route == "cluster", label
    for _ in range(3):                         # warm: the last launch counts
        got, st = run(arrays, *weights)
    assert pc.same_values(got, want), f"{label}: stage build differs"
    live = np.repeat(arrays[8].sum(-1).cpu().numpy() != 0, 2)
    rows = st[live].copy()
    # a CTA that scores no slot passes no NTN stage: zero cycles there
    rows[:, 27] = np.where(rows[:, 27] == 0, rows[:, 26], rows[:, 27])
    out = {"case": label, "tiles": int(arrays[0].shape[0]),
           "ctas_timed": int(len(rows)), "stages": []}
    print(f"{label}: {len(rows)} CTAs of live tiles; SM cycles median / "
          f"largest")
    prev = 0
    for name, slot in stages_of(len(weights[0])):
        d = rows[:, slot] - rows[:, prev]
        out["stages"].append({"stage": name, "median": int(np.median(d)),
                              "max": int(d.max())})
        print(f"  {name:>26}: {int(np.median(d)):7d} / {int(d.max()):7d}")
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
                    default=build.CSRC / "packed_pair.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    run = stage_launcher(args.source)
    w = pc.weights()
    aids = pc.aids_requests(1)[0]
    cases = [report("AIDS request", aids, w, run),
             report("its first tile alone", [x[:1].contiguous()
                                             for x in aids], w, run),
             report("average-degree-8 request", pc.dense_requests(1)[0], w,
                    run)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "packed_pair_stages.json").write_text(json.dumps(
        {"card": smi, "source": str(args.source), "cases": cases}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
