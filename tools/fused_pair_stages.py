"""Where a CTA of the bucketed pair kernel's cluster route spends its time,
stage by stage, on one NVIDIA GPU.

    python3 tools/fused_pair_stages.py [SOURCE.cu]

Builds `csrc/fused_pair.cu` (or SOURCE.cu, a variant with the same C
interface and stage marks) with `FUSED_PAIR_STAGES` defined: thread 0 of
each cluster-route CTA then records `clock64()` as each stage ends (the
`FP_STAGE` marks in the source), with its SM. Runs the launch plan of
`kernels/fused_pair.py` on bucket 64 of the forced 256-pair request (39
pairs), one pair at bucket 32 and the 130-node pair at bucket 256, and
prints each stage's SM cycles (median and largest over the CTAs that pass
the stage) and the whole CTA's. The stage build checks its scores against
the package kernel's bit for bit. Writes
`chiprun_out/fused_pair_stages.json`.
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
from repro_torch.kernels import fused_pair as fp  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "fused_pair_parent_check", ROOT / "tools" / "fused_pair_parent_check.py")
pc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pc)

SLOTS = 48          # FP_STAGES
TAIL = [("layers' last cluster wait", 36), ("pool gather (side rank 0)", 37),
        ("pooling (side rank 0)", 38), ("cluster barrier", 39),
        ("NTN slices (rank 0)", 41), ("FCN (rank 0)", 42)]


def stages_of(n_gcn: int) -> list:
    out = [("mask, raw A' rows, live scan", 1),
           ("degrees + cluster exchange", 2), ("A' and feats rows", 3)]
    for layer in range(n_gcn):
        out += [(f"H W, layer {layer}", 4 + 4 * layer),
                (f"cluster barrier, layer {layer}", 5 + 4 * layer),
                (f"HW window copy, layer {layer}", 6 + 4 * layer),
                (f"aggregation, layer {layer}", 7 + 4 * layer)]
    return out + TAIL


def stage_launcher(src: Path):
    """The stage build's launch as a function of (arrays, weights) ->
    (scores, [grid, SLOTS] int64 stamps)."""
    out = build.BUILD_ROOT / "stages"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "fused_pair_stages.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DFUSED_PAIR_STAGES",
                    "-I", str(build.CSRC), "-o", str(so), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    build.check_side_struct(lib, "fused_layout_size", fp.FusedLayout)
    launch = build.bind(lib.fused_pair_cluster_launch, [
        ctypes.POINTER(fp.FusedSide), ctypes.POINTER(fp.FusedSide),
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(build.SimgnnParams),
        ctypes.POINTER(fp.FusedLayout), ctypes.c_void_p])
    set_buf = build.bind(lib.fused_pair_stage_buffer, [ctypes.c_void_p])

    def run(arrays, gcn, att, ntn, fcn):
        b, n, _ = arrays[0].shape
        dev = arrays[0].device
        plan = fp.plan_for(b, n, arrays[1].shape[-1], gcn, att, ntn, fcn, dev)
        assert plan.route == "cluster", plan
        stamps = torch.zeros((plan.grid, SLOTS), dtype=torch.int64,
                             device=dev)
        build.check_launch(set_buf(stamps.data_ptr()), "stage buffer")
        sides = [fp.FusedSide(*(x.data_ptr() for x in arrays[s:s + 3]))
                 for s in (0, 3)]
        prm, _keep = build.simgnn_params(
            {"gcn": gcn, "att": {"w": att}, "ntn": ntn, "fcn": fcn}, dev)
        y = torch.empty((b,), device=dev)
        build.check_launch(launch(
            ctypes.byref(sides[0]), ctypes.byref(sides[1]), y.data_ptr(), b,
            ctypes.byref(prm), ctypes.byref(fp._layout_struct(plan)),
            torch.cuda.current_stream().cuda_stream), "fused_pair stages")
        torch.cuda.synchronize()
        return y, stamps.cpu().numpy(), plan
    return run


def report(label, arrays, weights, run) -> dict:
    want = fp.fused_pair_score(*arrays, *weights)
    for _ in range(3):                         # warm: the last launch counts
        got, st, plan = run(arrays, *weights)
    assert pc.same_values(got, want), f"{label}: stage build differs"
    out = {"case": label, "pairs": int(arrays[0].shape[0]),
           "plan": plan.summary(), "stages": []}
    print(f"{label}: {plan.summary()}; SM cycles median / largest")
    last = st[:, 0].copy()          # each CTA's previous mark
    for name, slot in stages_of(len(weights[0])):
        took = st[:, slot] != 0
        if not took.any():
            continue
        d = st[took, slot] - last[took]
        last[took] = st[took, slot]
        out["stages"].append({"stage": name, "median": int(np.median(d)),
                              "max": int(d.max()), "ctas": int(took.sum())})
        print(f"  {name:>32}: {int(np.median(d)):7d} / {int(d.max()):7d}"
              f" ({int(took.sum())} CTAs)")
    tot = st[:, 43] - st[:, 0]
    out["total"] = {"median": int(np.median(tot)), "max": int(tot.max())}
    out["start_spread_ns"] = int(st[:, 47].max() - st[:, 47].min())
    print(f"  {'whole CTA':>32}: {out['total']['median']:7d} / "
          f"{out['total']['max']:7d}; start spread "
          f"{out['start_spread_ns']} ns on {len(set(st[:, 46].tolist()))} "
          f"SMs")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("source", type=Path, nargs="?",
                    default=build.CSRC / "fused_pair.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    run = stage_launcher(args.source)
    w = pc.weights()
    forced = pc.forced_buckets(dev)
    big = pc.oversize(dev, (130,))
    cases = [report("bucket 64 (39 pairs)", forced[64], w, run),
             report("one pair at bucket 32", pc.take(forced[32], 1), w, run),
             report("130-node pair at bucket 256", big[256], w, run)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fused_pair_stages.json").write_text(json.dumps(
        {"card": smi, "source": str(args.source), "cases": cases}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
