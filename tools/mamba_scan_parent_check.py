"""Hold `csrc/mamba_scan.cu` against an earlier version of the same source,
bit for bit, and time the two side by side on one NVIDIA GPU.

    python3 tools/mamba_scan_parent_check.py PARENT.cu [--time]

PARENT.cu is a scan kernel with the same C interface
(`mamba_scan_launch(dtype, dt, x, b, c, a, d, h0, y, hT, B, T, Din, N,
stream)`), for example the synchronous-staging kernel this design
replaced, extracted with `git show <rev>:src/repro_torch/csrc/
mamba_scan.cu`. It is built with the port's nvcc flags beside the current
library. Both run on the same inputs: Jamba's Mamba block (B 2, Din 16384,
N 16) at T 2048 and T 1 in float32 and bfloat16, from a zero and from a
given state; the card tests' shapes (time blocks of 32 crossed, Din not a
multiple of the CTA's channels, bf16 rows that are not whole 16-byte
chunks, N 16, 8, 5, 12, 20 and 32, B 1); inputs that are not 16-byte
aligned; inf and NaN in dt, x and h0, and negative zeros in h0. "Equal" is
`torch.equal` on the int32 bit patterns of y and hT (so values, NaN
places, NaN payloads and the signs of zeros). With `--time`, the served
prefill (float32 and bf16) and the decode step (float32, given state) are
timed parent, current, current, parent (CUDA events around 10
back-to-back launches; the decode step around a CUDA graph of 50). Writes
`chiprun_out/mamba_scan_parent.json`; exits 1 if any case differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_scan_plan, mamba_selective_scan_state)

SERVED = (2, 2048, 16384, 16)
CASES = {  # (B, T, Din, N): the card tests' shapes
    "odd": (2, 45, 200, 16),
    "small_n": (1, 33, 70, 5),
    "widest_n": (3, 20, 130, 32),
    "tb_less_1": (2, 31, 256, 16),
    "tb": (2, 32, 256, 16),
    "tb_plus_1": (2, 33, 256, 16),
    "two_tb_plus_1": (2, 65, 256, 16),
    "din_not_ch": (2, 40, 8200, 16),
    "din70_plain_rows": (2, 40, 70, 16),
    "n8": (2, 50, 192, 8),
    "n5_async_rows": (2, 40, 256, 5),
    "n12": (2, 33, 96, 12),
    "n20": (1, 35, 64, 20),
    "b1": (1, 40, 192, 16),
    "served_decode": (2, 1, 16384, 16),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def parent_launcher(src: Path):
    """The earlier kernel's launch as a function of the scan's tensors."""
    out = build.BUILD_ROOT / "parent"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "mamba_scan_parent.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    launch = build.bind(lib.mamba_scan_launch, [ctypes.c_int]
                        + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                        + [ctypes.c_void_p])

    def run(dt, x, b, c, a, d, h0=None):
        bsz, t, din = x.shape
        n = a.shape[-1]
        y = torch.empty((bsz, t, din), device=x.device)
        h_t = torch.empty((bsz, din, n), device=x.device)
        build.check_launch(launch(
            0 if x.dtype == torch.float32 else 1, dt.data_ptr(),
            x.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(),
            d.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_t.data_ptr(), bsz, t, din, n,
            torch.cuda.current_stream().cuda_stream), "parent mamba_scan")
        return y, h_t
    return run


def inputs(dev, bsz, t, din, n, dtype, seed=0):
    """dt, x, b, c, a, d, h0 as the card tests make them."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=g) * scale
    dt = torch.nn.functional.softplus(randn((bsz, t, din))) * 0.1
    x = randn((bsz, t, din))
    b, c = (randn((bsz, t, n), 0.5) for _ in range(2))
    a = -torch.exp(randn((din, n), 0.3))
    d = randn((din,))
    h0 = randn((bsz, din, n), 0.5)
    return [dt.to(dtype), x.to(dtype), b, c, a, d, h0]


def same_bits(x, y) -> bool:
    return bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))


def offset(x):
    """x's values in a tensor that starts one element past a 16-byte
    boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


def cases(dev):
    """(label, dt, x, b, c, a, d, h0 or None) of every case held bit for
    bit."""
    shapes = [("served prefill", SERVED)] + sorted(CASES.items())
    for name, shape in shapes:
        for tag, dtype in DTYPES.items():
            dt, x, b, c, a, d, h0 = inputs(dev, *shape, dtype)
            for init in ("zero", "given"):
                yield (f"{name} {shape} {tag}, {init} state", dt, x, b, c, a,
                       d, h0 if init == "given" else None)
            del dt, x, b, c, a, d, h0
    for shape in ((2, 70, 256, 16), (2, 1, 16384, 16), (2, 40, 70, 8)):
        for tag, dtype in DTYPES.items():
            arrays = [offset(z) for z in inputs(dev, *shape, dtype, seed=1)]
            yield (f"off 16-byte alignment {shape} {tag}, given state",
                   *arrays)
            yield (f"off 16-byte alignment {shape} {tag}, zero state",
                   *arrays[:-1], None)
    for tag, dtype in DTYPES.items():
        dt, x, b, c, a, d, h0 = inputs(dev, 2, 70, 256, 16, dtype, seed=2)
        dt[0, 3, 5] = float("nan")
        dt[1, 40, 7] = float("inf")
        dt[0, 33, 200] = float("inf")
        x[1, 10, 9] = float("nan")
        x[0, 64, 100] = -float("inf")
        h0[0, 2, 3] = float("nan")
        h0[1, 5, 0] = float("inf")
        h0[1, 6, 15] = -float("inf")
        h0[0, 100] = -0.0
        x[:, :, 101] = -0.0
        yield f"inf, NaN and -0 in dt, x and h0 {tag}", dt, x, b, c, a, d, h0
        yield f"inf and NaN in dt and x {tag}, zero state", dt, x, b, c, a, \
            d, None
        for n in (5, 32):
            dt, x, b, c, a, d, h0 = inputs(dev, 1, 40, 96, n, dtype, seed=3)
            dt[0, 7, 11] = float("nan")
            h0[0, 20, n - 1] = float("inf")
            h0[0, 21] = -0.0
            yield f"inf, NaN and -0 at N {n} {tag}", dt, x, b, c, a, d, h0


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
    for label, *arrays in cases(dev):
        got = mamba_selective_scan_state(*arrays)
        want = parent(*arrays)
        torch.cuda.synchronize()
        eq = [same_bits(g, w) for g, w in zip(got, want)]
        bad += not all(eq)
        nan = int(torch.isnan(got[0]).sum() + torch.isnan(got[1]).sum())
        dt, n = arrays[0], arrays[4].shape[-1]
        plan = mamba_scan_plan(*dt.shape, n, dt.dtype)
        results.append({"case": label, "shape": [*dt.shape, n],
                        "equal": all(eq), "y_equal": eq[0],
                        "state_equal": eq[1], "nan": nan, "plan": plan})
        print(f"{'equal' if all(eq) else 'DIFFERS'}: {label} ({nan} NaN; "
              f"y {eq[0]}, state {eq[1]}; CH {plan['ch']}, {plan['route']}"
              f" dt/x, {plan['bc_route']} B/C, {plan['state_rows']} state "
              f"rows)")
        del got, want, arrays
    timing = []
    if args.time:
        def ms_batch(fn, iters=10):
            fn()
            torch.cuda.synchronize()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            for _ in range(iters):
                fn()
            e.record()
            e.synchronize()
            return s.elapsed_time(e) / iters

        def ms_graph(fn, iters=50):
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
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            graph.replay()
            e.record()
            e.synchronize()
            return s.elapsed_time(e) / iters

        runs = [("served prefill f32, zero state", SERVED, torch.float32,
                 False, ms_batch),
                ("served prefill bf16, zero state", SERVED, torch.bfloat16,
                 False, ms_batch),
                ("decode step T 1 f32, given state (CUDA graph)",
                 (2, 1, 16384, 16), torch.float32, True, ms_graph)]
        for label, shape, dtype, given, clock in runs:
            arrays = inputs(dev, *shape, dtype)
            if not given:
                arrays[-1] = None
            old = lambda: parent(*arrays)                          # noqa: E731
            new = lambda: mamba_selective_scan_state(*arrays)      # noqa: E731
            t = [clock(old), clock(new), clock(new), clock(old)]
            timing.append({"case": label, "shape": list(shape),
                           "parent_ms": [t[0], t[3]],
                           "current_ms": [t[1], t[2]]})
            print(f"time {label}: parent {t[0]:.5f} / {t[3]:.5f} ms, "
                  f"current {t[1]:.5f} / {t[2]:.5f} ms")
            del arrays
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mamba_scan_parent.json").write_text(json.dumps(
        {"card": smi, "cases": results, "timing": timing}, indent=1))
    print(f"card: {smi}; {len(results) - bad} of {len(results)} cases equal")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
