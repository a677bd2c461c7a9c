"""Hold `csrc/simgnn_head.cu` against an earlier version of the same source,
bit for bit, and time the two side by side on one NVIDIA GPU.

    python3 tools/simgnn_head_parent_check.py PARENT.cu [--time] [--ablations]

PARENT.cu is a head kernel with the C entry point `simgnn_head_launch(h1,
h2, out, B, SimgnnParams*, stream)`, for example the one-warp-a-pair
kernel the tiled design replaced, extracted with `git show
<rev>:src/repro_torch/csrc/simgnn_head.cu`. It is built with the port's
nvcc flags beside the current library. Both run on the same inputs: B of
1, 2, 7, around each tile size (8, 16, 32), 255, 256, 1001, 4096, 8192,
8193 and the tile counts of a full grid and one past it; the SimGNN-AIDS
weights (F 32, K 16), the narrow config (F 4), an 8-layer FCN, K 40, 48
and 64, and bf16 weights; a NaN or an inf in one element of h1, h2, W, V,
b and an FCN weight, each its own case; zero and negative-zero rows;
embeddings large enough that t overflows; the exact query's layout (one
row expanded and made contiguous) and the rerank's (runs of 64 equal
rows); inputs one element past a 16-byte boundary. Position independence:
one pair scored alone, at every position of a 257-pair batch and inside
B 8192 gives the same bits. "Equal" is `torch.equal` on the int32 bit
patterns of the scores (so values, NaN places and signs of zeros). With
`--time`, B 8192, 4096, 2112, 1500, 1057, 1056, 768, 512, 384, 256 and 1
are timed parent, current, current, parent (CUDA events around one replay of a CUDA graph
of 20 launches: the kernels' device time; 20 wrapper calls back to back
measure the host's wrapper instead, and are reported beside it), and the
current kernel at each pairs-a-thread choice the plan could make (the
sizes from 256 to 2112 place the plan's switch from 8- to 32-pair tiles,
at B 1056 / 1057 on 132 SMs).
With `--ablations`, copies of the current source that each leave out one
part of the work (their scores differ; they time only what is left) are
built in parallel and timed against it at B 8192 and 1 with its plan:
`no_w_staging` (W and V never copied to shared memory), `no_products`
(the t = h1 W loop), `no_epilogue_loads` (the bilinear and linear leaves
and their reductions: t summed in registers), `no_fcn` (the score is the
sigmoid of out_0) and `half_w_loads` (slice k1 reuses slice k0's W
registers). Writes `chiprun_out/simgnn_head_parent.json`; exits 1 if any
case differs.
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
from repro_torch.core.simgnn import SimGNNConfig, init_simgnn_params  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.simgnn_head import (PAIRS_A_THREAD,  # noqa: E402
                                             HeadLayout, _layout_struct,
                                             _weight_image, launch, plan_for,
                                             simgnn_head, simgnn_head_plan)
from repro_torch.kernels.fused_gcn import device_limits  # noqa: E402

TIMED = (8192, 4096, 2112, 1500, 1057, 1056, 768, 512, 384, 256, 1)
ABLATED = (8192, 1)
#: name: [(text in csrc/simgnn_head.cu, replacement), ...]
ABLATIONS = {
    "no_w_staging": [("head_stage_flat(smem, image, L.w_floats);",
                      "head_stage_flat(smem + L.b_off, image + L.b_off, "
                      "L.w_floats - L.b_off);")],
    "no_products": [("for (int i4 = 0; i4 < HEAD_F / 4; ++i4)",
                     "for (int i4 = 0; i4 < 0; ++i4)")],
    "no_epilogue_loads": [(
        "      const float bil = head_quad_sum(head_tree8(bl));\n"
        "      const float lin = head_quad_sum(head_tree8(ln));",
        "      const float bil = head_tree8(acc[pp][kk]);\n"
        "      const float lin = 0.0f;")],
    "no_fcn": [("for (int layer = 0; layer < L.n_fcn; ++layer)",
                "for (int layer = 0; layer < 0; ++layer)")],
    "half_w_loads": [(
        "      const float4 b0 = head_ld4(w1 + i * HEAD_F);\n"
        "      const float4 b1 = head_ld4(w1 + i * HEAD_F + 4);",
        "      const float4 b0 = a1;\n      const float4 b1 = a0;")],
}


def parent_launcher(src: Path):
    """The earlier kernel's launch as a function of (h1, h2, ntn, fcn)."""
    out = build.BUILD_ROOT / "parent"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "simgnn_head_parent.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    fn = build.bind(lib.simgnn_head_launch, [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.POINTER(build.SimgnnParams),
        ctypes.c_void_p])

    def run(h1, h2, ntn, fcn):
        out = torch.empty(h1.shape[0], device=h1.device)
        params, _keep = build.simgnn_params({"ntn": ntn, "fcn": fcn},
                                            h1.device)
        build.check_launch(fn(h1.data_ptr(), h2.data_ptr(), out.data_ptr(),
                              h1.shape[0], ctypes.byref(params),
                              torch.cuda.current_stream().cuda_stream),
                           "parent simgnn_head")
        return out
    return run


def head_weights(dev, cfg=CONFIG, dtype="float32", seed=0):
    p = init_simgnn_params(torch.Generator().manual_seed(seed),
                           cfg._replace(dtype=dtype), device=dev)
    return p["ntn"], p["fcn"]


def weight_sets(dev) -> dict:
    """(ntn, fcn) by name: the served head, the narrow config, an 8-layer
    FCN, wide K (40: tiled at 32-pair tiles, 48: smaller tiles, 64: the
    warp route) and bf16 weights."""
    return {
        "aids": head_weights(dev),
        "narrow": head_weights(dev, SimGNNConfig(gcn_dims=(16, 8, 8, 4)),
                               seed=1),
        "fcn8": head_weights(dev, CONFIG._replace(
            fcn_dims=(48, 40, 32, 24, 16, 8, 4)), seed=2),
        "k40": head_weights(dev, CONFIG._replace(ntn_k=40), seed=3),
        "k48": head_weights(dev, CONFIG._replace(ntn_k=48), seed=4),
        "k64": head_weights(dev, CONFIG._replace(ntn_k=64), seed=5),
        "bf16": head_weights(dev, dtype="bfloat16", seed=6),
    }


def rows(dev, b, f, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    with np.errstate(over="ignore"):          # scale 3e38: some rows to inf
        return [torch.from_numpy((rng.standard_normal((b, f)) * scale)
                                 .astype(np.float32)).to(dev)
                for _ in range(2)]


def offset(x):
    """x's values in a tensor that starts one element past a 16-byte
    boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


def poisoned(ntn, fcn, where, value):
    """Copies of the weights with one element of `where` set to `value`."""
    ntn = {n: t.clone() for n, t in ntn.items()}
    fcn = [{n: t.clone() for n, t in p.items()} for p in fcn]
    target = {"W": ntn["w"][3, 5], "V": ntn["v"][7], "b": ntn["b"],
              "fcn w": fcn[0]["w"][2]}[where]
    target.view(-1)[1] = value
    return ntn, fcn


def cases(dev, sets):
    """(label, h1, h2, ntn, fcn) of every case held bit for bit."""
    sms, optin = device_limits(dev.index or 0)
    aids = sets["aids"]
    full = []
    for pt in PAIRS_A_THREAD:
        plan = simgnn_head_plan(8192, 32, 16, (16,) + CONFIG.fcn_dims + (1,),
                                sms, optin, pt=pt)
        full += [plan.tile * sms * plan.ctas_per_sm,
                 plan.tile * (sms * plan.ctas_per_sm + 1)]
    sizes = sorted({1, 2, 7, 8, 9, 15, 16, 17, 31, 32, 33, 255, 256, 1001,
                    4096, 8192, 8193, *full})
    for b in sizes:
        yield f"aids B {b}", *rows(dev, b, 32, b), *aids
    for name, (ntn, fcn) in sets.items():
        if name == "aids":
            continue
        f = ntn["w"].shape[-1]
        for b in (1, 33, 1001, 8193):
            yield f"{name} B {b}", *rows(dev, b, f, 100 + b), ntn, fcn
    for value in (float("nan"), float("inf")):
        tag = "NaN" if value != value else "inf"
        for side in (0, 1):
            h1, h2 = rows(dev, 300, 32, 7)
            (h1, h2)[side][17, 9] = value
            yield f"{tag} in h{side + 1}", h1, h2, *aids
        for where in ("W", "V", "b", "fcn w"):
            yield (f"{tag} in {where}", *rows(dev, 300, 32, 8),
                   *poisoned(*aids, where, value))
    h1, h2 = rows(dev, 300, 32, 9)
    h1[3] = 0.0
    h2[4] = 0.0
    h1[5] = -0.0
    h2[6] = -0.0
    h1[7], h2[7] = -0.0, -0.0
    h1[8, ::2] = -0.0
    yield "zero and negative-zero rows", h1, h2, *aids
    for scale in (1e19, 1e25, 3e38):
        yield f"embeddings x {scale:g} (t overflows)", *rows(
            dev, 300, 32, 10, scale), *aids
    hq, corpus = rows(dev, 8192, 32, 11)
    yield ("exact query layout (one row expanded, N 8192)",
           hq[0].expand(8192, 32).contiguous(), corpus, *aids)
    q, _ = rows(dev, 64, 32, 12)
    pick = np.sort(np.random.default_rng(13).integers(0, 8192, (64, 64)), 1)
    yield ("rerank layout (64 x 64, runs of 64 equal rows)",
           torch.repeat_interleave(q, 64, 0),
           corpus[torch.from_numpy(pick.reshape(-1)).to(dev)], *aids)
    for b in (33, 1001, 8192):
        h1, h2 = rows(dev, b, 32, 14 + b)
        yield f"h1 and h2 off 16-byte alignment, B {b}", offset(h1), \
            offset(h2), *aids
        yield f"h2 off 16-byte alignment, B {b}", h1, offset(h2), *aids


def same_bits(x, y) -> bool:
    return bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))


def positions(dev, aids, parent) -> dict:
    """One pair alone, at every position of a 257-pair batch and inside
    B 8192: every score the same bits, and the parent's."""
    a, b = rows(dev, 1, 32, 20)
    alone = simgnn_head(a, b, *aids)
    want = parent(a, b, *aids)
    ok = same_bits(alone, want)
    fill1, fill2 = rows(dev, 257, 32, 21)
    for pos in range(257):
        h1, h2 = fill1.clone(), fill2.clone()
        h1[pos], h2[pos] = a[0], b[0]
        ok &= same_bits(simgnn_head(h1, h2, *aids)[pos:pos + 1], alone)
    big1, big2 = rows(dev, 8192, 32, 22)
    for pos in (0, 31, 32, 4095, 8191):
        big1[pos], big2[pos] = a[0], b[0]
    got = simgnn_head(big1, big2, *aids)
    ok &= all(same_bits(got[p:p + 1], alone) for p in (0, 31, 32, 4095,
                                                        8191))
    return {"case": "position independence (alone, 257 positions, inside "
                    "B 8192)", "equal": bool(ok), "nan": 0}


def ms_batch(fn, iters=20):
    """ms a call from CUDA events around `iters` back-to-back calls: the
    wrapper's host work where it outlasts the kernel."""
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def ms_graph(fn, iters=20):
    """ms a launch from CUDA events around one replay of a CUDA graph of
    `iters` launches: the device time, without the host's gaps."""
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


def timing(dev, aids, parent) -> list:
    out = []
    sms, optin = device_limits(dev.index or 0)
    for b in TIMED:
        hq, corpus = rows(dev, b, 32, 30)
        h1 = hq[0].expand(b, 32).contiguous()
        res = torch.empty(b, device=dev)
        old = lambda: parent(h1, corpus, *aids)                   # noqa: E731
        new = lambda: simgnn_head(h1, corpus, *aids)              # noqa: E731
        t = [ms_graph(old), ms_graph(new), ms_graph(new), ms_graph(old)]
        call = [ms_batch(old), ms_batch(new), ms_batch(new), ms_batch(old)]
        plan = plan_for(b, 32, *aids, dev)
        variants = {}
        for pt in PAIRS_A_THREAD:
            vp = simgnn_head_plan(b, 32, 16, (16,) + CONFIG.fcn_dims + (1,),
                                  sms, optin, pt=pt)
            variants[pt] = ms_graph(lambda: launch(                 # noqa: B023
                vp, h1.data_ptr(), corpus.data_ptr(), res, *aids))
        out.append({"B": b, "parent_ms": [t[0], t[3]],
                    "current_ms": [t[1], t[2]],
                    "parent_call_ms": [call[0], call[3]],
                    "current_call_ms": [call[1], call[2]],
                    "plan": plan.summary(), "pt_ms": variants})
        print(f"time B {b}: parent {t[0]:.5f} / {t[3]:.5f} ms, current "
              f"{t[1]:.5f} / {t[2]:.5f} ms ({plan.summary()}); by pairs a "
              "thread: " + ", ".join(f"{pt} {ms:.5f}"
                                     for pt, ms in variants.items())
              + f"; wrapper calls back to back: parent {call[0]:.5f} / "
              f"{call[3]:.5f}, current {call[1]:.5f} / {call[2]:.5f} ms")
    return out


def ablation_launchers() -> dict:
    """{name: bound `simgnn_head_tiled_launch`} of every ablation, built in
    parallel with the port's nvcc flags (registers and spills printed)."""
    work = build.BUILD_ROOT / "head_ablations"
    work.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "simgnn_head.cu").read_text()
    procs = {}
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"ablation {name}: the edit no longer "
                                 "applies")
            text = text.replace(old, new)
        (work / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(work / f"{name}.so"), str(work / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"ablation {name}: nvcc failed\n{log[-3000:]}")
        print(f"ablation {name}: " + " | ".join(
            ln.split("info    : ")[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "spill stores" in ln))
        out[name] = build.bind(
            ctypes.CDLL(str(work / f"{name}.so")).simgnn_head_tiled_launch,
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p,
                                     ctypes.POINTER(HeadLayout)]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return out


def ablation_timing(dev, aids) -> list:
    """Device ms of the current kernel and of each ablation, twice each,
    on the exact query's layout with the current plan."""
    libs = ablation_launchers()
    image = _weight_image(*aids, dev)
    out = []
    for b in ABLATED:
        hq, corpus = rows(dev, b, 32, 40)
        h1 = hq[0].expand(b, 32).contiguous()
        plan = plan_for(b, 32, *aids, dev)
        layout = _layout_struct(plan)
        res = torch.empty(b, device=dev)
        runs = {"current": lambda: launch(plan, h1.data_ptr(),  # noqa: B023
                                          corpus.data_ptr(), res, *aids)}
        for name, fn in libs.items():
            runs[name] = lambda fn=fn: build.check_launch(fn(  # noqa: B023
                h1.data_ptr(), corpus.data_ptr(), res.data_ptr(), b,
                image.data_ptr(), ctypes.byref(layout), plan.pt, plan.grid,
                plan.threads, plan.smem_bytes,
                torch.cuda.current_stream().cuda_stream), "ablation")
        ms = {name: [ms_graph(fn), ms_graph(fn)] for name, fn in runs.items()}
        out.append({"B": b, "plan": plan.summary(), "ms": ms})
        print(f"ablations B {b} ({plan.summary()}): " + "; ".join(
            f"{n} {t[0]:.5f} / {t[1]:.5f} ms" for n, t in ms.items()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path)
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--ablations", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    parent = parent_launcher(args.parent)
    sets = weight_sets(dev)
    results, bad = [], 0
    for label, h1, h2, ntn, fcn in cases(dev, sets):
        got = simgnn_head(h1, h2, ntn, fcn)
        want = parent(h1, h2, ntn, fcn)
        torch.cuda.synchronize()
        eq = same_bits(got, want)
        bad += not eq
        nan = int(torch.isnan(got).sum())
        plan = simgnn_head.last_plan
        results.append({"case": label, "B": h1.shape[0], "equal": eq,
                        "nan": nan, "route": plan.route,
                        "plan": plan.summary()})
        print(f"{'equal' if eq else 'DIFFERS'}: {label} ({nan} NaN; "
              f"{plan.summary()})")
    pos = positions(dev, sets["aids"], parent)
    bad += not pos["equal"]
    results.append(pos)
    print(f"{'equal' if pos['equal'] else 'DIFFERS'}: {pos['case']}")
    timed = timing(dev, sets["aids"], parent) if args.time else []
    ablated = ablation_timing(dev, sets["aids"]) if args.ablations else []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "simgnn_head_parent.json").write_text(json.dumps(
        {"card": smi, "cases": results, "timing": timed,
         "ablations": ablated}, indent=1))
    print(f"card: {smi}; {len(results) - bad} of {len(results)} cases equal")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
