"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc/`, holds each
against its plain PyTorch version on the card at the serving path's
shapes, serves 2048 AIDS-like pairs through
`simgnn_query_server(use_kernels=True)` in batches of 256 (the packed-sparse
path), forces the packed-dense and bucketed paths on one batch each, and
checks the scores against the port's reference path on the card and its
plain path on the CPU. Every failed check exits non-zero.

Output: per-kernel lines, the served requests' split into host stages and
device span, a `{"kernels": [...]}` JSON line, the card's name and power
limit, and as the last line `{"ok": true, "device": {...}}`. Kernel `ms`
is the kernel's device time from `torch.profiler` (mean of warm launches);
the wrapper call and the plain version are timed with CUDA events (warm,
median); bounds come from this run's inputs against the H100 SXM peaks of
67 TFLOP/s float32 and 3.35 TB/s. Details go to
`chiprun_out/chip_smoke.json`. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_F32_FLOPS = 67e12       # H100 SXM float32, outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
BATCH = 256
N_PAIRS = 2048
#: kernel-vs-plain tolerance on post-sigmoid scores, by kernel: the
#: parity bounds of tests/test_parity_matrix.py (f32).
ATOL = {"sparse_pair": 1e-6, "packed_pair": 1e-6, "fused_pair": 2e-5}
REPLACES = {
    "sparse_pair": "src/repro/kernels/sparse_pair.py:94",
    "packed_pair": "src/repro/kernels/packed_pair.py:73",
    "fused_pair": "src/repro/kernels/fused_pair.py:67",
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.simgnn_aids import CONFIG as CFG
    from repro_torch.core import batching
    from repro_torch.core.simgnn import SimGNNConfig, init_simgnn_params
    from repro_torch.data.graphs import edit_graph, query_pairs, random_graph
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.fused_pair import (fused_pair_score,
                                                fused_pair_score_plain)
    from repro_torch.kernels.packed_pair import (packed_pair_score,
                                                 packed_pair_score_plain)
    from repro_torch.kernels.sparse_pair import (sparse_pair_score,
                                                 sparse_pair_score_plain)
    from repro_torch.serve.batching import simgnn_query_server

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    report: dict = {"card": smi, "torch": torch.__version__,
                    "cuda": torch.version.cuda}

    # ---- phase 2: build ------------------------------------------------
    t0 = time.perf_counter()
    out_dir = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s wall, nvcc "
          f"{build.last_build_seconds:.1f}s, into {out_dir}")
    for name in build.SOURCES:
        log = (out_dir / f"{name}.log").read_text()
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"ptxas {name}: {' | '.join(regs)}")

    gen = torch.Generator().manual_seed(0)
    params = init_simgnn_params(gen, CFG, device=dev)
    narrow_cfg = SimGNNConfig(gcn_dims=(16, 8, 8, 4))
    narrow = init_simgnn_params(torch.Generator().manual_seed(1), narrow_cfg,
                                device=dev)

    def wargs(p):
        return p["gcn"], p["att"]["w"], p["ntn"], p["fcn"]

    # ---- phase 3: every kernel against its plain version ---------------
    pairs = query_pairs(1, BATCH)
    nb = ops.packed_node_budget(CFG.max_nodes)
    slots = max(8, nb // 4)
    deg = float(np.mean([g["avg_degree"] for pr in pairs for g in pr]))

    def packed_arrays(edge_budget):
        packed, _ = batching.pack_pairs(
            pairs, nb, slots_per_tile=slots, with_edges=True,
            edge_budget=edge_budget, device=dev)
        e1, e2 = packed.edges.edges1, packed.edges.edges2
        o1, o2 = packed.edges.overflow1, packed.edges.overflow2
        # The arrays the ops wrappers hand the kernels: unpadded [T, ...].
        sparse = [x.contiguous() for x in (
            e1.senders, e1.weights, o1.senders, o1.receivers, o1.weights,
            packed.labels1, packed.mask1, packed.seg1,
            e2.senders, e2.weights, o2.senders, o2.receivers, o2.weights,
            packed.labels2, packed.mask2, packed.seg2, packed.pair_mask)]
        dense = [x.contiguous() for x in (
            packed.adj1, packed.labels1, packed.mask1, packed.seg1,
            packed.adj2, packed.labels2, packed.mask2, packed.seg2,
            packed.pair_mask)]
        return sparse, dense, packed

    sparse_in, dense_in, packed = packed_arrays(
        ops.packed_edge_budget(nb, deg))
    spill_in, _, spill_packed = packed_arrays(2 * nb)      # D=2: COO spill
    n_spill = int(spill_packed.edges.overflow1.edge_mask.sum()
                  + spill_packed.edges.overflow2.edge_mask.sum())
    assert n_spill > 0, "overflow case has no COO edges"
    buckets = batching.bucket_pairs(pairs, CFG.n_node_labels,
                                    allow_oversize=True, device=dev)
    rng = np.random.default_rng(7)
    big = random_graph(rng, 130)
    oversize = batching.bucket_pairs([(big, edit_graph(rng, big, 3))],
                                     CFG.n_node_labels, allow_oversize=True,
                                     device=dev)
    assert list(oversize) == [256], list(oversize)

    def fused_in(b):
        lhs, rhs, _ = b
        return [lhs.adj, lhs.feats, lhs.mask, rhs.adj, rhs.feats, rhs.mask]

    cases = {
        "sparse_pair": [
            ("main", sparse_pair_score, sparse_pair_score_plain, sparse_in,
             params),
            (f"overflow ({n_spill} COO edges)", sparse_pair_score,
             sparse_pair_score_plain, spill_in, params),
            ("narrow gcn (16,8,8,4)", sparse_pair_score,
             sparse_pair_score_plain, sparse_in, narrow)],
        "packed_pair": [
            ("main", packed_pair_score, packed_pair_score_plain, dense_in,
             params),
            ("narrow gcn (16,8,8,4)", packed_pair_score,
             packed_pair_score_plain, dense_in, narrow)],
        "fused_pair": [
            ("bucket 32", fused_pair_score, fused_pair_score_plain,
             fused_in(buckets[32]), params),
            ("bucket 64", fused_pair_score, fused_pair_score_plain,
             fused_in(buckets[64]), params),
            ("oversize 130 nodes (bucket 256)", fused_pair_score,
             fused_pair_score_plain, fused_in(oversize[256]), params),
            ("narrow gcn (16,8,8,4)", fused_pair_score,
             fused_pair_score_plain, fused_in(buckets[32]), narrow)],
    }
    kernels = {}
    for name, runs in cases.items():
        worst = 0.0
        for label, kern, plain, arrays, prm in runs:
            got = kern(*arrays, *wargs(prm))
            want = plain(*arrays, *wargs(prm))
            torch.cuda.synchronize()
            assert got.shape == want.shape, (name, label, got.shape)
            assert torch.isfinite(got).all(), (name, label)
            err = float((got - want).abs().max())
            print(f"  {name} [{label}]: shape {tuple(got.shape)} max abs err "
                  f"{err:.3e} (bound {ATOL[name]:g})")
            assert err <= ATOL[name], (name, label, err)
            worst = max(worst, err)
        label, kern, plain, arrays, prm = runs[0] if name != "fused_pair" \
            else runs[1]
        call_ms = time_cuda(lambda: kern(*arrays, *wargs(prm)))
        plain_ms = time_cuda(lambda: plain(*arrays, *wargs(prm)))
        ms, ms_source = kernel_device_ms(lambda: kern(*arrays, *wargs(prm)),
                                         f"{name}_kernel"), "profiler"
        if ms is None:              # the profiler saw no device time
            ms, ms_source = call_ms, "events around the wrapper call"
        flops, nbytes = WORK[name](arrays, CFG)
        nbytes += param_bytes(params) + out_bytes(name, arrays)
        t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        kernels[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "ms_source": ms_source, "call_ms": call_ms,
            "timed_case": label, "flops": flops, "bytes": nbytes}
        k = kernels[name]
        print(f"{name}: max abs err {worst:.3e} (bound {ATOL[name]:g}); "
              f"kernel {ms:.4f} ms ({ms_source}), wrapper call "
              f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms on [{label}]; "
              f"bound {k['bound_ms'] * 1e3:.3f} us set by {k['bound_by']} "
              f"({flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.4f} MB)")

    # ---- phase 4: serve 2048 pairs through the packed-sparse path -------
    # Every path below is driven with all launch counts set to 0 just
    # before it and read just after; the comparisons above do not count.
    launched = {"sparse_pair": sparse_pair_score,
                "packed_pair": packed_pair_score,
                "fused_pair": fused_pair_score}

    def reset_counts():
        for kern in launched.values():
            kern.launches = 0

    def read_counts():
        return {name: kern.launches for name, kern in launched.items()}

    stream = query_pairs(1, N_PAIRS)
    score = simgnn_query_server(params, CFG, use_kernels=True)
    cpu_score = simgnn_query_server(params, CFG, use_kernels=True,
                                    device="cpu")
    ref_score = simgnn_query_server(params, CFG, path="reference")
    timer = RequestTimer(score.engine)
    walls, first = [], None
    reset_counts()
    for i in range(0, N_PAIRS, BATCH):
        batch = stream[i:i + BATCH]
        before = sparse_pair_score.launches
        t0 = time.perf_counter()
        with timer:
            out = score(batch)
        walls.append(time.perf_counter() - t0)
        timer.stages[-1]["wall"] = walls[-1]
        plan = score.last_plan
        assert plan.path == "packed_sparse", plan.path
        assert plan.degraded_from == () and plan.attempts == 1, plan
        assert sparse_pair_score.launches > before
        assert out.shape == (len(batch),) and np.isfinite(out).all()
        if first is None:
            first = (batch, out)
    counts = read_counts()
    print(f"serve launches: {counts}")
    assert counts["sparse_pair"] == N_PAIRS // BATCH, counts
    served = {"sparse_pair": counts["sparse_pair"]}
    requests = N_PAIRS // BATCH
    batch, out = first
    err_ref = float(np.abs(out - ref_score(batch)).max())
    err_cpu = float(np.abs(out - cpu_score(batch)).max())
    print(f"serve: {requests} requests of {BATCH} pairs on "
          f"{score.last_plan.path}; vs card reference {err_ref:.3e}, vs CPU "
          f"plain path {err_cpu:.3e} (bound 1e-06)")
    assert err_ref <= 1e-6 and err_cpu <= 1e-6, (err_ref, err_cpu)
    steady = timer.stages[1:]
    mean = {k: statistics.fmean(s[k] for s in steady) for k in steady[0]}
    print(f"serve: {BATCH / mean['wall']:.1f} pairs/s over requests "
          f"2..{requests}; per request {1e3 * mean['wall']:.3f} ms wall, "
          f"{1e3 * mean['device']:.3f} ms device span of the scoring call "
          f"(idle share {1 - mean['device'] / mean['wall']:.4f}); first "
          f"request {1e3 * walls[0]:.3f} ms")
    other = mean["wall"] - sum(mean[k] for k in RequestTimer.STAGES)
    print("serve host stages per request (ms): " + ", ".join(
        f"{k} {1e3 * mean[k]:.3f}" for k in RequestTimer.STAGES) +
        f", other {1e3 * other:.3f}")
    report["serve"] = {"requests": requests, "batch": BATCH,
                       "per_request_s": timer.stages, "mean_s": mean,
                       "err_ref": err_ref, "err_cpu": err_cpu,
                       "pack_stats": score.last_pack_stats}

    # ---- phase 5: forced packed-dense and bucketed paths ----------------
    for path, name in (("packed_dense", "packed_pair"),
                       ("bucketed_mega", "fused_pair")):
        forced = simgnn_query_server(params, CFG, path=path)
        reset_counts()
        got = forced(batch)
        counts = read_counts()
        served[name] = counts[name]
        plan = forced.last_plan
        assert plan.path == path and plan.degraded_from == () \
            and plan.attempts == 1, plan
        assert counts[name] > 0 and sum(counts.values()) == counts[name], \
            (path, counts)
        err = float(np.abs(got - ref_score(batch)).max())
        print(f"forced {path}: launches {counts}, vs card reference "
              f"{err:.3e} (bound {ATOL[name]:g})")
        assert err <= ATOL[name], (path, err)

    for name, k in kernels.items():
        k["launches"] = served[name]
        assert k["launches"] > 0, name
        print(f"{name}: {k['launches']} launches on its path; kernel "
              f"{k['ms']:.4f} ms against a bound of "
              f"{k['bound_ms'] * 1e3:.3f} us ({k['bound_by']}), "
              f"{k['bound_ms'] / k['ms']:.2%} of the bound; max abs err "
              f"{k['max_abs_err']:.3e} (bound {ATOL[name]:g})")
    line = {"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for k in kernels.values()]}
    report["kernels"] = list(kernels.values())
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class RequestTimer:
    """Where one served request's time goes, measured inside the request:
    the host clock around the engine's stages (plan = validation and
    workload stats; pack = FFD packing, A' edge planes and the copy to the
    card; score = enqueueing the scoring call; unpack = copying the scores
    back, which waits for the card, and restoring request order), and the
    device span of the scoring call from CUDA events around the engine's
    executor seam (`_FAULT_HOOK`). Everything is restored on exit."""

    STAGES = ("plan", "pack", "score", "unpack")

    def __init__(self, engine):
        self.engine = engine
        self.stages: list[dict] = []
        self._events: list = []

    def _timed(self, name, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.stages[-1][name] += time.perf_counter() - t0
            return out
        return run

    def _hook(self, site, thunk):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self._timed("score", thunk)()
        end.record()
        self._events.append((start, end))
        return out

    def __enter__(self):
        from repro_torch.core import batching
        from repro_torch.core import engine as engine_mod

        self.stages.append(dict.fromkeys(self.STAGES, 0.0))
        self._events = []
        self._saved = (engine_mod._FAULT_HOOK, batching.unpack_pair_scores)
        engine_mod._FAULT_HOOK = self._hook
        batching.unpack_pair_scores = self._timed(
            "unpack", batching.unpack_pair_scores)
        self.engine.plan = self._timed("plan", type(self.engine).plan.__get__(
            self.engine))
        self.engine._pack_sparse = self._timed(
            "pack", type(self.engine)._pack_sparse.__get__(self.engine))
        return self

    def __exit__(self, *exc):
        from repro_torch.core import batching
        from repro_torch.core import engine as engine_mod

        engine_mod._FAULT_HOOK, batching.unpack_pair_scores = self._saved
        del self.engine.plan, self.engine._pack_sparse
        torch.cuda.synchronize()
        self.stages[-1]["device"] = sum(s.elapsed_time(e)
                                        for s, e in self._events) / 1e3
        return False


def kernel_device_ms(fn, symbol: str, iters: int = 20) -> float | None:
    """Mean device time (ms) of the CUDA kernel whose name contains
    `symbol` per call of `fn`, from a `torch.profiler` trace of `iters`
    warm calls; None when the trace holds no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if symbol in ev.key:
            us += getattr(ev, "device_time_total",
                          getattr(ev, "cuda_time_total", 0.0))
    return us / iters / 1e3 if us > 0 else None


def time_cuda(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median ms of `fn` on the card (CUDA events, warm)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------- work these inputs need

def _gcn_flops(n_real: float, agg_macs_per_f: float, cfg) -> float:
    """Flops of one side's GCN stack on n_real real nodes whose A' has
    `agg_macs_per_f` non-zeros (or dense cells) per feature column."""
    dims = cfg.feature_dims
    flops = 0.0
    for li, (fin, fout) in enumerate(zip(dims[:-1], dims[1:])):
        if li > 0:
            flops += 2 * n_real * fin * fout          # H·W
        flops += n_real * fout                        # + b (gather on layer 0)
        flops += 2 * agg_macs_per_f * fout            # A'·(HW)
    return flops


def _head_flops(n_real: float, graphs: int, pairs: int, cfg) -> float:
    """Att pooling on n_real nodes in `graphs` graphs + NTN/FCN of
    `pairs` live pairs."""
    f, k = cfg.gcn_dims[-1], cfg.ntn_k
    att = 6 * n_real * f + 2 * graphs * f * f
    dims = (k,) + tuple(cfg.fcn_dims) + (1,)
    head = 2 * (k * f * f + k * f + k * 2 * f) + 2 * sum(
        a * b for a, b in zip(dims[:-1], dims[1:]))
    return att + pairs * head


def _seg_sizes(mask, seg, pair_mask):
    m = mask.cpu().numpy()
    s = seg.cpu().numpy()
    p = pair_mask.shape[-1]
    return np.stack([((s == q) * m).sum(-1) for q in range(p)], -1)   # [T, P]


def _work_sparse(a, cfg):
    flops = 0.0
    pm = a[16]
    live = float(pm.sum())
    for side in (a[:8], a[8:16]):
        _, nw, _, _, ovw, _, mask, _ = side
        n_real = float(mask.sum())
        nnz = float((nw != 0).sum() + (ovw != 0).sum())
        flops += _gcn_flops(n_real, nnz, cfg) + _head_flops(n_real, live, 0,
                                                            cfg)
    flops += _head_flops(0, 0, live, cfg)
    return flops, sum(x.numel() * x.element_size() for x in a)


def _work_packed(a, cfg):
    flops = 0.0
    pm = a[8]
    live = float(pm.sum())
    for adj, _, mask, seg in (a[:4], a[4:8]):
        sizes = _seg_sizes(mask, seg, pm)
        n_real = float(sizes.sum())
        cells = float((sizes ** 2).sum())                  # per-graph blocks
        flops += 3 * cells                                  # normalization
        flops += _gcn_flops(n_real, cells, cfg) + _head_flops(n_real, live, 0,
                                                              cfg)
    flops += _head_flops(0, 0, live, cfg)
    return flops, sum(x.numel() * x.element_size() for x in a)


def _work_fused(a, cfg):
    flops = 0.0
    b = a[0].shape[0]
    for adj, feats, mask in (a[:3], a[3:]):
        n = mask.sum(-1).cpu().numpy()
        n_real = float(n.sum())
        cells = float((n ** 2).sum())
        flops += 3 * cells + 2 * n_real * cfg.n_node_labels * cfg.gcn_dims[0]
        flops += _gcn_flops(n_real, cells, cfg) + _head_flops(n_real, b, 0,
                                                              cfg)
    flops += _head_flops(0, 0, b, cfg)
    return flops, sum(x.numel() * x.element_size() for x in a)


WORK = {"sparse_pair": _work_sparse, "packed_pair": _work_packed,
        "fused_pair": _work_fused}


def param_bytes(params) -> int:
    from repro_torch.params import tree_leaves

    return sum(t.numel() * 4 for t in tree_leaves(params))


def out_bytes(name, arrays) -> int:
    if name == "fused_pair":
        return arrays[0].shape[0] * 4
    return arrays[-1].numel() * 4


if __name__ == "__main__":
    sys.exit(main())
