"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc/`, holds each
against its plain PyTorch version on the card at the serving paths'
shapes, serves 2048 AIDS-like pairs through
`simgnn_query_server(use_kernels=True)` in batches of 256 (the packed-sparse
path), forces the packed-dense and bucketed paths on one batch each, and
checks the scores against the port's reference path on the card and its
plain path on the CPU. Then it serves similarity search: a
`SimilaritySearchServer` indexes an 8192-graph corpus, answers exact and
two-stage (prefilter + rerank) top-10 queries, saves and reloads its index,
and is held against the same server on the CPU; and it forces the engine's
`embedding_cache` and `two_kernel` paths on one batch each. Last it serves
the MoE language model granite-moe-3b-a800m at full width and depth in
bf16 (4 prompts of 512 tokens, 16 greedy tokens) through `greedy_generate`
with the expert FFN in the `moe_experts` kernel, holds it against the same
model with the plain expert function on the card, and a 2-layer float32
model on the card against the CPU. Every failed check exits non-zero.

Output: per-kernel lines, the served requests' split into host stages and
device span, the search stages, a `{"kernels": [...]}` JSON line, the
card's name and power limit, and as the last line `{"ok": true, "device":
{...}}`. Kernel `ms` is the kernel's device time from `torch.profiler`
(mean of warm launches; both passes for the top-M scans);
the wrapper call and the plain version are timed with CUDA events (warm,
median); bounds come from this run's inputs against the H100 SXM peaks of
67 TFLOP/s float32 (989 TFLOP/s bf16 for the bf16 expert FFN) and
3.35 TB/s. Details go to
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
PEAK_BF16_FLOPS = 989e12     # H100 SXM bf16 tensor cores, dense
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
BATCH = 256
N_PAIRS = 2048
#: kernel-vs-plain tolerance on post-sigmoid scores, by kernel: the
#: parity bounds of tests/test_parity_matrix.py (f32).
ATOL = {"sparse_pair": 1e-6, "packed_pair": 1e-6, "fused_pair": 2e-5,
        "simgnn_head": 1e-6}
#: embeddings and top-M scores against their plain versions: float32 sums
#: in another order (top-M indices must be equal).
BODY_TOL = dict(rtol=1e-5, atol=1e-6)
REPLACES = {
    "sparse_pair": "src/repro/kernels/sparse_pair.py:94",
    "packed_pair": "src/repro/kernels/packed_pair.py:73",
    "fused_pair": "src/repro/kernels/fused_pair.py:67",
    "fused_gcn": "src/repro/kernels/fused_gcn.py:49",
    "simgnn_head": "src/repro/kernels/simgnn_head.py:37",
    "topm": "src/repro/kernels/retrieval.py:169",
    "topm_ntn": "src/repro/kernels/retrieval.py:197",
    "moe_experts": "src/repro/kernels/moe_experts.py:41",
}
SOURCE = {"topm": "retrieval", "topm_ntn": "retrieval"}
#: the similarity-search phase: corpus rows, two-stage queries (one
#: prefilter call), exact queries, shortlist and result depth, and the
#: prefilter's column block (the default shard size, 256 rows).
SEARCH_CORPUS = 8192
SEARCH_QUERIES = 64
EXACT_QUERIES = 8
PREFILTER_M = 64
TOPK = 10
BLOCK_COLS = 256
#: the LM serving phase: the model, prompts of LM_PROMPT tokens for
#: LM_BATCH sequences, LM_NEW greedy tokens, and the parity matrix's bf16
#: band (tests/test_parity_matrix.py) for logits against the plain run.
#: The band is widened to twice the run's own floor when that is wider:
#: the floor is how far the plain run's logits lie from a run whose expert
#: FFN is computed in float64, i.e. what float32 sums in one valid order
#: do to bf16 logits through 32 layers (routing near-ties included); two
#: runs each within the floor of the float64 run are within twice it of
#: each other.
LM_ARCH = "granite-moe-3b-a800m"
LM_BATCH = 4
LM_PROMPT = 512
LM_NEW = 16
LM_BF16_BOUND = 2e-2
LM_F32_ATOL = 1e-4


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.simgnn_aids import CONFIG as CFG
    from repro_torch.core import batching
    from repro_torch.core.simgnn import SimGNNConfig, init_simgnn_params
    from repro_torch.data.graphs import (edit_graph, query_pairs,
                                         random_graph, zipf_corpus,
                                         zipf_query_stream)
    from repro_torch.kernels import build, ops, retrieval
    from repro_torch.kernels.fused_gcn import fused_gcn_att
    from repro_torch.kernels.fused_pair import (fused_pair_score,
                                                fused_pair_score_plain)
    from repro_torch.kernels.moe_experts import moe_expert_ffn
    from repro_torch.kernels.packed_pair import (packed_pair_score,
                                                 packed_pair_score_plain)
    from repro_torch.kernels.simgnn_head import simgnn_head
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
        timed = timings(lambda: kern(*arrays, *wargs(prm)),
                        lambda: plain(*arrays, *wargs(prm)), f"{name}_kernel")
        flops, nbytes = WORK[name](arrays, CFG)
        nbytes += param_bytes(params) + out_bytes(name, arrays)
        kernels[name] = record(name, worst, *timed, label, flops, nbytes)

    # ---- phase 3b: the search kernels against their plain versions -----
    corpus = zipf_corpus(2, SEARCH_CORPUS)
    stream = zipf_query_stream(3, 2, n_corpus=16)
    queries = [next(stream)["query"] for _ in range(SEARCH_QUERIES)]
    kernels.update(search_kernels(params, narrow, corpus, queries, dev))

    # ---- phase 4: serve 2048 pairs through the packed-sparse path -------
    # Every path below is driven with all launch counts set to 0 just
    # before it and read just after; the comparisons above do not count.
    launched = {"sparse_pair": sparse_pair_score,
                "packed_pair": packed_pair_score,
                "fused_pair": fused_pair_score,
                "fused_gcn": fused_gcn_att, "simgnn_head": simgnn_head,
                "topm": retrieval.blocked_topm,
                "topm_ntn": retrieval.blocked_topm_ntn,
                "moe_experts": moe_expert_ffn}

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

    # ---- phase 6: similarity search served on the card ----------------
    report["search"], counts = search_phase(params, corpus, queries,
                                            reset_counts, read_counts)
    for name in ("fused_gcn", "simgnn_head", "topm", "topm_ntn"):
        served[name] = counts[name]

    # ---- phase 7: the engine's embedding-cached and two-kernel paths ---
    for path, bound in (("embedding_cache", 1e-6), ("two_kernel", 2e-5)):
        forced = simgnn_query_server(params, CFG, path=path)
        reset_counts()
        got = forced(batch)
        counts = read_counts()
        plan = forced.last_plan
        assert plan.path == path and plan.degraded_from == () \
            and plan.attempts == 1, plan
        assert counts["fused_gcn"] > 0 and counts["simgnn_head"] > 0 and \
            sum(counts.values()) == counts["fused_gcn"] + \
            counts["simgnn_head"], (path, counts)
        assert not forced.engine.counters, forced.engine.counters
        err = float(np.abs(got - ref_score(batch)).max())
        print(f"forced {path}: launches {counts}, vs card reference "
              f"{err:.3e} (bound {bound:g})")
        assert err <= bound, (path, err)

    # ---- phases 8-11: MoE LM serving on the card ------------------------
    kernels["moe_experts"], report["lm"], served["moe_experts"] = lm_phases(
        dev, reset_counts, read_counts)

    for name, k in kernels.items():
        k["launches"] = served[name]
        assert k["launches"] > 0, name
        print(f"{name}: {k['launches']} launches on its path; kernel "
              f"{k['ms']:.4f} ms against a bound of "
              f"{k['bound_ms'] * 1e3:.3f} us ({k['bound_by']}), "
              f"{k['bound_ms'] / k['ms']:.2%} of the bound; max abs err "
              f"{k['max_abs_err']:.3e} ({k['err_bound']})")
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


def record(name, worst, ms, ms_source, call_ms, plain_ms, label, flops,
           nbytes, err_bound=None, library_ms=None,
           peak_flops=PEAK_F32_FLOPS, **extra) -> dict:
    """One kernel's entry of the `kernels` line (launches filled in after
    the served paths ran), printed as it is recorded."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    k = {"name": name, "route": "cuda",
         "source": f"src/repro_torch/csrc/{SOURCE.get(name, name)}.cu",
         "replaces": REPLACES[name], "launches": 0, "max_abs_err": worst,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
         "library_ms": library_ms, "ms_source": ms_source,
         "call_ms": call_ms, "timed_case": label, "flops": flops,
         "bytes": nbytes,
         "err_bound": err_bound or f"atol {ATOL[name]:g}", **extra}
    print(f"{name}: max abs err {worst:.3e} ({k['err_bound']}); kernel "
          f"{ms:.4f} ms ({ms_source}), wrapper call {call_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms on [{label}]; bound "
          f"{k['bound_ms'] * 1e3:.3f} us set by {k['bound_by']} "
          f"({flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.4f} MB)")
    return k


def timings(kern, plain, symbols):
    """(kernel ms, its source, wrapper call ms, plain ms) of two thunks."""
    call_ms = time_cuda(kern)
    plain_ms = time_cuda(plain)
    ms = kernel_device_ms(kern, symbols)
    if ms is None:                  # the profiler saw no device time
        return call_ms, "events around the wrapper call", call_ms, plain_ms
    return ms, "profiler", call_ms, plain_ms


def _embed_work(a, feats, mask, cfg) -> tuple[float, int]:
    """Flops and bytes of one embedding launch: the dense layer-0 product
    on one-hot feats and the GCN stack on each graph's real nodes, the Att
    pooling; A', feats and mask read once, [B, F] written once."""
    n = mask.sum(-1).cpu().numpy()
    n_real, cells = float(n.sum()), float((n ** 2).sum())
    flops = (2 * n_real * cfg.n_node_labels * cfg.gcn_dims[0]
             + _gcn_flops(n_real, cells, cfg)
             + _head_flops(n_real, len(n), 0, cfg))
    nbytes = sum(x.numel() * x.element_size() for x in (a, feats, mask))
    return flops, nbytes + len(n) * cfg.gcn_dims[-1] * 4


def _topm_work(q, n, m, f, k=0, fcn=()) -> tuple[float, int]:
    """Flops and bytes of one top-M scan: per (query, row) a dot of F, or
    K dots, the dq add and the FCN stack; the query operands and the
    corpus read once, [Q, M] scores and indices written once."""
    if k:
        per = 2 * k * f + k + 2 * sum(p["w"].numel() for p in fcn) + sum(
            p["b"].numel() for p in fcn)
        inputs = q * (k * f + k) + n * f
    else:
        per, inputs = 2 * f, q * f + n * f
    return float(q * n * per), 4 * inputs + 8 * q * m


def search_kernels(params, narrow, corpus, queries, dev) -> dict:
    """Phase 3b: the embedding, head and both top-M kernels against their
    plain versions at the search path's shapes (the corpus's embed
    buckets, an oversize 130-node graph, the narrow config, B = N for the
    head, (Q, N, M) = (64, 8192, 64) for the scans, M = N and NaN rows);
    the embedding's bit-identity across batch companions and bucket width.
    Returns the four kernels' entries."""
    from repro_torch.configs.simgnn_aids import CONFIG as CFG
    from repro_torch.core.batching import bucket_for, pad_graphs
    from repro_torch.core.gcn import normalized_adjacency
    from repro_torch.data.graphs import random_graph
    from repro_torch.kernels import retrieval
    from repro_torch.kernels.fused_gcn import (fused_gcn_att,
                                               fused_gcn_att_plain)
    from repro_torch.kernels.simgnn_head import (simgnn_head,
                                                 simgnn_head_plain)

    def embed_in(graphs, bucket):
        b = pad_graphs(graphs, CFG.n_node_labels, bucket, device=dev)
        return normalized_adjacency(b.adj, b.mask), b.feats, b.mask

    def gcn_w(p):
        return p["gcn"], p["att"]["w"]

    by_bucket: dict = {}
    for i, g in enumerate(corpus):
        by_bucket.setdefault(bucket_for(g["adj"].shape[0],
                                        allow_oversize=True), []).append(i)
    big = random_graph(np.random.default_rng(7), 130)
    cases = [(f"corpus bucket {b} ({len(ix)} graphs)",
              embed_in([corpus[i] for i in ix], b), params)
             for b, ix in sorted(by_bucket.items())]
    cases += [("oversize 130 nodes (bucket 256)", embed_in([big], 256),
               params),
              ("narrow gcn (16,8,8,4), bucket 32",
               embed_in([corpus[i] for i in by_bucket[32]], 32), narrow)]
    worst, emb = 0.0, torch.empty((len(corpus), CFG.gcn_dims[-1]),
                                  device=dev)
    for label, arrays, prm in cases:
        got = fused_gcn_att(*arrays, *gcn_w(prm))
        want = fused_gcn_att_plain(*arrays, *gcn_w(prm))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"  fused_gcn [{label}]: shape {tuple(got.shape)} max abs err "
              f"{err:.3e}")
        torch.testing.assert_close(got, want, **BODY_TOL)
        worst = max(worst, err)
        if prm is params and label.startswith("corpus"):
            bucket = int(label.split()[2])
            emb[torch.as_tensor(by_bucket[bucket], device=dev)] = got
    # Bit identity: one graph alone, among others, and in a wider bucket.
    g = corpus[by_bucket[32][0]]
    others = [corpus[i] for i in by_bucket[32][1:40]]
    rows = []
    for bucket, batch, at in ((32, [g], 0), (32, others + [g], len(others)),
                              (64, others[:7] + [g], 7),
                              (256, [g, big], 0)):
        rows.append(fused_gcn_att(*embed_in(batch, bucket),
                                  *gcn_w(params))[at])
    identical = all(torch.equal(r, rows[0]) for r in rows)
    print(f"  fused_gcn bit identity across batch companions and buckets "
          f"32/64/256: {identical}")
    assert identical
    main_in = cases[2][1]
    assert cases[2][0].startswith("corpus bucket 32")
    flops, nbytes = _embed_work(*main_in, CFG)
    nbytes += param_bytes({"gcn": params["gcn"], "att": params["att"]})
    out = {"fused_gcn": record(
        "fused_gcn", worst,
        *timings(lambda: fused_gcn_att(*main_in, *gcn_w(params)),
                 lambda: fused_gcn_att_plain(*main_in, *gcn_w(params)),
                 ("fused_gcn_kernel",)),
        cases[2][0], flops, nbytes, err_bound="rtol 1e-05, atol 1e-06",
        bit_identical=identical)}

    # The head at B = N: one query against the whole corpus.
    hq = torch.cat([fused_gcn_att(*embed_in([q], bucket_for(
        q["adj"].shape[0], allow_oversize=True)), *gcn_w(params))
        for q in queries])
    n, f = emb.shape
    h1 = hq[0].expand(n, f).contiguous()
    head_w = (params["ntn"], params["fcn"])
    rng = np.random.default_rng(11)
    nw = [torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
          .to(dev) for _ in range(2)]
    worst = 0.0
    for label, (a, b), w in ((f"B = N = {n}", (h1, emb), head_w),
                             (f"narrow (F = 4), B = {n}", nw,
                              (narrow["ntn"], narrow["fcn"]))):
        err = float((simgnn_head(a, b, *w)
                     - simgnn_head_plain(a, b, *w)).abs().max())
        print(f"  simgnn_head [{label}]: max abs err {err:.3e}")
        assert err <= ATOL["simgnn_head"], (label, err)
        worst = max(worst, err)
    per_pair = _head_flops(0, 0, 1, CFG)
    out["simgnn_head"] = record(
        "simgnn_head", worst,
        *timings(lambda: simgnn_head(h1, emb, *head_w),
                 lambda: simgnn_head_plain(h1, emb, *head_w),
                 ("simgnn_head_kernel",)),
        f"B = N = {n}", per_pair * n,
        3 * n * f * 4 + n * 4 + param_bytes({"ntn": params["ntn"],
                                             "fcn": params["fcn"]}))

    # Both top-M scans: the served shape, M = N, NaN rows.
    uq, dq = (torch.from_numpy(x).to(dev) for x in
              retrieval.collapse_query_ntn(params["ntn"], hq.cpu().numpy()))
    fcn = params["fcn"]
    small = emb[:300].clone()
    nan_rows = small.clone()
    nan_rows[[5, 77, 200]] = float("nan")
    scans = {
        "topm": (lambda c, m, blk: retrieval.blocked_topm(
            hq, c, m, block_cols=blk),
            lambda c, m: retrieval.blocked_topm_plain(hq, c, m),
            ("topm_dot_block_kernel", "topm_merge_kernel"), {}),
        "topm_ntn": (lambda c, m, blk: retrieval.blocked_topm_ntn(
            uq, dq, c, fcn, m, block_cols=blk),
            lambda c, m: retrieval.blocked_topm_ntn_plain(uq, dq, c, fcn, m),
            ("topm_ntn_block_kernel", "topm_merge_kernel"),
            {"k": dq.shape[1], "fcn": fcn}),
    }
    for name, (kern, plain, symbols, work) in scans.items():
        worst = 0.0
        for label, c, m, blk in (
                (f"(Q, N, M) = ({SEARCH_QUERIES}, {n}, {PREFILTER_M})", emb,
                 PREFILTER_M, BLOCK_COLS),
                ("M = N = 300", small, 300, 64),
                ("NaN rows, M = N = 300", nan_rows, 300, 64)):
            (gs, gi), (ws, wi) = kern(c, m, blk), plain(c, m)
            torch.cuda.synchronize()
            same = torch.equal(gi, wi)
            err = float((gs - ws).abs().max())
            print(f"  {name} [{label}]: indices equal {same}, max abs err "
                  f"{err:.3e}")
            assert same and torch.isfinite(gs).all(), (name, label)
            torch.testing.assert_close(gs, ws, **BODY_TOL)
            worst = max(worst, err)
        flops, nbytes = _topm_work(SEARCH_QUERIES, n, PREFILTER_M, f, **work)
        if work:
            nbytes += param_bytes({"fcn": fcn})
        extra = {}
        if name == "topm":
            # The composition a later PR would race: not one call, so it
            # is no `library_ms`; kept as a yardstick.
            extra["yardstick_topk_ms"] = time_cuda(
                lambda: torch.topk(hq @ emb.T, PREFILTER_M, dim=1))
            print(f"  topm yardstick torch.topk(qv @ corpus.T, M): "
                  f"{extra['yardstick_topk_ms']:.4f} ms")
        out[name] = record(
            name, worst,
            *timings(lambda: kern(emb, PREFILTER_M, BLOCK_COLS),
                     lambda: plain(emb, PREFILTER_M), symbols),
            f"(Q, N, M) = ({SEARCH_QUERIES}, {n}, {PREFILTER_M}), block "
            f"{BLOCK_COLS}", flops, nbytes,
            err_bound="indices equal; scores rtol 1e-05, atol 1e-06",
            **extra)
    return out


class SpanTimer:
    """Device span of the engine's executor calls (embed, head,
    prefilter) from CUDA events around the `_FAULT_HOOK` seam, summed
    over a `with` block."""

    def __init__(self):
        self.events: list = []

    def _hook(self, site, thunk):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = thunk()
        end.record()
        self.events.append((start, end))
        return out

    def __enter__(self):
        from repro_torch.core import engine as engine_mod

        self._saved = engine_mod._FAULT_HOOK
        engine_mod._FAULT_HOOK = self._hook
        self.events = []
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine as engine_mod

        engine_mod._FAULT_HOOK = self._saved
        torch.cuda.synchronize()
        self.device_s = sum(s.elapsed_time(e) for s, e in self.events) / 1e3
        return False


def _same_ranking(got, want, scores) -> int:
    """Positions where two top-k index lists differ; each must be a near
    tie (the two rows' CPU scores within 1e-6). Returns their count."""
    swaps = 0
    for (gi, _), (wi, _), s in zip(got, want, scores):
        for a, b in zip(gi, wi):
            if a != b:
                assert abs(float(s[a]) - float(s[b])) <= 1e-6, (a, b)
                swaps += 1
    return swaps


def search_phase(params, corpus, queries, reset_counts, read_counts):
    """Phase 6: `SimilaritySearchServer` on the card. Index the corpus,
    serve exact and two-stage top-k queries, drive the prefilter kernel
    the calibration did not pick through `engine.prefilter_topm` at the
    same shapes, check M = N two-stage against exact and a save/load
    round trip bit for bit, and hold embeddings and rankings against the
    same server on the CPU. Returns (report, launch counts)."""
    import tempfile

    from repro_torch.configs.simgnn_aids import CONFIG as CFG
    from repro_torch.kernels import retrieval
    from repro_torch.serve.search import SimilaritySearchServer

    srv = SimilaritySearchServer(params, CFG, cache_size=16384)
    n = len(corpus)
    reset_counts()
    timer = SpanTimer()
    with timer:
        t0 = time.perf_counter()
        emb = srv.index(corpus)
        index_s = time.perf_counter() - t0
    index_dev = timer.device_s
    exact, walls = [], []
    with timer:
        for q in queries[:EXACT_QUERIES]:
            t0 = time.perf_counter()
            exact.append(srv.topk(q, k=TOPK))
            walls.append(time.perf_counter() - t0)
    exact_dev = timer.device_s
    # Two-stage: one call serves every query (one prefilter launch). The
    # first call also embeds the queries and calibrates the proxy; the
    # second finds the queries cached, as a repeated query would.
    t0 = time.perf_counter()
    srv.search(queries, k=TOPK, mode="two_stage", prefilter_m=PREFILTER_M)
    first_two_s = time.perf_counter() - t0
    first_stages = {"embed_seconds": srv.stats.embed_seconds,
                    "calibrate_seconds": srv.stats.calibrate_seconds}
    keys = ("embed_seconds", "prefilter_seconds", "gather_seconds",
            "rerank_seconds", "topk_seconds")
    before = {k: getattr(srv.stats, k) for k in keys}
    with timer:
        t0 = time.perf_counter()
        two = srv.search(queries, k=TOPK, mode="two_stage",
                         prefilter_m=PREFILTER_M)
        two_s = time.perf_counter() - t0
    two_dev = timer.device_s
    stages = {k: getattr(srv.stats, k) - before[k] for k in keys}
    health = srv.health()
    proxy = health["prefilter"]["proxy"]
    # The other proxy's kernel, at the same shapes (the dot kernel on the
    # raw query embeddings when the exact NTN scan was picked).
    hq = srv.engine.embed_graphs(queries)
    ntn_ops = (retrieval.collapse_query_ntn(params["ntn"], hq)
               if proxy == "linear" else None)
    other = srv.engine.prefilter_topm(hq, srv.corpus_dev, PREFILTER_M,
                                      block_cols=BLOCK_COLS,
                                      ntn_operands=ntn_ops)
    assert other[1].shape == (SEARCH_QUERIES, PREFILTER_M)
    # M = N two-stage is the exact scan, bit for bit.
    ei, es = srv.topk(queries[0], k=TOPK)
    ti, ts = srv.topk(queries[0], k=TOPK, mode="two_stage", prefilter_m=n)
    m_eq_n = bool(np.array_equal(ei, ti) and es.tobytes() == ts.tobytes())
    counts = read_counts()
    print(f"search launches: {counts}")
    assert m_eq_n, "two-stage at M = N differs from the exact scan"
    c = srv.engine.counters
    assert srv.stats.prefilter_degraded == 0 and not c["prefilter_degraded"]
    assert not [k for k in c if k.startswith("errors:")], dict(c)
    assert not c["embed_dropped_graphs"] and srv.stats.failed_embeddings == 0
    with tempfile.TemporaryDirectory() as d:
        srv.save(d)
        fresh = SimilaritySearchServer(params, CFG, cache_size=16384)
        loaded = fresh.load(d, corpus)
        reload_ok = bool(loaded.tobytes() == emb.tobytes() and np.array_equal(
            fresh.topk(queries[1], k=TOPK)[0], srv.topk(queries[1], k=TOPK)[0]))
    assert reload_ok and fresh.stats.shards_recovered == 0
    # The same server on the CPU: the plain path.
    cpu = SimilaritySearchServer(params, CFG, cache_size=16384, device="cpu")
    cpu_emb = cpu.index(corpus)
    emb_err = float(np.abs(emb - cpu_emb).max())
    np.testing.assert_allclose(emb, cpu_emb, **BODY_TOL)
    cpu_exact = [cpu.topk(q, k=TOPK) for q in queries[:EXACT_QUERIES]]
    cpu_two = cpu.search(queries, k=TOPK, mode="two_stage",
                         prefilter_m=PREFILTER_M)
    assert cpu.health()["prefilter"]["proxy"] == proxy
    cpu_scores = [cpu.scores(q) for q in queries]
    swaps = (_same_ranking(exact, cpu_exact, cpu_scores)
             + _same_ranking(two, cpu_two, cpu_scores))
    rep = {"corpus": n, "index_s": index_s, "index_device_s": index_dev,
           "index_graphs_per_s": n / index_s,
           "exact_query_ms": [1e3 * w for w in walls],
           "exact_device_s": exact_dev,
           "first_two_stage_s": first_two_s,
           "first_two_stage_embed_and_calibrate_s": first_stages,
           "two_stage_s": two_s, "two_stage_device_s": two_dev,
           "two_stage_stages_s": stages, "proxy": proxy,
           "calibration": {k: health["prefilter"][k]
                           for k in ("r2", "recall_linear")},
           "m_eq_n_bit_identical": m_eq_n, "reload_bit_identical": reload_ok,
           "embedding_max_abs_err_vs_cpu": emb_err,
           "near_tie_swaps_vs_cpu": swaps, "launches": counts,
           "counters": dict(c)}
    exact_ms = statistics.median(rep["exact_query_ms"])
    print(f"search: index {n} graphs in {index_s:.3f} s "
          f"({n / index_s:.1f} graphs/s, device span {index_dev:.4f} s); "
          f"exact top-{TOPK} query {exact_ms:.3f} ms median "
          f"(idle share {1 - exact_dev / sum(walls):.4f}); two-stage "
          f"{SEARCH_QUERIES} queries in {1e3 * two_s:.3f} ms "
          f"({1e3 * two_s / SEARCH_QUERIES:.3f} ms per query, idle share "
          f"{1 - two_dev / two_s:.4f}); proxy {proxy}")
    print(f"search: first two-stage call {1e3 * first_two_s:.3f} ms "
          f"(cumulative embed {1e3 * first_stages['embed_seconds']:.3f} ms "
          f"incl. the index, calibrate "
          f"{1e3 * first_stages['calibrate_seconds']:.3f} ms)")
    print("search two-stage stages (ms per call): " + ", ".join(
        f"{k.replace('_seconds', '')} {1e3 * v:.3f}"
        for k, v in stages.items()))
    print(f"search checks: M = N bit-identical {m_eq_n}, reload "
          f"bit-identical {reload_ok}, embeddings vs CPU {emb_err:.3e}, "
          f"top-{TOPK} equal to the CPU server's but {swaps} near-tie "
          f"swaps, prefilter_degraded 0, no errors")
    return rep, counts


def _bf16_excess(got, want) -> float:
    """max(|got - want| - bound) where the bound is one bf16 ulp of the
    value plus the float32 bound (rtol 1e-5, atol 1e-6) for sums taken in
    another order before the one rounding; <= 0 passes."""
    want = want.float()
    _, ex = torch.frexp(want.abs())
    ulp = torch.ldexp(torch.ones_like(want), ex - 8)
    bound = ulp + BODY_TOL["atol"] + BODY_TOL["rtol"] * want.abs()
    return float(((got.float() - want).abs() - bound).max())


def _moe_work(b, e, c, d, f, elt) -> tuple[float, int]:
    """Flops and bytes of one expert-FFN launch: 6 B E C D F flops (x W_in
    is 4 B E C D F, h W_out 2 B E C F D), x read and y written once, both
    weights read once."""
    return 6.0 * b * e * c * d * f, (2 * b * e * c * d + 3 * e * d * f) * elt


def _profile_busy(fn):
    """Where one call of `fn` spends its time, from `torch.profiler`: wall
    s, device busy s (the sum of every device activity's own time; one
    stream, so activities do not overlap), the moe kernel's s, the number
    of kernel launches the host made, and the five device activities that
    took longest (name, s, count)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = moe = 0.0
    launches, device = 0, []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        busy += us
        if "moe_expert_ffn_kernel" in ev.key:
            moe += us
        if ev.key in ("cudaLaunchKernel", "cuLaunchKernel",
                      "cudaLaunchKernelExC", "cuLaunchKernelEx"):
            launches += ev.count
        if us > 0:
            device.append((ev.key[:80], us / 1e6, ev.count))
    device.sort(key=lambda t: -t[1])
    return wall, busy / 1e6, moe / 1e6, launches, device[:5]


def _expert_ffn_f64(x, w_in, w_out):
    """The expert FFN computed in float64, rounded once to x's dtype: the
    floor the served logits are compared against."""
    h = torch.einsum("...ecd,edf->...ecf", x.double(), w_in.double())
    gate, up = h.chunk(2, dim=-1)
    y = torch.einsum("...ecf,efd->...ecd", gate * torch.sigmoid(gate) * up,
                     w_out.double())
    return y.to(x.dtype)


def lm_phases(dev, reset_counts, read_counts):
    """Phases 8-11: granite-moe-3b-a800m served on the card.

    8 (a): the `moe_experts` kernel against its plain version at the
       served shapes (E 40, D 1536, F 512; B 4 with C 129 for a 512-token
       prefill and C 8 for a decode step), bf16 and float32, and an odd
       shape (B 3, E 7, C 13, D 200, F 36);
    9 (b): the main path: `greedy_generate` at full width and depth in
       bf16 (random weights from `torch.Generator` seed 0, drawn on the
       card), 4 prompts of 512 tokens from `batch_for_step(seed=17)`, 16
       new tokens, launch counts zeroed just before and read just after;
       then the steps timed alone, a profiled run for the idle share, and
       the same model with the plain expert function forced on the card
       (and, for the floor of that comparison, in float64);
    10 (c): a 2-layer float32 model at full width on the card (kernel)
       against the CPU (plain): last logits within LM_F32_ATOL;
    11 (d): the kernel's work, bound and the share of dispatch rows that
       hold a token.
    Returns (the kernel's entry, the phase report, main-path launches)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.kernels.moe_experts import (moe_expert_ffn,
                                                 moe_expert_ffn_plain,
                                                 moe_expert_ffn_rows)
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.init import init_params
    from repro_torch.params import params_to, tree_leaves
    from repro_torch.serve.step import (build_decode_step,
                                        build_prefill_step, greedy_generate)

    cfg = get_config(LM_ARCH).with_(moe_use_kernel=True)
    e, d, f, k = cfg.n_experts, cfg.d_model, cfg.d_ff_expert, cfg.top_k
    c_pre = moe_mod.moe_capacity(LM_PROMPT, e, k, cfg.capacity_factor)
    c_dec = moe_mod.moe_capacity(1, e, k, cfg.capacity_factor)
    rep: dict = {"arch": LM_ARCH, "batch": LM_BATCH, "prompt": LM_PROMPT,
                 "new_tokens": LM_NEW, "capacity": [c_pre, c_dec]}

    # ---- (a) the kernel against its plain version ----------------------
    g = torch.Generator(device=dev).manual_seed(5)

    def inputs(b, e_, c, d_, f_, dtype):
        x = torch.randn((b, e_, c, d_), device=dev, generator=g)
        w_in = torch.randn((e_, d_, 2 * f_), device=dev, generator=g) * 0.02
        w_out = torch.randn((e_, f_, d_), device=dev, generator=g) * (
            0.02 / cfg.n_layers ** 0.5)
        return [t.to(dtype) for t in (x, w_in, w_out)]

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("prefill bf16", (LM_BATCH, e, c_pre, d, f, bf16)),
             ("decode bf16", (LM_BATCH, e, c_dec, d, f, bf16)),
             ("prefill f32", (LM_BATCH, e, c_pre, d, f, f32)),
             ("decode f32", (LM_BATCH, e, c_dec, d, f, f32)),
             ("odd B 3 E 7 C 13 D 200 F 36, f32", (3, 7, 13, 200, 36, f32)),
             ("odd B 3 E 7 C 13 D 200 F 36, bf16", (3, 7, 13, 200, 36, bf16))]
    worst_bf16 = worst_f32 = 0.0
    worst_excess = float("-inf")
    held = {}
    for label, shape in cases:
        args = inputs(*shape)
        got = moe_expert_ffn(*args)
        want = moe_expert_ffn_plain(*args)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype, label
        assert torch.isfinite(got.float()).all(), label
        err = float((got.float() - want.float()).abs().max())
        rows = moe_expert_ffn_rows(*args)
        if shape[-1] == bf16:
            excess = _bf16_excess(got, want)
            print(f"  moe_experts [{label}]: rows/CTA {rows}, max abs err "
                  f"{err:.3e}, excess over one bf16 ulp + f32 bound "
                  f"{excess:.3e}")
            assert excess <= 0, (label, excess)
            worst_bf16, worst_excess = max(worst_bf16, err), max(
                worst_excess, excess)
        else:
            print(f"  moe_experts [{label}]: rows/CTA {rows}, max abs err "
                  f"{err:.3e} (rtol 1e-05, atol 1e-06)")
            torch.testing.assert_close(got, want, **BODY_TOL)
            worst_f32 = max(worst_f32, err)
        if label.endswith("bf16") and not label.startswith("odd"):
            held[label.split()[0]] = args
    rep["kernel_vs_plain"] = {"max_abs_err_bf16": worst_bf16,
                              "max_abs_err_f32": worst_f32,
                              "bf16_excess_over_bound": worst_excess}

    # ---- (d) work and bound at the served shapes -----------------------
    timed = {}
    for phase, c in (("prefill", c_pre), ("decode", c_dec)):
        args = held[phase]
        flops, nbytes = _moe_work(LM_BATCH, e, c, d, f, 2)
        ms, src, call_ms, plain_ms = timings(
            lambda: moe_expert_ffn(*args),
            lambda: moe_expert_ffn_plain(*args), "moe_expert_ffn_kernel")
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES \
            * 1e3
        timed[phase] = {"ms": ms, "ms_source": src, "call_ms": call_ms,
                        "plain_ms": plain_ms, "flops": flops,
                        "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
                        "bound_by": "operations" if t_ops >= t_bytes
                        else "bytes", "rows_per_cta":
                        moe_expert_ffn_rows(*args)}
        print(f"  moe_experts {phase} (B {LM_BATCH}, C {c}): kernel "
              f"{ms:.4f} ms, wrapper {call_ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms; bound {timed[phase]['bound_ms'] * 1e3:.3f} us "
              f"({timed[phase]['bound_by']}: {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.3f} MB)")
    del held
    rep["kernel_times"] = timed
    pre = timed["prefill"]
    entry = record(
        "moe_experts", max(worst_bf16, worst_f32), pre["ms"],
        pre["ms_source"], pre["call_ms"], pre["plain_ms"],
        f"prefill bf16 (B, E, C, D, F) = ({LM_BATCH}, {e}, {c_pre}, {d}, "
        f"{f})", pre["flops"], pre["bytes"],
        err_bound="bf16: one bf16 ulp + (rtol 1e-05, atol 1e-06); f32: "
        "rtol 1e-05, atol 1e-06", peak_flops=PEAK_BF16_FLOPS,
        decode=timed["decode"])

    # ---- (b) the main path: greedy_generate at full width and depth ----
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    rep["init_s"], rep["n_params"] = time.perf_counter() - t0, n_params
    prompt = torch.from_numpy(batch_for_step(
        cfg, 0, global_batch=LM_BATCH, seq_len=LM_PROMPT,
        seed=17)["tokens"]).to(dev)
    greedy_generate(params, cfg, prompt[:, :16], max_new=2,
                    device=dev)                                   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks = greedy_generate(params, cfg, prompt, max_new=LM_NEW, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"lm serve launches: {counts}")
    launches = counts["moe_experts"]
    assert launches == cfg.n_layers * LM_NEW, counts
    assert sum(counts.values()) == launches, counts
    assert toks.shape == (LM_BATCH, LM_NEW)
    assert int(toks.max()) < cfg.vocab_size and int(toks.min()) >= 0

    # the steps alone, each ended by a synchronize
    prefill, decode = build_prefill_step(cfg), build_decode_step(cfg)
    t0 = time.perf_counter()
    last, caches, pos = prefill(params, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    kern_last = last.clone()
    nxt = torch.argmax(last, -1)
    step_s = []
    for _ in range(LM_NEW - 1):
        t0 = time.perf_counter()
        logits, caches, pos = decode(params, nxt[:, None], caches, pos)
        nxt = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    wall, busy, moe_s, n_launch, top = _profile_busy(
        lambda: greedy_generate(params, cfg, prompt, max_new=LM_NEW,
                                device=dev))
    step_prof = _profile_busy(
        lambda: decode(params, nxt[:, None], caches, pos))
    del caches
    decode_ms = 1e3 * statistics.fmean(step_s)
    rep.update({
        "generate_s": gen_s, "tokens_per_s": LM_BATCH * LM_NEW / gen_s,
        "prefill_ms": 1e3 * prefill_s,
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
        "decode_ms_per_step": decode_ms,
        "decode_step_ms": [1e3 * x for x in step_s],
        "decode_tokens_per_s": LM_BATCH / (decode_ms / 1e3),
        "profiled_wall_s": wall, "device_busy_s": busy,
        "idle_share": 1 - busy / wall, "moe_kernel_s": moe_s,
        "host_kernel_launches": n_launch, "top_device": top,
        "decode_step_profile": dict(zip(
            ("wall_s", "device_busy_s", "moe_kernel_s", "host_kernel_launches",
             "top_device"), step_prof)),
        "launches": counts})
    print(f"lm serve: {LM_ARCH} ({n_params / 1e9:.3f} B params, bf16, "
          f"{cfg.n_layers} layers), {LM_BATCH} x {LM_PROMPT}-token prompts, "
          f"{LM_NEW} greedy tokens in {gen_s:.3f} s "
          f"({rep['tokens_per_s']:.1f} tokens/s); prefill {1e3 * prefill_s:.3f}"
          f" ms ({rep['prefill_tokens_per_s']:.0f} prompt tokens/s), decode "
          f"{decode_ms:.3f} ms/step ({rep['decode_tokens_per_s']:.1f} "
          f"tokens/s)")
    print(f"lm serve profiled run: wall {wall:.3f} s, device busy "
          f"{busy:.3f} s (idle share {1 - busy / wall:.4f}), of which the "
          f"moe_experts kernel {moe_s:.3f} s; {n_launch} kernel launches "
          f"by the host")
    print("lm serve profiled run, longest device activities: " + "; ".join(
        f"{name} {t:.4f} s x{c}" for name, t, c in top))
    print(f"lm one decode step profiled: wall {1e3 * step_prof[0]:.3f} ms, "
          f"device busy {1e3 * step_prof[1]:.3f} ms (moe_experts "
          f"{1e3 * step_prof[2]:.3f} ms), {step_prof[3]} kernel launches")

    # the same model with the plain expert function forced on the card,
    # and with the expert FFN in float64 (the floor of the comparison)
    fill = []

    def plain_expert(x, w_in, w_out):
        fill.append(float((x != 0).any(-1).float().mean()))
        return moe_expert_ffn_plain(x, w_in, w_out)

    saved = moe_mod.moe_expert_ffn
    before = read_counts()["moe_experts"]
    try:
        moe_mod.moe_expert_ffn = plain_expert
        last, caches, pos = prefill(params, prompt)
        plain_logits = [last]
        nxt = torch.argmax(last, -1)
        plain_toks = [nxt]
        for _ in range(LM_NEW - 1):
            logits, caches, pos = decode(params, nxt[:, None], caches, pos)
            nxt = torch.argmax(logits, -1)
            plain_logits.append(logits)
            plain_toks.append(nxt)
        del caches
        moe_mod.moe_expert_ffn = _expert_ffn_f64
        f64_last = prefill(params, prompt)[0]
    finally:
        moe_mod.moe_expert_ffn = saved
    assert read_counts()["moe_experts"] == before
    plain_toks = torch.stack(plain_toks, 1).to(torch.int32)
    v = cfg.vocab_size
    errs = {name: (a[:, :v] - b[:, :v]).abs() for name, a, b in (
        ("kernel_vs_plain", kern_last, plain_logits[0]),
        ("kernel_vs_f64", kern_last, f64_last),
        ("plain_vs_f64", plain_logits[0], f64_last))}
    floor = float(errs["plain_vs_f64"].max())
    bound = max(LM_BF16_BOUND, 2 * floor)
    for name, err in errs.items():
        print(f"lm prefill logits {name.replace('_', ' ')}: max abs err "
              f"{float(err.max()):.3e}, mean {float(err.mean()):.3e}, "
              f"{int((err > LM_BF16_BOUND).sum())} of {err.numel()} above "
              f"{LM_BF16_BOUND:g}")
    print(f"lm prefill logits bound: max({LM_BF16_BOUND:g}, 2 x floor "
          f"{floor:.3e}) = {bound:.3e} (logit std "
          f"{float(kern_last[:, :v].std()):.3f})")
    for name in ("kernel_vs_plain", "kernel_vs_f64"):
        assert float(errs[name].max()) <= bound, (name, bound)
    flips, compared = [], 0
    for b in range(LM_BATCH):
        for t in range(LM_NEW):
            top2 = torch.topk(plain_logits[t][b], 2).values
            margin = float(top2[0] - top2[1])
            if int(toks[b, t]) == int(plain_toks[b, t]):
                compared += 1
                continue
            assert margin <= bound, (b, t, margin)
            flips.append({"sequence": b, "step": t, "margin": margin})
            print(f"  token flip under the margin: sequence {b}, step {t}, "
                  f"plain top-2 margin {margin:.3e}; later steps of this "
                  f"sequence not compared")
            break
    print(f"lm tokens: {compared} equal to the plain run's, "
          f"{len(flips)} flips under the {bound:.3e} margin")
    prefill_err = float(errs["kernel_vs_plain"].max())
    share_pre = statistics.fmean(fill[:cfg.n_layers])
    share_dec = statistics.fmean(fill[cfg.n_layers:])
    print(f"dispatch rows holding a token: prefill {share_pre:.4f} of "
          f"B*E*C = {LM_BATCH * e * c_pre}, decode {share_dec:.4f} of "
          f"{LM_BATCH * e * c_dec}")
    rep.update({"prefill_logits_err_vs_plain": prefill_err,
                "prefill_logits_err": {n: {"max": float(e_.max()),
                                           "mean": float(e_.mean())}
                                       for n, e_ in errs.items()},
                "prefill_logits_bound": bound,
                "tokens_compared": compared, "flips": flips,
                "row_fill_prefill": share_pre, "row_fill_decode": share_dec})
    entry["row_fill"] = {"prefill": share_pre, "decode": share_dec}
    del params
    torch.cuda.empty_cache()

    # ---- (c) float32, full width, 2 layers: card against CPU -----------
    cfg32 = cfg.with_(n_layers=2, param_dtype="float32", dtype="float32")
    p32 = init_params(torch.Generator().manual_seed(1), cfg32, device=dev)
    short = torch.from_numpy(batch_for_step(
        cfg32, 1, global_batch=2, seq_len=64, seed=17)["tokens"])
    step32 = build_prefill_step(cfg32)
    card_last = step32(p32, short.to(dev))[0]
    host_last = step32(params_to(p32, "cpu"), short)[0]
    err32 = float((card_last.cpu() - host_last).abs().max())
    print(f"lm float32 2 layers, 2 x 64 tokens: card (kernel) vs CPU "
          f"(plain) last logits max abs err {err32:.3e} "
          f"(bound {LM_F32_ATOL:g})")
    assert err32 <= LM_F32_ATOL, err32
    rep["f32_2layer_err_vs_cpu"] = err32
    del p32
    torch.cuda.empty_cache()
    return entry, rep, launches


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


def kernel_device_ms(fn, symbols, iters: int = 20) -> float | None:
    """Mean device time (ms) per call of `fn` of the CUDA kernels whose
    names contain one of `symbols` (a string or a tuple), from a
    `torch.profiler` trace of `iters` warm calls; None when the trace holds
    no device time for them."""
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
        if any(sym in ev.key for sym in (
                (symbols,) if isinstance(symbols, str) else symbols)):
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
