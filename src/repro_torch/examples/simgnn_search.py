"""The paper's end-to-end workload, a graph-similarity search service —
port of `examples/simgnn_search.py`.

Streams query pairs (AIDS-like synthetic compounds), scores them through
the scoring engine (`serve.batching.simgnn_query_server`) and reports
throughput. `--kernels` routes through the engine's auto dispatch (the
packed paths, the CUDA kernels on the card), `--path` forces any of the
six paths, `--avg-degree` changes the stream's sparsity.

`--topk` switches to the 1-vs-N service: index a fixed corpus once
through `serve.search.SimilaritySearchServer`, then serve top-k queries
from the Zipf-skewed stream. `--mode two_stage` serves through the blocked
top-M prefilter and the exact rerank (`--topm` sets the shortlist M);
`--index-dir` persists the index and reloads it on the next run. The
search server always embeds through the engine's kernels (on the card the
CUDA kernels, on the CPU their plain versions), so `--kernels` changes
nothing in `--topk` mode.

    PYTHONPATH=src python -m repro_torch.examples.simgnn_search --kernels
    PYTHONPATH=src python -m repro_torch.examples.simgnn_search --topk 5 \\
        --corpus 4096 --mode two_stage --topm 64
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.simgnn_aids import CONFIG as CFG
from repro_torch.core.engine import PATHS
from repro_torch.core.simgnn import init_simgnn_params
from repro_torch.data.graphs import (query_pairs, search_pairs, zipf_corpus,
                                     zipf_query_stream)
from repro_torch.serve.batching import simgnn_query_server
from repro_torch.serve.search import SimilaritySearchServer


def main(argv=None, *, params=None) -> dict:
    """Runs the example; returns its results (the pairs mode's first
    batch's scores, or the top-k mode's last result and the server).
    `params` replaces the seeded init."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--kernels", action="store_true",
                    help="use the engine's auto dispatch (packed kernels)")
    ap.add_argument("--path", default=None, choices=("auto",) + PATHS,
                    help="force a scoring path (default: flags -> engine)")
    ap.add_argument("--avg-degree", type=float, default=None,
                    help="stream degree knob (AIDS-like ~2.1 default); "
                         "switches to the independent-size search stream")
    ap.add_argument("--topk", type=int, default=None,
                    help="1-vs-N mode: index a corpus once, serve top-k "
                         "queries")
    ap.add_argument("--corpus", type=int, default=256,
                    help="corpus size for --topk mode")
    ap.add_argument("--mode", default="exact",
                    choices=("exact", "two_stage"),
                    help="--topk query path: exact full-head scan, or the "
                         "blocked top-M prefilter + exact rerank")
    ap.add_argument("--topm", type=int, default=64,
                    help="two_stage shortlist size M (clamped to corpus)")
    ap.add_argument("--index-dir", default=None,
                    help="persist/reload the corpus index here: loads the "
                         "verified shard store if present (re-embedding "
                         "bad shards), else builds the index and saves it")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if params is None:
        params = init_simgnn_params(torch.Generator().manual_seed(0), CFG)
    if args.topk is not None:
        return run_topk(params, args)
    if args.avg_degree is None:
        pairs = query_pairs(seed=1, n_pairs=args.queries)
    else:
        pairs = search_pairs(seed=1, n_pairs=args.queries,
                             avg_degree=args.avg_degree)
    score = simgnn_query_server(params, CFG, use_kernels=args.kernels,
                                path=args.path, device=args.device)

    score(pairs[: args.batch])                        # warmup
    plan = score.last_plan
    print(f"engine plan: path={plan.path} ({plan.reason}); "
          f"{len(plan.fit_idx)} packed / {len(plan.over_idx)} bucketed")

    t0 = time.time()
    results = []
    for i in range(0, len(pairs), args.batch):
        results.append(score(pairs[i:i + args.batch]))
    dt = time.time() - t0
    qps = len(pairs) / dt
    print(f"scored {len(pairs)} queries in {dt:.2f}s -> {qps:,.0f} query/s "
          f"(batch={args.batch}, kernels={args.kernels}, "
          f"path={score.last_plan.path})")
    if score.last_pack_stats:
        st = score.last_pack_stats
        print(f"last pack: {st['n_tiles']} tiles, occupancy "
              f"{st['occupancy_lhs']:.2f}/{st['occupancy_rhs']:.2f}"
              + (f", edge occupancy {st['edge_occupancy']:.2f}"
                 if "edge_occupancy" in st else ""))
    print(f"first scores: {[f'{s:.3f}' for s in results[0][:6]]}")
    return {"first_scores": results[0], "plan": score.last_plan,
            "queries_per_s": qps}


def run_topk(params, args) -> dict:
    """1-vs-N similarity search through the embedding cache, with optional
    durable-index persist/reload and the two-stage prefilter+rerank query
    path."""
    from repro_torch.core.store import StoreError

    two_stage = args.mode == "two_stage"
    server = SimilaritySearchServer(
        params, CFG, device=args.device,
        # Sampled recall: every 4th two-stage query is ALSO served
        # exactly and the top-k overlap recorded on stats.
        recall_sample_every=4 if two_stage else 0)
    corpus = zipf_corpus(seed=1, n_corpus=args.corpus,
                         avg_degree=args.avg_degree)
    loaded = False
    if args.index_dir:
        t0 = time.time()
        try:
            server.load(args.index_dir, corpus)
            st = server.stats
            print(f"loaded persisted index from {args.index_dir} in "
                  f"{time.time() - t0:.2f}s ({st.shards_loaded} shards "
                  f"verified, {st.shards_recovered} recovered, "
                  f"{st.rows_reembedded} rows re-embedded)")
            loaded = True
        except StoreError as exc:
            print(f"persisted index unusable ({exc}); rebuilding")
    if not loaded:
        t0 = time.time()
        server.index(corpus)
        print(f"indexed {len(corpus)} corpus graphs in "
              f"{time.time() - t0:.2f}s (embeddings resident, LRU "
              f"{server.engine.cache.stats()['size']} entries)")
        if args.index_dir:
            server.save(args.index_dir)
            print(f"saved index shards + manifest to {args.index_dir}")

    stream = zipf_query_stream(seed=1, batch=args.batch,
                               n_corpus=args.corpus,
                               avg_degree=args.avg_degree)
    n_queries = max(1, args.queries // args.batch)
    kw = ({"mode": "two_stage", "prefilter_m": args.topm}
          if two_stage else {})
    server.topk(next(stream)["query"], k=args.topk, **kw)  # warmup
    t0 = time.time()
    last = None
    for _ in range(n_queries):
        last = server.topk(next(stream)["query"], k=args.topk, **kw)
    dt = time.time() - t0
    st = server.stats
    pairs_s = st.pairs_scored / dt if dt else float("inf")
    print(f"served {n_queries} {args.mode} top-{args.topk} queries vs "
          f"corpus of {args.corpus} in {dt:.2f}s -> "
          f"{n_queries / dt:,.1f} query/s ({pairs_s:,.0f} pair-scores/s)")
    if two_stage:
        pf = server.health()["prefilter"]
        busy = (st.embed_seconds + st.prefilter_seconds + st.gather_seconds
                + st.rerank_seconds + st.topk_seconds)
        if busy:
            print(f"stage split: embed {st.embed_seconds / busy:.0%}, "
                  f"prefilter {st.prefilter_seconds / busy:.0%}, "
                  f"gather {st.gather_seconds / busy:.0%}, "
                  f"rerank {st.rerank_seconds / busy:.0%}, "
                  f"topk {st.topk_seconds / busy:.0%} "
                  f"(M={args.topm}, block {pf['block_cols']}, "
                  f"proxy {pf['proxy']})")
        if st.recall_samples:
            print(f"sampled recall vs exact: {st.recall_mean:.4f} over "
                  f"{st.recall_samples} samples "
                  f"({st.prefilter_degraded} degraded to exact)")
    else:
        busy = st.embed_seconds + st.head_seconds + st.topk_seconds
        if busy:
            # Corpus embeddings are served from the resident index matrix,
            # so the LRU hit rate only moves when clients repeat queries.
            print(f"stage split: embed {st.embed_seconds / busy:.0%}, "
                  f"head {st.head_seconds / busy:.0%}, "
                  f"topk {st.topk_seconds / busy:.0%}; "
                  f"repeated-query hit rate {server.hit_rate:.0%}")
    idx, scores = last
    print("top results: " + ", ".join(
        f"#{i}={s:.3f}" for i, s in zip(idx, scores)))
    return {"top": last, "server": server, "loaded": loaded,
            "queries_per_s": n_queries / dt}


if __name__ == "__main__":
    main()
