"""1-vs-N graph similarity search service — port of `repro.serve.search`
(DESIGN.md §10, §13, §14).

The paper's end use is similarity search: one query compound scored
against a corpus. The server indexes the corpus once (GCN+Att embeddings
through the engine's cache) and keeps the `[N, F]` matrix resident twice:
as the numpy `corpus_emb` the JAX API exposes, and as a float32 tensor on
the engine's device (`corpus_dev`), so a query never copies the corpus to
the card again. A query is served either

  * exactly: one query-side embedding, then the NTN+FCN head kernel over
    all N corpus rows; or
  * in two stages: the blocked top-M prefilter kernel shortlists
    `prefilter_m` rows per query (the calibrated dot proxy, or the exact
    streamed NTN+FCN logit when the calibration misses its recall
    target), the survivors are gathered on the host and reranked through
    the head kernel. With `prefilter_m >= N` the result is bit-identical
    to the exact scan.

A failing prefilter degrades the query to the exact scan and is counted
(`prefilter_degraded`). All scoring goes through `core.engine.
ScoringEngine` (`embed_graphs`, `prefilter_topm`,
`pair_scores_from_embeddings`), so the device rule and the fault seam stay
in one place. `recorder=` hands the engine a shared
`core.profile.TraceRecorder`. With `runtime=` a multi-device
`distributed.sharding.Runtime` (DESIGN.md §16), the prefilter scans the
corpus in one span a mesh device (`_prefilter_spans`, whole column
blocks), in order on the engine's device, and merges the spans'
shortlists on the host; the results equal the one-span scan's bit for
bit. The JAX server's `embed_with_kernels=` is not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.core.cache import graph_key
from repro_torch.core.engine import ScorePlan, ScoringEngine, WorkloadStats
from repro_torch.core.store import (DEFAULT_SHARD_ROWS, ShardStore,
                                    StoreError, tree_digest)
from repro_torch.kernels.retrieval import (collapse_query_ntn,
                                           fit_prefilter_calibration,
                                           prefilter_query_vectors,
                                           retrieval_block_cols,
                                           topm_reference)


@dataclass
class SearchStats:
    """Measured server behavior: stage seconds are cumulative wall-clock so
    callers can report per-stage shares; cache counters come straight from
    the engine's LRU."""
    queries: int = 0
    pairs_scored: int = 0
    index_size: int = 0
    failed_embeddings: int = 0     # corpus rows that are NaN after indexing
    shards_loaded: int = 0         # shards restored verified from disk
    shards_recovered: int = 0      # shards that failed verification and
                                   # were selectively re-embedded
    rows_reembedded: int = 0       # corpus rows recomputed during load()
    prefilter_queries: int = 0     # queries served through the two-stage
                                   # blocked top-M scan
    prefilter_degraded: int = 0    # two-stage queries that fell back to the
                                   # exact full scan on prefilter failure
    recall_samples: int = 0        # two-stage queries also run exact for
                                   # online recall measurement
    recall_sum: float = 0.0        # summed sampled recall@k (mean = sum/n)
    embed_seconds: float = 0.0     # query-side embedding (+ any corpus misses)
    head_seconds: float = 0.0      # NTN+FCN over the corpus (exact scans)
    prefilter_seconds: float = 0.0  # blocked top-M scan (+ proxy collapse)
    gather_seconds: float = 0.0    # host-side survivor row gather
    rerank_seconds: float = 0.0    # exact NTN+FCN head over the M survivors
    calibrate_seconds: float = 0.0  # one-off proxy calibration per index
    topk_seconds: float = 0.0      # host-side partial sort
    cache: dict = field(default_factory=dict)

    @property
    def recall_mean(self) -> float:
        return (self.recall_sum / self.recall_samples
                if self.recall_samples else float("nan"))

    def as_dict(self) -> dict:
        return {"queries": self.queries, "pairs_scored": self.pairs_scored,
                "index_size": self.index_size,
                "failed_embeddings": self.failed_embeddings,
                "shards_loaded": self.shards_loaded,
                "shards_recovered": self.shards_recovered,
                "rows_reembedded": self.rows_reembedded,
                "prefilter_queries": self.prefilter_queries,
                "prefilter_degraded": self.prefilter_degraded,
                "recall_samples": self.recall_samples,
                "recall_mean": round(self.recall_mean, 4)
                if self.recall_samples else None,
                "embed_seconds": round(self.embed_seconds, 6),
                "head_seconds": round(self.head_seconds, 6),
                "prefilter_seconds": round(self.prefilter_seconds, 6),
                "gather_seconds": round(self.gather_seconds, 6),
                "rerank_seconds": round(self.rerank_seconds, 6),
                "calibrate_seconds": round(self.calibrate_seconds, 6),
                "topk_seconds": round(self.topk_seconds, 6),
                **{f"cache_{k}": v for k, v in self.cache.items()}}


class SimilaritySearchServer:
    """Index a graph corpus once, then serve top-k similarity queries on
    `device` (None = the card; raises without CUDA unless "cpu").

    `index()` embeds every corpus graph through the engine's embedding
    cache and keeps the `[N, F]` matrix resident; evictions from the LRU
    never invalidate the index. `topk()`/`search()` serve queries exactly
    or in two stages (module docstring).
    """

    #: sampled two-stage recall below this at calibration time escalates
    #: the proxy from the collapsed linear fit to the exact streamed
    #: NTN+FCN scan.
    PREFILTER_TARGET_RECALL = 0.99

    def __init__(self, params, cfg, *, cache_size: int = 4096,
                 shard_rows: int = DEFAULT_SHARD_ROWS,
                 recall_sample_every: int = 0,
                 clock: Callable[[], float] = time.perf_counter,
                 recorder=None, runtime=None, device=None):
        #: injectable timing source for every SearchStats stage timer; the
        #: same clock feeds the engine (breaker cool-downs, trace records).
        self._clock = clock
        #: a multi-device `runtime` splits the prefilter scan into one
        #: corpus span a mesh device.
        self.engine = ScoringEngine(params, cfg, path="embedding_cache",
                                    cache_size=cache_size, clock=clock,
                                    recorder=recorder, runtime=runtime,
                                    device=device)
        self.corpus: list[dict] = []
        self.corpus_emb = None
        self.stats = SearchStats()
        #: persisted-shard size; also the prefilter's column-block unit.
        self.shard_rows = int(shard_rows)
        #: 0 disables online recall sampling; N>0 runs every Nth two-stage
        #: query through the exact path too and records recall@k on stats.
        self.recall_sample_every = int(recall_sample_every)
        self._calib: dict | None = None
        self._two_stage_queries = 0

    @property
    def corpus_emb(self) -> np.ndarray | None:
        """The resident `[N, F]` float32 corpus matrix (host copy)."""
        return self._corpus_emb

    @corpus_emb.setter
    def corpus_emb(self, emb) -> None:
        # The device copy follows every assignment, so the two never
        # disagree.
        self._corpus_emb = emb
        self.corpus_dev = (None if emb is None else torch.from_numpy(
            np.array(emb, np.float32)).to(self.engine.device))

    # -------------------------------------------------------------- indexing

    def index(self, corpus: list[dict]) -> np.ndarray:
        """Embed and retain the corpus; returns the `[N, F]` matrix.
        Re-indexing replaces the corpus. Rows whose embed bucket could not
        be embedded stay in the index as NaN (ranked last) and are counted
        in `failed_embeddings`."""
        t0 = self._clock()
        self.corpus = list(corpus)
        self.corpus_emb = self.engine.embed_graphs(self.corpus)
        self._calib = None             # proxy must recalibrate per index
        self.stats.embed_seconds += self._clock() - t0
        self.stats.index_size = len(self.corpus)
        self.stats.failed_embeddings = int(
            (~np.isfinite(self.corpus_emb).all(axis=-1)).sum())
        self.stats.cache = self.engine.cache.stats()
        return self.corpus_emb

    # ------------------------------------------------------------ durability

    def save(self, directory: str, *, shard_rows: int | None = None) -> dict:
        """Persist the resident index: the `[N, F]` matrix in checksummed
        row shards plus a versioned manifest with the WL `graph_key` of
        every row and a digest of the model params. Returns the manifest.
        The format is the JAX package's, so either package loads it."""
        if self.corpus_emb is None:
            raise ValueError("no corpus indexed; call index(corpus) first")
        keys = [graph_key(g).hex() for g in self.corpus]
        return ShardStore(directory).write(
            np.ascontiguousarray(self.corpus_emb, np.float32),
            shard_rows=shard_rows or self.shard_rows, graph_keys=keys,
            meta={"kind": "similarity_index",
                  "params_digest": tree_digest(self.engine.params),
                  "n_graphs": len(self.corpus),
                  "feat_dim": int(self.corpus_emb.shape[1])})

    def load(self, directory: str, corpus: list[dict]) -> np.ndarray:
        """Adopt a persisted index for `corpus`. Every shard is checksum-
        verified and its recorded `graph_key`s compared to the corpus rows
        it covers; shards that verify are read, shards that are missing /
        torn / bit-flipped / mismatched are selectively re-embedded and
        counted. Manifest-level problems (missing, unreadable, stale
        format, other model params, other corpus size) raise `StoreError`.
        Bit-identical to `index()` on a clean store."""
        store = ShardStore(directory)
        man = store.manifest()                 # ManifestError on stale/bad
        meta = man.get("meta", {})
        if meta.get("params_digest") != tree_digest(self.engine.params):
            raise StoreError(
                f"index at {directory} was built by a different model "
                f"(params digest {meta.get('params_digest')!r}): scores "
                "from it would be silently wrong — rebuild with index()")
        if meta.get("n_graphs") != len(corpus):
            raise StoreError(
                f"index at {directory} covers {meta.get('n_graphs')} "
                f"graphs but the corpus has {len(corpus)}")
        n, f = int(man["shape"][0]), int(man["shape"][1])
        counters = self.engine.counters        # surfaces via health()
        out = np.zeros((n, f), np.float32)
        corpus = list(corpus)
        row = 0
        loaded = recovered = reembedded = 0
        first_shard_rows = None
        for info in store.shard_infos(man):
            rows = info.shape[0]
            if first_shard_rows is None:
                first_shard_rows = rows
            status = store.verify_shard(info)
            if status == "ok" and info.graph_keys:
                actual = [graph_key(corpus[i]).hex()
                          for i in range(row, row + rows)]
                if list(info.graph_keys) != actual:
                    status = "key_mismatch"
            if status == "ok":
                out[row:row + rows] = store.read_shard(info)
                loaded += 1
            else:
                counters[f"store_shard_{status}"] += 1
                # Selective recovery: re-embed only this shard's rows.
                out[row:row + rows] = self.engine.embed_graphs(
                    corpus[row:row + rows])
                recovered += 1
                reembedded += rows
            row += rows
        if row != n:
            raise StoreError(f"manifest shards cover {row} rows but claim "
                             f"shape[0]={n}")
        self.corpus = corpus
        self.corpus_emb = out
        self._calib = None
        if first_shard_rows:
            # The persisted shard size is the prefilter's block unit.
            self.shard_rows = first_shard_rows
        self.stats.index_size = n
        self.stats.shards_loaded += loaded
        self.stats.shards_recovered += recovered
        self.stats.rows_reembedded += reembedded
        counters["store_shards_loaded"] += loaded
        counters["store_shards_recovered"] += recovered
        counters["store_rows_reembedded"] += reembedded
        self.stats.failed_embeddings = int(
            (~np.isfinite(out).all(axis=-1)).sum())
        # Re-populate the LRU exactly as index() would have.
        for g, emb in zip(corpus, out):
            if np.isfinite(emb).all():
                emb = np.array(emb, np.float32)
                emb.setflags(write=False)
                self.engine.cache.put(graph_key(g), emb)
        self.stats.cache = self.engine.cache.stats()
        return out

    # -------------------------------------------------------------- querying

    def topk(self, query: dict, k: int = 10, *, mode: str = "exact",
             prefilter_m: int = 64) -> tuple[np.ndarray, np.ndarray]:
        """Score `query` against the corpus; returns (indices, scores) of
        the k most similar corpus graphs, scores descending. mode="exact"
        runs the head over all N rows; mode="two_stage" shortlists
        `prefilter_m` candidates first. k is clamped to the corpus size;
        `prefilter_m` is raised to k when k is larger."""
        return self.search([query], k, mode=mode,
                           prefilter_m=prefilter_m)[0]

    def search(self, queries: list[dict], k: int = 10, *,
               mode: str = "exact", prefilter_m: int = 64) -> list[tuple]:
        """Batched search: [(indices, scores), ...] per query. In
        two_stage mode the prefilter scans all queries in one kernel call
        and the rerank batches every survivor into one head call."""
        if mode not in ("exact", "two_stage"):
            raise ValueError(f"mode must be 'exact' or 'two_stage', "
                             f"got {mode!r}")
        if not queries:
            return []
        if mode == "exact":
            return [self._exact_topk(q, k) for q in queries]
        return self._two_stage_search(queries, k, prefilter_m)

    def _exact_topk(self, query: dict, k: int) -> tuple:
        scores = self.scores(query)
        t0 = self._clock()
        top, s = self._rank(scores, k)
        self.stats.topk_seconds += self._clock() - t0
        return top, s

    @staticmethod
    def _rank(scores: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Top-k of a score vector, NaN-safe and k-clamped: ranks on a
        NaN->-inf copy (NaN rows never float into the top-k), keeps the
        returned scores' NaN, and returns the full stable descending order
        for k >= N."""
        n = len(scores)
        k = max(0, min(int(k), n))
        if k == 0:
            return np.empty(0, np.int64), scores[:0]
        rank = np.where(np.isfinite(scores), scores, -np.inf)
        if k >= n:
            top = np.argsort(-rank, kind="stable")
        else:
            top = np.argpartition(-rank, k - 1)[:k]
            top = top[np.argsort(-rank[top], kind="stable")]
        return top.astype(np.int64), scores[top]

    def scores(self, query: dict) -> np.ndarray:
        """Full `[N]` similarity vector of `query` vs the indexed corpus."""
        if self.corpus_emb is None:
            raise ValueError("no corpus indexed; call index(corpus) first")
        t0 = self._clock()
        hq = self.engine.embed_graphs([query])
        t1 = self._clock()
        h1 = torch.from_numpy(hq).to(self.corpus_dev.device).expand(
            len(self.corpus_emb), -1)
        out = self.engine.pair_scores_from_embeddings(h1, self.corpus_dev)
        t2 = self._clock()
        self.stats.queries += 1
        self.stats.pairs_scored += len(self.corpus)
        self.stats.embed_seconds += t1 - t0
        self.stats.head_seconds += t2 - t1
        self.stats.cache = self.engine.cache.stats()
        return out

    # ------------------------------------------------- two-stage retrieval

    def _two_stage_search(self, queries: list[dict], k: int,
                          prefilter_m: int) -> list[tuple]:
        """Blocked top-M prefilter over all queries at once, then one
        batched exact rerank of the survivors."""
        if self.corpus_emb is None:
            raise ValueError("no corpus indexed; call index(corpus) first")
        n = len(self.corpus)
        # The shortlist must cover the requested k, clamped to N.
        m = max(1, min(max(int(prefilter_m), min(int(k), n)), n))
        nq = len(queries)
        t0 = self._clock()
        hq = self.engine.embed_graphs(queries)
        t1 = self._clock()
        self.stats.embed_seconds += t1 - t0
        calib = self._calibration()
        block = retrieval_block_cols(n, shard_rows=self.shard_rows)
        spans = self._prefilter_spans(n, block)
        try:
            if calib["proxy"] == "linear":
                qv = prefilter_query_vectors(
                    self.engine.params["ntn"]["w"], hq, calib)
                ntn_ops = None
            else:                                  # exact streamed NTN+FCN
                qv = hq
                ntn_ops = collapse_query_ntn(self.engine.params["ntn"], hq)
            _, pidx = self._span_topm(qv, ntn_ops, m, block, spans)
        except Exception:
            # A failing prefilter, a single dead span included, must not
            # fail the query: serve it through the exact full scan (query
            # embeds are cached, so only the head re-runs) and count the
            # degradation.
            self.engine.counters["prefilter_degraded"] += nq
            self.stats.prefilter_degraded += nq
            return [self._exact_topk(q, k) for q in queries]
        t2 = self._clock()
        self.stats.prefilter_seconds += t2 - t1
        # Ascending survivor order: sequential row gather and the exact
        # path's stable tie order; with m == N the rerank input is the
        # corpus matrix itself, so results equal mode="exact" bit for bit.
        pidx = np.sort(pidx.astype(np.int64), axis=1)
        h2 = self.corpus_emb[pidx.reshape(-1)]
        h1 = np.repeat(hq, m, axis=0)
        t3 = self._clock()
        self.stats.gather_seconds += t3 - t2
        s = self.engine.pair_scores_from_embeddings(h1, h2).reshape(nq, m)
        t4 = self._clock()
        self.stats.rerank_seconds += t4 - t3
        results = []
        for qi in range(nq):
            loc, sc = self._rank(s[qi], k)
            results.append((pidx[qi][loc].astype(np.int64), sc))
        self.stats.topk_seconds += self._clock() - t4
        self.stats.queries += nq
        self.stats.pairs_scored += nq * m
        self.stats.prefilter_queries += nq
        self.stats.cache = self.engine.cache.stats()
        self.engine.last_plan = ScorePlan(
            path="embedding_cache", fallback="embedding_cache",
            fit_idx=np.arange(nq), over_idx=np.empty(0, np.int64),
            stats=WorkloadStats(n_pairs=nq * m),
            reason=f"two-stage retrieval: {calib['proxy']} prefilter "
                   f"top-{m} of {n} ({len(spans)} span(s), block {block}), "
                   "exact rerank",
            prefilter_m=m, devices=len(spans))
        self._sample_recall(queries, k, results)
        return results

    def _prefilter_spans(self, n: int, block: int) -> list[tuple[int, int]]:
        """Contiguous corpus spans of the prefilter scan: one a device of
        the engine's mesh, each a whole number of `block` columns, so each
        span's blocks are the one-span scan's. Fewer blocks than devices
        give fewer spans; a single-device engine scans one span."""
        n_blocks = -(-n // block)
        n_spans = max(1, min(int(self.engine.n_devices), n_blocks))
        per = -(-n_blocks // n_spans) * block
        return [(lo, min(lo + per, n)) for lo in range(0, n, per)]

    def _span_topm(self, qv, ntn_ops, m: int, block: int,
                   spans: list[tuple[int, int]]) -> tuple:
        """The prefilter over each corpus span (top-min(m, span) there,
        indices offset by the span's start), merged on the host by
        (-score, ascending index): the scans' own order, so with the
        spans' scores equal to the one-span scan's the merged shortlist is
        that scan's, ties included. Counts `prefilter_span_scans` when
        there is more than one span."""
        parts = []
        for lo, hi in spans:
            s, i = self.engine.prefilter_topm(
                qv, self.corpus_dev[lo:hi], min(m, hi - lo),
                block_cols=block, ntn_operands=ntn_ops)
            parts.append((s, i.astype(np.int64) + lo))
        if len(parts) == 1:
            return parts[0]
        self.engine.counters["prefilter_span_scans"] += len(parts)
        s = np.concatenate([p[0] for p in parts], axis=1)
        i = np.concatenate([p[1] for p in parts], axis=1)
        out_s = np.empty((s.shape[0], m), np.float32)
        out_i = np.empty((s.shape[0], m), np.int64)
        for q in range(s.shape[0]):
            order = np.lexsort((i[q], -s[q]))[:m]
            out_s[q], out_i[q] = s[q][order], i[q][order]
        return out_s, out_i

    def _sample_recall(self, queries: list[dict], k: int,
                       results: list[tuple]) -> None:
        """Every `recall_sample_every`-th two-stage query is also served
        exactly and the overlap of the two top-k sets recorded."""
        every = self.recall_sample_every
        for qi, query in enumerate(queries):
            self._two_stage_queries += 1
            if not every or (self._two_stage_queries % every):
                continue
            exact_idx, _ = self._exact_topk(query, k)
            got, want = set(results[qi][0].tolist()), exact_idx.tolist()
            recall = (sum(t in got for t in want) / len(want)
                      if want else 1.0)
            self.stats.recall_samples += 1
            self.stats.recall_sum += recall
            self.engine.counters["prefilter_recall_samples"] += 1

    def _calibration(self) -> dict:
        """Fit and validate the prefilter proxy for the current index (once
        per `index()`/`load()`): fit the collapsed linear proxy against
        exact head scores on a sampled corpus sub-matrix, measure its
        recall@10 there, and keep it only if it meets
        `PREFILTER_TARGET_RECALL`; otherwise use the exact streamed NTN+FCN
        scan."""
        if self._calib is not None:
            return self._calib
        t0 = self._clock()
        emb = self.corpus_emb
        finite = np.flatnonzero(np.isfinite(emb).all(axis=1))
        ntn = self.engine.params["ntn"]
        calib: dict = {"proxy": "ntn_exact", "r2": None,
                       "recall_linear": None,
                       "target_recall": self.PREFILTER_TARGET_RECALL}
        # Validation slice: exact scores for a few pseudo-queries against a
        # bounded corpus sample — index-time cost stays O(1) in N.
        nq = min(8, len(finite))
        nv = min(2048, len(finite))
        if nq >= 2:
            rng = np.random.default_rng(0x5EED ^ len(emb))
            qi = rng.choice(finite, nq, replace=False)
            vi = (finite if nv == len(finite)
                  else rng.choice(finite, nv, replace=False))
            h1 = np.repeat(emb[qi], nv, axis=0)
            h2 = np.tile(emb[vi], (nq, 1))
            y = self.engine.pair_scores_from_embeddings(h1, h2)
            exact = y.reshape(nq, nv)
            kk = min(10, nv)
            true_k = np.argsort(-np.where(np.isfinite(exact), exact,
                                          -np.inf),
                                axis=1, kind="stable")[:, :kk]
            try:
                fit = fit_prefilter_calibration(ntn["w"], h1, h2, y)
                qv = prefilter_query_vectors(ntn["w"], emb[qi], fit)
                mm = min(64, nv)
                _, cand = topm_reference(qv, emb[vi], mm)
                rec = sum(t in set(row.tolist())
                          for row, tk in zip(cand, true_k)
                          for t in tk) / (nq * kk)
                calib.update(fit, recall_linear=round(rec, 4))
                if rec >= self.PREFILTER_TARGET_RECALL:
                    calib["proxy"] = "linear"
            except (np.linalg.LinAlgError, ValueError):
                pass                       # degenerate sample: stay exact
        self._calib = calib
        self.stats.calibrate_seconds += self._clock() - t0
        self.engine.counters["prefilter_calibrations"] += 1
        self.engine.counters[f"prefilter_proxy:{calib['proxy']}"] += 1
        return calib

    def health(self) -> dict:
        """Engine fault-tolerance state plus the server's own view of the
        index; the durable-state counters (`store_*`) ride inside the
        engine's counter dict."""
        calib = self._calib or {}
        return {**self.engine.health(),
                "index_size": self.stats.index_size,
                "failed_embeddings": self.stats.failed_embeddings,
                "shards_loaded": self.stats.shards_loaded,
                "shards_recovered": self.stats.shards_recovered,
                "rows_reembedded": self.stats.rows_reembedded,
                "prefilter": {
                    "proxy": calib.get("proxy"),
                    "r2": calib.get("r2"),
                    "recall_linear": calib.get("recall_linear"),
                    "target_recall": calib.get("target_recall"),
                    "queries": self.stats.prefilter_queries,
                    "degraded": self.stats.prefilter_degraded,
                    "recall_samples": self.stats.recall_samples,
                    "recall_mean": (round(self.stats.recall_mean, 4)
                                    if self.stats.recall_samples else None),
                    "block_cols": (retrieval_block_cols(
                        len(self.corpus), shard_rows=self.shard_rows)
                        if self.corpus else None),
                    "spans": (len(self._prefilter_spans(
                        len(self.corpus), retrieval_block_cols(
                            len(self.corpus), shard_rows=self.shard_rows)))
                        if self.corpus else None)}}

    @property
    def hit_rate(self) -> float:
        return self.engine.cache.hit_rate
