"""Synthetic AIDS-like graph-pair streams — the port's copy of
`repro.data.graphs` (numpy only; the same seed gives the same graphs, bit
for bit, as the JAX package's generator).

The paper benchmarks on the AIDS antivirus screen dataset (42,687 chemical
compounds; 25.6 nodes / 27.6 edges on average; 29 node-label types) and
forms 10,000 random query pairs. The surrogates here are sparse connected
molecule-like graphs (random spanning tree + a few extra edges, node counts
~ N(25.6, 8) clipped to [5, 64]); pairs are (G, edit(G, k)) with a known GED
upper bound k and SimGNN target exp(-2k / (n1 + n2)).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

N_NODE_LABELS = 29
AVG_NODES = 25.6


def _with_density(g: dict) -> dict:
    """Record the realized sparsity of a graph dict: `avg_degree` (2E/V,
    self loops excluded) and `density` (adjacency nnz fraction)."""
    n = g["adj"].shape[0]
    nnz = float(np.count_nonzero(g["adj"]))
    g["avg_degree"] = nnz / max(n, 1)
    g["density"] = nnz / max(n * n, 1)
    return g


def random_graph(rng: np.random.Generator, n_nodes: int | None = None, *,
                 avg_degree: float | None = None) -> dict:
    if n_nodes is None:
        n_nodes = int(np.clip(rng.normal(AVG_NODES, 8.0), 5, 64))
    # random spanning tree (connected, like chemical compounds)
    adj = np.zeros((n_nodes, n_nodes), np.float32)
    perm = rng.permutation(n_nodes)
    for i in range(1, n_nodes):
        j = perm[rng.integers(0, i)]
        adj[perm[i], j] = adj[j, perm[i]] = 1.0
    if avg_degree is None:
        # sprinkle extra edges: AIDS has ~2 more edges than a tree on average
        extra = rng.poisson(2.0)
    else:
        # Degree knob: aim for n*d/2 total edges on top of the n-1
        # spanning-tree edges; collisions make the target an upper bound
        # and the realized value is recorded below.
        extra = max(0, int(round(n_nodes * avg_degree / 2.0)) - (n_nodes - 1))
    for _ in range(extra):
        a, b = rng.integers(0, n_nodes, 2)
        if a != b:
            adj[a, b] = adj[b, a] = 1.0
    labels = rng.integers(0, N_NODE_LABELS, n_nodes).astype(np.int32)
    return _with_density({"adj": adj, "labels": labels})


def edit_graph(rng: np.random.Generator, g: dict, n_edits: int) -> dict:
    """Apply n_edits random edit operations (edge add/del, label change).
    Node count is preserved so GED <= n_edits by construction."""
    adj = g["adj"].copy()
    labels = g["labels"].copy()
    n = adj.shape[0]
    for _ in range(n_edits):
        op = rng.integers(0, 3)
        if op == 0 and n > 1:                      # add a random edge (no-op
                                                   # if it already exists)
            a, b = rng.integers(0, n, 2)
            if a != b:
                adj[a, b] = adj[b, a] = 1.0
        elif op == 1:                              # delete a random edge
            rr, cc = np.nonzero(np.triu(adj, 1))
            if len(rr):
                i = rng.integers(0, len(rr))
                adj[rr[i], cc[i]] = adj[cc[i], rr[i]] = 0.0
        else:                                      # relabel a node
            labels[rng.integers(0, n)] = rng.integers(0, N_NODE_LABELS)
    return _with_density({"adj": adj, "labels": labels})


def ged_target(n_edits: int, n1: int, n2: int) -> float:
    """SimGNN label normalization: exp(-GED / ((n1+n2)/2))."""
    return float(np.exp(-2.0 * n_edits / (n1 + n2)))


def pair_stream(seed: int, batch: int, max_nodes: int = 64,
                max_edits: int = 8, avg_degree: float | None = None, *,
                device=None) -> Iterator[dict]:
    """Infinite stream of graph-pair batches for SimGNN training: the raw
    `pairs` (+ `target`) and the padded tensors adj1/feats1/mask1,
    adj2/feats2/mask2 on `device` (None = the card), plus the batch's
    realized `density` / `avg_degree` (mean over both sides)."""
    from repro_torch.core.batching import pad_graphs

    rng = np.random.default_rng(seed)
    while True:
        g1s, g2s, targets = [], [], []
        for _ in range(batch):
            g1 = random_graph(rng, avg_degree=avg_degree)
            k = int(rng.integers(0, max_edits + 1))
            g2 = edit_graph(rng, g1, k)
            g1s.append(g1)
            g2s.append(g2)
            targets.append(ged_target(k, g1["adj"].shape[0], g2["adj"].shape[0]))
        b1 = pad_graphs(g1s, N_NODE_LABELS, max_nodes, device=device)
        b2 = pad_graphs(g2s, N_NODE_LABELS, max_nodes, device=device)
        gs = g1s + g2s
        yield {
            "pairs": list(zip(g1s, g2s)),
            "adj1": b1.adj, "feats1": b1.feats, "mask1": b1.mask,
            "adj2": b2.adj, "feats2": b2.feats, "mask2": b2.mask,
            "target": np.asarray(targets, np.float32),
            "density": float(np.mean([g["density"] for g in gs])),
            "avg_degree": float(np.mean([g["avg_degree"] for g in gs])),
        }


def query_pairs(seed: int, n_pairs: int) -> list[tuple[dict, dict]]:
    """A fixed list of query pairs (the paper's 10,000-query benchmark)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_pairs):
        g1 = random_graph(rng)
        g2 = edit_graph(rng, g1, int(rng.integers(0, 9)))
        out.append((g1, g2))
    return out


def zipf_corpus(seed: int, n_corpus: int,
                avg_degree: float | None = None) -> list[dict]:
    """The fixed corpus behind `zipf_query_stream` — generated separately so
    a search service can `index()` exactly the graphs the stream will hit
    (same seed -> same corpus, independent of how many batches are drawn)."""
    rng = np.random.default_rng(seed)
    return [random_graph(rng, avg_degree=avg_degree) for _ in range(n_corpus)]


def zipf_query_stream(seed: int, batch: int, n_corpus: int = 256,
                      exponent: float = 1.1,
                      avg_degree: float | None = None) -> Iterator[dict]:
    """Infinite 1-vs-N search stream with Zipf-skewed corpus reuse: each
    batch pairs one fresh query graph against `batch` corpus graphs drawn
    by Zipf(`exponent`) over a seed-fixed popularity ranking.

    Yields {"pairs": [(query, corpus[i]), ...], "corpus_idx": [batch] int64,
    "query": dict, "unique_frac": fraction of distinct corpus graphs in the
    batch}. Deterministic in `seed` (corpus via `zipf_corpus(seed, ...)`,
    picks from the continuing generator state)."""
    rng = np.random.default_rng(seed)
    corpus = [random_graph(rng, avg_degree=avg_degree)
              for _ in range(n_corpus)]
    # Popularity rank decoupled from generation order (graph size must not
    # correlate with popularity), but fixed by the same seed.
    rank = rng.permutation(n_corpus)
    probs = 1.0 / (rank + 1.0) ** exponent
    probs /= probs.sum()
    while True:
        query = random_graph(rng, avg_degree=avg_degree)
        idx = rng.choice(n_corpus, size=batch, p=probs)
        yield {"pairs": [(query, corpus[i]) for i in idx],
               "corpus_idx": idx.astype(np.int64),
               "query": query,
               "unique_frac": len(np.unique(idx)) / max(batch, 1)}


def search_pairs(seed: int, n_pairs: int,
                 avg_degree: float | None = None) -> list[tuple[dict, dict]]:
    """Similarity-search pair stream: query and database graph sizes are
    independent draws (no GED labels); `avg_degree` targets a non-default
    degree (AIDS-like ~2.1 otherwise)."""
    rng = np.random.default_rng(seed)
    return [(random_graph(rng, avg_degree=avg_degree),
             random_graph(rng, avg_degree=avg_degree))
            for _ in range(n_pairs)]
