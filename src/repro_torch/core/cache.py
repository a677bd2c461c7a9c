"""Engine-level embedding cache for 1-vs-N similarity search — the port's
copy of `repro.core.cache` (numpy only; keys and fingerprints are byte-equal
to the JAX package's for the same graph dict).

  * `graph_key` — a canonical, node-order-invariant hash of a graph dict
    (node count, int labels, edge list) by Weisfeiler-Lehman colour
    refinement. WL can collide on 1-WL-equivalent non-isomorphic graphs,
    but a GCN is bounded by 1-WL expressiveness, so two graphs the key
    conflates get identical embeddings from this model family anyway.
  * `graph_fingerprint` — a cheap structural fingerprint that guards the
    64-bit mixing collisions the WL argument does not cover.
  * `EmbeddingCache` — an LRU over those keys with hit/miss/eviction/
    collision counters; capacity 0 disables storage.

Host-side on purpose: keys are computed where the graphs are born, never on
the device.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np

#: WL refinement rounds for `graph_key`. Three rounds stabilize colors on
#: molecule-sized graphs (diameter-limited information has propagated); more
#: rounds refine nothing a 3-layer GCN could tell apart either.
WL_ITERS = 3


def _digest(payload: bytes) -> bytes:
    return hashlib.blake2b(payload, digest_size=16).digest()


_MIX1 = np.uint64(0xBF58476D1CE4E5B9)       # splitmix64 finalizer constants
_MIX2 = np.uint64(0x94D049BB133111EB)
_SELF = np.uint64(0x9E3779B97F4A7C15)       # golden-ratio odd multipliers
_NBR = np.uint64(0xD6E8FEB86659FD93)
_LBL = np.uint64(0xA24BAED4963EE407)


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64 avalanche, vectorized on uint64 (wrapping arithmetic)."""
    x = (x ^ (x >> np.uint64(30))) * _MIX1
    x = (x ^ (x >> np.uint64(27))) * _MIX2
    return x ^ (x >> np.uint64(31))


def graph_key(g: dict, *, wl_iters: int = WL_ITERS) -> bytes:
    """Canonical cache key for a graph dict {"adj": [n,n], "labels": [n]}.

    Node-order invariant: per-node WL colors are combined only through
    commutative multiset reductions (neighbor sums during refinement, a
    sorted color array and an endpoint-symmetric edge sum at the end), so
    `graph_key(g) == graph_key(permute(g))` for any node permutation
    applied consistently to adjacency and labels. Distinct labeled graphs
    differing in node count, label multiset, edge count or any WL-visible
    structure get distinct keys (up to 64-bit mixing collisions — the
    multiset sums are splitmix64-avalanched first, so colliding them is a
    birthday problem on 2^64, far below the blake2b payload's own floor).

    Fully vectorized numpy (one matrix-vector round per WL iteration,
    ~150µs per molecule-sized graph), and memoized on the dict itself under
    `"_graph_key"` — the same idiom as the generator's `avg_degree` /
    `density` annotations — so recurring corpus dicts are hashed once per
    process, not once per call. The memo assumes graphs are immutable once
    scored (the contract every cache needs anyway); `edit_graph` builds new
    dicts, so edits never inherit a stale key.
    """
    k = g.get("_graph_key")
    if k is not None:
        return k
    adj = np.asarray(g["adj"]) != 0
    labels = np.asarray(g["labels"], np.uint64)
    # Round 0: colors are the mixed raw node labels.
    colors = _mix(labels * _LBL + _SELF)
    for _ in range(wl_iters):
        # Multiset of neighbor colors as a wrapping sum of mixed values —
        # commutative, hence permutation invariant.
        nbr = (adj * _mix(colors * _NBR)[None, :]).sum(axis=1,
                                                       dtype=np.uint64)
        colors = _mix(colors * _SELF + nbr)
    r, c = np.nonzero(np.triu(adj))
    edge_sig = (_mix(colors[r] + colors[c]).sum(dtype=np.uint64)
                if len(r) else np.uint64(0))
    payload = (np.uint64(adj.shape[0]).tobytes()
               + np.uint64(int(adj.sum())).tobytes()
               + edge_sig.tobytes()
               + np.sort(colors).tobytes()
               + np.sort(labels).tobytes())
    k = _digest(payload)
    try:
        g["_graph_key"] = k
    except TypeError:            # immutable mapping: just skip the memo
        pass
    return k


def graph_fingerprint(g: dict) -> tuple:
    """Cheap structural fingerprint guarding `graph_key` collisions.

    `(n_nodes, n_edges, labels-digest)` — computable without WL refinement,
    memoized on the dict as `"_graph_fp"` (same immutability contract as
    the key memo). Two 1-WL-equivalent graphs get identical *embeddings*
    from this model family, so a WL collision is harmless by construction;
    this fingerprint exists for the failure mode the WL argument does NOT
    cover — a 64-bit mixing collision between structurally different
    graphs, where serving the cached row would be silently wrong.
    """
    fp = g.get("_graph_fp")
    if fp is not None:
        return fp
    adj = np.asarray(g["adj"])
    labels = np.asarray(g["labels"], np.int64)
    fp = (int(adj.shape[0]), int(np.count_nonzero(adj)) // 2,
          _digest(np.sort(labels).tobytes()))
    try:
        g["_graph_fp"] = fp
    except TypeError:            # immutable mapping: just skip the memo
        pass
    return fp


class EmbeddingCache:
    """LRU of per-graph `[F]` embeddings keyed by `graph_key`.

    `get` promotes on hit; `put` evicts the least-recently-used entry past
    `capacity`. `peek`/`__contains__` never touch recency — planning code
    uses them so inspecting a plan cannot reorder the cache. Stored arrays
    are returned as-is (callers must not mutate them; the engine stores
    read-only numpy copies).

    Collision guard: `put`/`get` accept an optional `graph_fingerprint`.
    When both the stored and the presented fingerprint exist and disagree,
    the key has COLLIDED across structurally different graphs — the entry
    is evicted and the lookup misses (`key_collisions` counts it, surfaced
    through `stats()` and `engine.health()`); a wrong embedding is never
    served. Fingerprint-less calls behave exactly as before.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self._store: OrderedDict[bytes, tuple[np.ndarray,
                                              tuple | None]] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.key_collisions = 0

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: bytes) -> bool:
        return key in self._store

    def peek(self, key: bytes) -> np.ndarray | None:
        """Recency- and stats-neutral lookup (the planner's view)."""
        entry = self._store.get(key)
        return entry[0] if entry is not None else None

    def get(self, key: bytes,
            fingerprint: tuple | None = None) -> np.ndarray | None:
        entry = self._store.get(key)
        if entry is None:
            self.misses += 1
            return None
        emb, fp = entry
        if (fingerprint is not None and fp is not None
                and fp != fingerprint):
            # WL-key collision between different structures: never serve
            # the wrong row — evict and report a miss so the caller
            # re-embeds (and re-puts under its own fingerprint).
            self.key_collisions += 1
            del self._store[key]
            self.misses += 1
            return None
        self._store.move_to_end(key)
        self.hits += 1
        return emb

    def put(self, key: bytes, emb: np.ndarray,
            fingerprint: tuple | None = None) -> None:
        if self.capacity == 0:
            return
        prev = self._store.get(key)
        if prev is not None:
            if (fingerprint is not None and prev[1] is not None
                    and prev[1] != fingerprint):
                self.key_collisions += 1
            self._store.move_to_end(key)
            self._store[key] = (emb, fingerprint)
            return
        self._store[key] = (emb, fingerprint)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._store.clear()

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"capacity": self.capacity, "size": len(self._store),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "key_collisions": self.key_collisions,
                "hit_rate": round(self.hit_rate, 4)}
