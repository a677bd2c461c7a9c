"""ScoringEngine — the dispatch point for SimGNN pair scoring; port of the
scoring half of `repro.core.engine` (DESIGN.md §9, §10, §12).

Paths (same names, `ScorePlan` fields and `reason` strings as the JAX
engine):

  reference      plain PyTorch `core.simgnn.pair_score`, bucketed; the
                 parity anchor and the terminal degradation rung.
  bucketed_mega  one `kernels/fused_pair` launch per size bucket; also the
                 oversize fallback and the choice for calls under
                 `MIN_PACK_PAIRS` pairs.
  packed_dense   FFD node-packed tiles, dense tile adjacency
                 (`kernels/packed_pair`).
  packed_sparse  packed tiles aggregated from the A' edge planes
                 (`kernels/sparse_pair`); auto's choice on sparse
                 (AIDS-like) streams.
  two_kernel     the embedding kernel (`kernels/fused_gcn`) on both sides
                 of each size bucket, then the head kernel
                 (`kernels/simgnn_head`); buckets through itself.
  embedding_cache
                 per-graph embeddings served from an LRU keyed by a
                 canonical graph hash (`core/cache.py`); only the misses
                 are embedded and only the head runs per pair. Auto takes
                 it when at least `CACHE_MIN_HIT_FRAC` of a call's unique
                 graphs are resident.

`plan()` quarantines invalid inputs (`core/validate.py`), measures the
call and decides (DESIGN.md §15). With `planner="measured"` (the default)
it argmins a per-path latency model ridge-fitted from the engine's trace
profile (`core/profile.py`) whenever every candidate path has
`PLANNER_MIN_SUPPORT` clean records; otherwise, and always with
`planner="threshold"`, it applies the threshold rules below, bit for bit.
Every executed work item appends a `TraceRecord` (path, shape stats, pack
occupancy, wall seconds from just before its ladder to the scores on the
host) to `self.recorder`. `score()` walks the degradation ladder
(`DEGRADE_LADDER`) on executor failure or non-finite scores, each
non-terminal rung guarded by a per-(path, shape-class) circuit breaker
(`core/health.py`). Every executor call goes through the `_FAULT_HOOK`
seam below (`repro_torch.testing.faults` arms it).

`loss_and_grad()` is the differentiable twin of `score()` (DESIGN.md §11):
it plans over `TRAIN_PATHS`, packs once, and runs the packed bodies of
`kernels/grad.py` (plain PyTorch with the JAX package's backward rules as
`torch.autograd.Function`s) in `TRAIN_TILE_CHUNK`-tile chunks, or the
plain reference, stepping down `TRAIN_DEGRADE_LADDER` on failure. No CUDA
kernel runs on that path (no Pallas kernel runs on the JAX package's), so
unlike the scoring ladder the train ladder keeps its `reference` rung on
the card.

Device-sharded scoring (DESIGN.md §16): with `runtime=` a
`distributed.sharding.Runtime` of N devices, `plan()` assigns a packed
call's tiles to `devices` of them (halved while a device would get fewer
than `MIN_PACK_PAIRS` pairs) and `score()` packs on the host and scores
each device's tile span there (`kernels.ops.score_tiles_sharded`), through
the fault site `sharded:<path>`. `loss_and_grad()` shards the same way:
each device runs the chunk loop over its span and the devices' losses and
grads are summed on the first device (`kernels.ops.grad_tiles_sharded`),
through the fault site `sharded:train:<path>`. A failing shard collapses
the call to the same path on one device before the ladder crosses paths:
the rungs are `path@Nd`, `path`, then `DEGRADE_LADDER` (or
`TRAIN_DEGRADE_LADDER`); counters, breakers and `degraded_from` name a
sharded rung `path@Nd`, as do the trace records' `n_devices` and the
planner's cost keys (`profile.cost_key`).

The device decides what runs, never a flag: on the card the embed stage
(`embed_graphs`), the head (`pair_scores_from_embeddings`) and the
prefilter (`prefilter_topm`) launch their CUDA kernels; on the CPU the same
wrappers run their plain versions. The JAX engine's `embed_with_kernels`
switch (jnp embedder or Pallas kernel) therefore has no counterpart.
Forced-reference engines stay kernel-free on either device.

On the card no plain version stands in for a failed kernel. The ladder
stops at its last kernel rung (`degrade_rungs`): an engine whose kernels
all fail raises rather than serve plain PyTorch scores, unless the caller
asked for path="reference". A failing head raises; a failing embed bucket
is dropped as NaN rows (counted in `errors:embed` and
`embed_dropped_graphs`) without the CPU's plain retry. A kernel-to-kernel
step is recorded in `degraded_from`, which `chip_smoke.py` treats as a
failed run.
"""

from __future__ import annotations

import time
from collections import Counter, OrderedDict
from dataclasses import dataclass, field, replace
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.cache import EmbeddingCache, graph_fingerprint, graph_key
from repro_torch.core.health import CircuitBreaker
from repro_torch.core.profile import (TraceRecorder, cost_key,
                                      fit_cost_model, trace_features)
from repro_torch.core.validate import GraphValidationError, validate_pairs
from repro_torch.device import resolve_device
from repro_torch.params import params_to, tree_leaves, tree_map

PATHS = ("reference", "two_kernel", "bucketed_mega", "packed_dense",
         "packed_sparse", "embedding_cache")
PACKED_PATHS = ("packed_dense", "packed_sparse")
#: paths with a differentiable executor (DESIGN.md §11): the plain
#: reference and the packed bodies of `kernels/grad.py`.
TRAIN_PATHS = ("reference", "packed_dense", "packed_sparse")

#: Graceful-degradation ladder (DESIGN.md §12): every rung computes the
#: same scores; the dense reference is terminal.
DEGRADE_LADDER = {
    "packed_sparse": ("packed_dense", "bucketed_mega", "reference"),
    "packed_dense": ("bucketed_mega", "reference"),
    "bucketed_mega": ("reference",),
    "two_kernel": ("bucketed_mega", "reference"),
    "embedding_cache": ("bucketed_mega", "reference"),
    "reference": (),
}
#: Training ladder: restricted to the differentiable executors (§11).
TRAIN_DEGRADE_LADDER = {
    "packed_sparse": ("packed_dense", "reference"),
    "packed_dense": ("reference",),
    "reference": (),
}


def _rung_name(path: str, devices: int) -> str:
    """Counter, breaker and cost-key name of a rung: the bare path on one
    device, `path@Nd` when it runs tile-sharded over N devices."""
    return path if devices <= 1 else f"{path}@{int(devices)}d"


def _rung_of(name: str) -> tuple[str, int]:
    """(path, devices) of a rung name (`_rung_name`'s inverse)."""
    path, _, nd = name.partition("@")
    return path, int(nd[:-1]) if nd else 1


def degrade_rungs(start: str, *, on_card: bool, degrade: bool = True,
                  devices: int = 1,
                  ladder: dict = DEGRADE_LADDER) -> tuple[str, ...]:
    """The rung names one work item may run on, `start` first. A start
    sharded over `devices` > 1 is followed by the same path on one device
    (a dead shard costs the mesh, never the batch), then the single-device
    `ladder`. On the card every scoring rung but the reference launches a
    kernel, so `on_card` leaves the reference out: a run whose kernels all
    fail raises instead of quietly serving plain PyTorch on the card."""
    steps = ladder.get(start, ()) if degrade else ()
    if on_card:
        steps = tuple(r for r in steps if r != "reference")
    if devices > 1 and degrade:
        steps = (start,) + steps
    return (_rung_name(start, devices),) + steps


#: Fault-injection seam: tests arm it with hook(site, thunk); production
#: leaves it None. Sites are the rung names.
_FAULT_HOOK: Callable | None = None


def _call(site: str, thunk: Callable):
    hook = _FAULT_HOOK
    return hook(site, thunk) if hook is not None else thunk()


class NonFiniteOutput(RuntimeError):
    """An executor produced NaN/Inf scores for inputs that passed
    validation — treated like a crash by the degradation ladder."""


def tree_all_finite(*trees) -> bool:
    """True iff every floating tensor (or array) leaf of the given trees is
    finite — the guard `train.step` uses to skip poisoned update steps."""
    for leaf in tree_leaves(trees):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf).all()):
                return False
        else:
            arr = np.asarray(leaf)
            if (np.issubdtype(arr.dtype, np.floating)
                    and not np.isfinite(arr).all()):
                return False
    return True


def _tree_add(a, b):
    """Leafwise a + b of two trees of one structure."""
    it = iter(tree_leaves(b))
    return tree_map(lambda x: x + next(it), a)


def _zeros_like_tree(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _empty_idx() -> np.ndarray:
    return np.empty(0, np.int64)


@dataclass(frozen=True)
class WorkloadStats:
    """Measured properties of one score() call's pairs."""
    n_pairs: int
    max_nodes: int = 0
    mean_nodes: float = 0.0
    avg_degree: float = 0.0      # 2E/V over all graphs (self loops excluded)
    density: float = 0.0         # nnz / sum(n_i^2)
    has_labels: bool = True      # every graph carries int node labels


@dataclass(frozen=True)
class ScorePlan:
    """An inspectable dispatch decision for one batch of pairs (fields as
    in the JAX engine). `path` scores the pairs at `fit_idx`; pairs at
    `over_idx` run on `fallback` through power-of-two size buckets.
    After execution `last_plan` carries `degraded_from` (rungs that failed
    or were breaker-rejected, in order) and `attempts` (executor
    invocations tried). On the embedding-cached path `graph_keys` holds the
    canonical key of every graph the plan covers (all lhs, then all rhs),
    `cached_idx` the positions already resident and `to_embed_idx` the
    first occurrence of each uncached key. `cost_estimates` holds the
    predicted wall seconds per candidate when the fitted cost model drove
    the decision (empty when the threshold rules did); `devices` is the
    count of mesh devices the call's packed tiles go to (1 without a
    runtime and on unpacked paths)."""
    path: str
    fallback: str
    fit_idx: np.ndarray
    over_idx: np.ndarray
    stats: WorkloadStats
    reason: str
    cached_idx: np.ndarray = field(default_factory=_empty_idx)
    to_embed_idx: np.ndarray = field(default_factory=_empty_idx)
    graph_keys: tuple = ()
    quarantined: tuple = ()
    degraded_from: tuple = ()
    attempts: int = 1
    prefilter_m: int = 0
    devices: int = 1
    cost_estimates: dict = field(default_factory=dict)


class ScoringEngine:
    """Single dispatch point from graph-pair batches to scores, on
    `device` (None = the card; raises without CUDA unless "cpu")."""

    #: densest stream the edge-centric kernel should take.
    SPARSE_MAX_DEGREE = 4.0
    #: below this many pairs packing cannot fill a tile.
    MIN_PACK_PAIRS = 4
    #: auto takes the embedding-cached path when at least this fraction of
    #: a call's unique graphs already have resident embeddings.
    CACHE_MIN_HIT_FRAC = 0.5
    #: tiles per backward chunk on the packed training paths: the chunk
    #: loop is both cache blocking and gradient accumulation.
    TRAIN_TILE_CHUNK = 16
    #: measured planner: a candidate needs this many clean trace records
    #: before the cost model may steer it.
    PLANNER_MIN_SUPPORT = 8
    #: refit the cost model after this many new records.
    PLANNER_REFIT_EVERY = 32

    def __init__(self, params, cfg, *, path: str = "auto",
                 node_budget: int | None = None,
                 edge_budget: int | None = None,
                 cache_size: int = 4096,
                 validation: str = "lenient",
                 degrade: bool = True,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 recorder: TraceRecorder | None = None,
                 planner: str = "measured",
                 runtime=None,
                 grad_fn=None,
                 device=None):
        if path != "auto" and path not in PATHS:
            raise ValueError(f"unknown path {path!r}; expected 'auto' or one "
                             f"of {PATHS}")
        if validation not in ("strict", "lenient", "off"):
            raise ValueError(f"unknown validation mode {validation!r}; "
                             "expected 'strict', 'lenient' or 'off'")
        if planner not in ("measured", "threshold"):
            raise ValueError(f"unknown planner mode {planner!r}; expected "
                             "'measured' or 'threshold'")
        from repro_torch.kernels.ops import packed_node_budget

        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        #: the tile mesh (`distributed.sharding.Runtime`); None, or a
        #: mesh-less runtime, keeps every path on `device` alone.
        self.runtime = runtime
        self.n_devices = (int(runtime.n_devices)
                          if runtime is not None else 1)
        if self.n_devices > 1 and runtime.mesh.kind != self.device.type:
            raise ValueError(
                f"runtime mesh on {runtime.mesh.kind} devices, engine on "
                f"{self.device.type}")
        #: (key, float32 params on each device of the mesh, the leaves
        #: they were made from) for sharded scoring
        #: (`kernels.ops.shard_params`); rebuilt when `params` changes.
        self._shard_params: tuple | None = None
        self.cfg = cfg
        self.path = path
        self.node_budget = (packed_node_budget(cfg.max_nodes)
                            if node_budget is None else node_budget)
        self.edge_budget = edge_budget
        self._bucket_flavor = (path if path in ("reference", "two_kernel")
                               else "bucketed_mega")
        #: per-graph embedding LRU (DESIGN.md §10); capacity 0 disables it.
        self.cache = EmbeddingCache(cache_size)
        #: per-bucket scoring callables, built lazily (`_bucket_fn`).
        self.bucket_fns: dict = {}
        self.last_pack_stats: dict | None = None
        self.last_plan: ScorePlan | None = None
        #: realized COO overflow budget of past sparse packs, the floor of
        #: later packs (stable [T, E_ov] shapes across a stream).
        self._overflow_floor: int = 8
        self.validation = validation
        self.degrade = degrade
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self._clock = clock
        self.breakers: dict[tuple, CircuitBreaker] = {}
        self.counters: Counter = Counter()
        #: value-and-grad executors, one per (train path, chunk tiles,
        #: device count, gradient-function kind).
        self._train_fns: dict[tuple, Callable] = {}
        #: the swappable gradient-function object (`train/sgf.py`).
        if grad_fn is None:
            from repro_torch.train.sgf import StandardGradient
            grad_fn = StandardGradient()
        self.grad_fn = grad_fn
        #: per-call trace ring (+ optional JSONL profile) every executed
        #: work item appends to; a shared recorder pools several engines'
        #: samples.
        self.recorder = TraceRecorder(clock=clock) if recorder is None \
            else recorder
        #: "measured": the fitted cost model when every candidate has
        #: support, else the threshold rules; "threshold": always the rules.
        self.planner = planner
        self._model = None
        self._model_fit_at = -1

    # ------------------------------------------------------------- planning

    def workload_stats(self, pairs: Sequence[tuple], *,
                       measure_density: bool = True) -> WorkloadStats:
        """Measure the dispatch inputs from the raw pair dicts (host)."""
        if not pairs:
            return WorkloadStats(0)
        sizes: list[int] = []
        nnz = 0.0
        cells = 0.0
        has_labels = True
        for g1, g2 in pairs:
            for g in (g1, g2):
                n = g["adj"].shape[0]
                sizes.append(n)
                if measure_density:
                    nnz += float(np.count_nonzero(g["adj"]))
                    cells += n * n
                has_labels = has_labels and "labels" in g
        nodes = sum(sizes)
        return WorkloadStats(
            n_pairs=len(pairs), max_nodes=max(sizes),
            mean_nodes=nodes / len(sizes),
            avg_degree=nnz / max(nodes, 1), density=nnz / max(cells, 1.0),
            has_labels=has_labels)

    def _select(self, stats: WorkloadStats, cache_hit_frac: float = 0.0, *,
                train: bool = False, n_to_embed: int = 0,
                keys_known: bool = False) -> tuple[str, str, dict]:
        """Dispatch decision (path, reason, cost_estimates). Forced paths,
        empty calls and label-free batches are structural; otherwise the
        measured planner argmins the fitted cost model when every candidate
        has support, and a cold or partial profile falls back bit for bit
        to `_select_threshold`."""
        if self.path != "auto":
            if train and self.path not in TRAIN_PATHS:
                raise ValueError(
                    f"path {self.path!r} has no VJP-capable executor; "
                    f"training dispatch is restricted to {TRAIN_PATHS} "
                    "(DESIGN.md §11)")
            return self.path, f"forced path={self.path}", {}
        if stats.n_pairs == 0:
            return "reference", "empty call", {}
        if not stats.has_labels:
            return (("reference" if train else "bucketed_mega"),
                    "graphs without int labels cannot take a packed path",
                    {})
        est = self._planner_estimates(stats, train=train,
                                      n_to_embed=n_to_embed,
                                      keys_known=keys_known)
        if est is not None:
            # Deterministic tie-break: predicted cost, then PATHS order.
            path = min(est, key=lambda p: (est[p], PATHS.index(p)))
            ms = ", ".join(f"{p}={est[p] * 1e3:.2f}ms"
                           for p in sorted(est, key=est.get))
            return (path, f"measured cost model argmin ({ms})", est)
        path, reason = self._select_threshold(stats, cache_hit_frac,
                                              train=train)
        return path, reason, {}

    def _select_threshold(self, stats: WorkloadStats,
                          cache_hit_frac: float = 0.0, *,
                          train: bool = False) -> tuple[str, str]:
        """The threshold rules: the cold-profile fallback, and the whole
        decision under `planner="threshold"`."""
        if not train and cache_hit_frac >= self.CACHE_MIN_HIT_FRAC:
            return ("embedding_cache",
                    f"{cache_hit_frac:.0%} of unique graphs have resident "
                    f"embeddings (>= {self.CACHE_MIN_HIT_FRAC:.0%}): only "
                    "the NTN+FCN head runs")
        if stats.n_pairs < self.MIN_PACK_PAIRS:
            return (("reference" if train else "bucketed_mega"),
                    f"batch of {stats.n_pairs} too small to fill packed tiles"
                    f" (< {self.MIN_PACK_PAIRS})")
        if stats.avg_degree <= self.SPARSE_MAX_DEGREE:
            return ("packed_sparse",
                    f"measured avg degree {stats.avg_degree:.2f} <= "
                    f"{self.SPARSE_MAX_DEGREE:g}: edge list beats dense "
                    "adjacency")
        return ("packed_dense",
                f"measured avg degree {stats.avg_degree:.2f} > "
                f"{self.SPARSE_MAX_DEGREE:g}: dense MXU matmul wins")

    # ------------------------------------------ measured planner (§15)

    def _cost_model(self):
        """The fitted per-path latency model, refit lazily every
        `PLANNER_REFIT_EVERY` new records (None while the profile is too
        small for even one path)."""
        rec = self.recorder
        if rec is None or rec.total_records < self.PLANNER_MIN_SUPPORT:
            return self._model
        if (self._model_fit_at < 0
                or rec.total_records - self._model_fit_at
                >= self.PLANNER_REFIT_EVERY):
            self._model = fit_cost_model(
                rec.records(), min_support=self.PLANNER_MIN_SUPPORT)
            self._model_fit_at = rec.total_records
            self.counters["planner_refits"] += 1
        return self._model

    def _planner_estimates(self, stats: WorkloadStats, *, train: bool,
                           n_to_embed: int, keys_known: bool) -> dict | None:
        """Predicted wall seconds per candidate path, or None when the
        profile cannot steer this call (threshold planner, no model yet, or
        any candidate below `PLANNER_MIN_SUPPORT`: partial support falls
        back whole). Candidates: the bucketed and both packed scoring paths
        (plus the embedding-cached path when this call hashed keys), or
        `TRAIN_PATHS` under train, keyed `train:<path>` (with the device
        count, as scoring's keys)."""
        if self.planner != "measured":
            return None
        model = self._cost_model()
        if model is None:
            return None
        # Keys carry the device count the planner would assign
        # (`profile.cost_key`): a sharded wall never predicts a
        # single-device call, nor the other way round.
        if train:
            cand = {p: cost_key(f"train:{p}", self._plan_devices(p, stats))
                    for p in TRAIN_PATHS}
        else:
            cand = {p: cost_key(p, self._plan_devices(p, stats))
                    for p in ("bucketed_mega", "packed_dense",
                              "packed_sparse")}
            if keys_known:
                cand["embedding_cache"] = "embedding_cache"
        if not model.supports(cand.values()):
            return None
        est = {}
        for path, key in cand.items():
            feats = trace_features(
                stats.n_pairs, stats.mean_nodes, stats.avg_degree,
                n_to_embed if path == "embedding_cache" else 0)
            est[path] = model.predict(key, feats)
        return est

    def _plan_devices(self, path: str, stats: WorkloadStats) -> int:
        """Mesh devices a call's packed tiles go to: only the packed paths
        shard, and the count halves until each device gets at least
        `MIN_PACK_PAIRS` pairs (a 3-pair call on 8 devices runs on one)."""
        nd = self.n_devices
        if nd <= 1 or path not in PACKED_PATHS:
            return 1
        while nd > 1 and stats.n_pairs < nd * self.MIN_PACK_PAIRS:
            nd //= 2
        return max(nd, 1)

    def _record_trace(self, kind: str, path: str, n_pairs: int,
                      plan: ScorePlan, wall_s: float, *,
                      degraded: Sequence[str] = (), attempts: int = 1,
                      n_devices: int = 1):
        """Append one executed work item to the trace ring, through the
        fault seam (site "profile") and guarded: a failing recorder never
        fails the call it observes."""
        rec = self.recorder
        if rec is None:
            return
        pstats = self.last_pack_stats or {}
        occ = (float(pstats.get("occupancy_lhs", 0.0)
                     + pstats.get("occupancy_rhs", 0.0)) / 2.0
               if pstats else 0.0)
        try:
            _call("profile", lambda: rec.record(
                kind=kind, path=path, n_pairs=int(n_pairs),
                max_nodes=plan.stats.max_nodes,
                mean_nodes=plan.stats.mean_nodes,
                avg_degree=plan.stats.avg_degree,
                density=plan.stats.density, occupancy=occ,
                to_embed=len(plan.to_embed_idx),
                degraded_from=list(degraded), attempts=int(attempts),
                wall_s=float(wall_s), n_devices=int(n_devices)))
        except Exception:
            self.counters["profile_record_errors"] += 1

    def plan(self, pairs: Sequence[tuple], *,
             train: bool = False) -> ScorePlan:
        """Validate, measure and decide — without running anything.
        Quarantined pairs appear only in `plan.quarantined`; strict mode
        raises instead. With `train=True` the decision is restricted to
        `TRAIN_PATHS`: the cache never steers, small and label-free batches
        land on the reference, and so does the oversize split."""
        n = len(pairs)
        quarantined: tuple = ()
        valid_idx = np.arange(n, dtype=np.int64)
        if self.validation != "off" and n:
            valid_idx, quarantined = validate_pairs(
                pairs, n_labels=self.cfg.n_node_labels)
            if quarantined and self.validation == "strict":
                raise GraphValidationError(quarantined)
        valid = (pairs if len(valid_idx) == n
                 else [pairs[i] for i in valid_idx])
        stats = self.workload_stats(
            valid, measure_density=self.path in ("auto", "packed_sparse"))
        # Keys are hashed only when the cache could hold answers: the path
        # is forced to the cached one, or auto sees a non-empty cache.
        # Training never hashes: no path it may pick reads the cache.
        keys: tuple = ()
        hit_frac = 0.0
        n_to_embed = 0
        if not train and len(valid) and stats.has_labels \
                and self.cache.capacity > 0 and (
                self.path == "embedding_cache"
                or (self.path == "auto" and len(self.cache))):
            keys = self._graph_keys(valid)
            unique = set(keys)
            hits = sum(1 for k in unique if k in self.cache)
            hit_frac = hits / len(unique)
            n_to_embed = len(unique) - hits
        path, reason, est = self._select(stats, hit_frac, train=train,
                                         n_to_embed=n_to_embed,
                                         keys_known=bool(keys))
        cached_idx = to_embed_idx = np.empty(0, np.int64)
        if path == "embedding_cache" and keys:
            hit = [k in self.cache for k in keys]
            cached_idx = np.flatnonzero(hit)
            first = {k: i for i, k in reversed(list(enumerate(keys)))}
            to_embed_idx = np.asarray(
                sorted(i for k, i in first.items() if not hit[i]), np.int64)
        if path in PACKED_PATHS:
            fits = np.asarray([max(g1["adj"].shape[0], g2["adj"].shape[0])
                               <= self.node_budget for g1, g2 in valid], bool)
            fit_idx = valid_idx[np.flatnonzero(fits)]
            over_idx = valid_idx[np.flatnonzero(~fits)]
        elif path == "embedding_cache":
            # The embed stage buckets with power-of-two oversize buckets,
            # so nothing is oversized for this path.
            fit_idx = valid_idx
            over_idx = np.empty(0, np.int64)
        else:
            fit_idx = np.empty(0, np.int64)
            over_idx = valid_idx
        fallback = "reference" if train else self._bucket_flavor
        return ScorePlan(path=path, fallback=fallback,
                         fit_idx=fit_idx, over_idx=over_idx, stats=stats,
                         reason=reason, cached_idx=cached_idx,
                         to_embed_idx=to_embed_idx, graph_keys=keys,
                         quarantined=quarantined, cost_estimates=est,
                         devices=self._plan_devices(path, stats))

    def _graph_keys(self, pairs: Sequence[tuple]) -> tuple:
        """Canonical keys of every graph in the call: all lhs, then all rhs
        (the order `ScorePlan.cached_idx`/`to_embed_idx` index). Each
        distinct graph object is hashed once per call."""
        memo: dict[int, bytes] = {}

        def key_of(g: dict) -> bytes:
            k = memo.get(id(g))
            if k is None:
                k = memo[id(g)] = graph_key(g)
            return k
        return tuple(key_of(p[side]) for side in (0, 1) for p in pairs)

    # ------------------------------------------------------------ execution

    def _bucket_fn(self, bucket: int, flavor: str) -> Callable:
        """The scoring callable of one size bucket, cached on the engine:
        keyed by the bucket for the engine's own flavor (the JAX engine's
        `bucket_fns` contract) and by (flavor, bucket) for the flavors the
        ladder steps down to."""
        key = bucket if flavor == self._bucket_flavor else (flavor, bucket)
        if key not in self.bucket_fns:
            from repro_torch.core.simgnn import pair_score
            from repro_torch.kernels import ops

            if flavor == "reference":
                self.bucket_fns[key] = pair_score
            elif flavor == "two_kernel":
                self.bucket_fns[key] = (
                    lambda params, *arrays: ops.simgnn_pair_score_kernel(
                        params, *arrays, device=self.device))
            else:
                self.bucket_fns[key] = (
                    lambda params, *arrays: ops.pair_score_megakernel(
                        params, *arrays, device=self.device))
        return self.bucket_fns[key]

    def _score_bucketed(self, pairs, idx: np.ndarray, out: np.ndarray,
                        flavor: str | None = None):
        from repro_torch.core.batching import bucket_pairs

        flavor = flavor or self._bucket_flavor
        for bucket, (lhs, rhs, idxs) in bucket_pairs(
                pairs, self.cfg.n_node_labels, allow_oversize=True,
                device=self.device).items():
            fn = self._bucket_fn(bucket, flavor)
            s = _call(flavor, lambda fn=fn, lhs=lhs, rhs=rhs: fn(
                self.params, lhs.adj, lhs.feats, lhs.mask,
                rhs.adj, rhs.feats, rhs.mask))
            out[idx[idxs]] = s.detach().cpu().numpy()

    def _score_packed(self, pairs, idx: np.ndarray, out: np.ndarray,
                      sparse: bool, stats: WorkloadStats, devices: int = 1):
        """Packed scoring, on the engine's device, or with the tile axis
        split over the first `devices` mesh devices: then the batch is
        packed on the host, each device's tile span is scored there and the
        [T, P] scores are gathered, under the fault site `sharded:<path>`,
        and `last_pack_stats` adds the plan's `devices`, `tiles`,
        `tiles_padded` and each device's live share of its span
        (`device_occupancy`; pad tiles sit at the end), the JAX engine's
        numbers."""
        from repro_torch.core.batching import pack_pairs, unpack_pair_scores
        from repro_torch.kernels import ops

        path = "packed_sparse" if sparse else "packed_dense"
        slots = max(8, self.node_budget // 4)
        # a sharded call packs on the host: each shard copies its own span
        where = self.device if devices == 1 else torch.device("cpu")
        if sparse:
            packed, pstats = self._pack_sparse(pairs, slots, stats.avg_degree,
                                               device=where)
        else:
            packed, pstats = pack_pairs(pairs, self.node_budget,
                                        slots_per_tile=slots, device=where)
        if devices == 1:
            score = ops.pair_score_sparse if sparse else ops.pair_score_packed
            s = _call(path, lambda: score(self.params, packed,
                                          device=self.device))
        else:
            mesh = self.runtime.mesh
            s, target = _call(f"sharded:{path}",
                              lambda: ops.score_packed_sharded(
                                  packed, self._mesh_params(mesh),
                                  mesh.first(devices), sparse=sparse))
            t = packed.mask1.shape[0]
            pstats = dict(pstats, devices=devices, tiles=t,
                          tiles_padded=target, device_occupancy=[
                              (hi - lo) / (target // devices) for lo, hi in
                              ops.shard_spans(t, target, devices)])
        self.last_pack_stats = pstats
        out[idx] = unpack_pair_scores(s, packed, len(pairs))

    def _mesh_params(self, mesh) -> dict:
        """`self.params` as float32 on each device of `mesh`, made once per
        params tree: keyed by the identity and version of every leaf (the
        weight images' rule), so replacing or updating `params` in place
        rebuilds them. The entry holds the leaves, so no key's ids can be
        reused."""
        from repro_torch.kernels import ops

        leaves = tree_leaves(self.params)
        key = (tuple(str(d) for d in mesh.devices),) + tuple(
            (id(t), t._version) for t in leaves)
        if self._shard_params is None or self._shard_params[0] != key:
            self._shard_params = (key, ops.shard_params(self.params, mesh),
                                  leaves)
        return self._shard_params[1]

    def _pack_sparse(self, pairs, slots: int, avg_degree: float,
                     device=None):
        """Sparse packing on `device` (default the engine's): ladder-sized
        edge budget, with the realized overflow budget of earlier calls as
        the floor."""
        from repro_torch.core.batching import pack_pairs
        from repro_torch.kernels import ops

        edge_budget = self.edge_budget
        if edge_budget is None:
            edge_budget = ops.packed_edge_budget(self.node_budget, avg_degree)
        packed, pstats = pack_pairs(pairs, self.node_budget,
                                    slots_per_tile=slots, with_edges=True,
                                    edge_budget=edge_budget,
                                    overflow_budget=self._overflow_floor,
                                    device=device or self.device)
        self._overflow_floor = max(self._overflow_floor,
                                   pstats["overflow_budget"])
        return packed, pstats

    # ------------------------------------- degradation + breakers (§12)

    def _shape_class(self, stats: WorkloadStats) -> tuple:
        """Power-of-two (batch, nodes) bucket a breaker is keyed on."""
        from repro_torch.core.batching import next_pow2

        return (next_pow2(max(stats.n_pairs, 1), floor=1),
                next_pow2(max(stats.max_nodes, 1), floor=8))

    def _breaker(self, path: str, shape_class: tuple) -> CircuitBreaker:
        key = (path, shape_class)
        br = self.breakers.get(key)
        if br is None:
            br = self.breakers[key] = CircuitBreaker(
                failure_threshold=self.breaker_threshold,
                cooldown_s=self.breaker_cooldown_s, clock=self._clock)
        return br

    def _execute_rung(self, rung: str, devices: int, sub, idx: np.ndarray,
                      out: np.ndarray, plan: ScorePlan):
        if rung in PACKED_PATHS:
            self._score_packed(sub, idx, out, rung == "packed_sparse",
                               plan.stats, devices)
        elif rung == "embedding_cache":
            self._score_cached(sub, idx, out, plan)
        else:
            self._score_bucketed(sub, idx, out, flavor=rung)

    def _run_score_ladder(self, start: str, sub, idx: np.ndarray,
                          out: np.ndarray, plan: ScorePlan
                          ) -> tuple[int, list, str, int]:
        """Execute one work item from `start`, stepping down the ladder
        (`degrade_rungs`) when a rung raises or emits non-finite scores.
        Each non-terminal rung has its own breaker, a sharded rung apart
        from its single-device twin. Returns (attempts, degraded rung
        names, the path that served, the devices it served on); re-raises
        only if every rung failed."""
        rungs = degrade_rungs(
            start, on_card=self.device.type == "cuda", degrade=self.degrade,
            devices=plan.devices if start == plan.path else 1)
        sc = self._shape_class(plan.stats)
        degraded: list[str] = []
        attempts = 0
        last_err: Exception | None = None
        for name in rungs:
            rung, nd = _rung_of(name)
            terminal = rung == "reference"
            br = None if terminal else self._breaker(name, sc)
            if br is not None and not br.allow():
                self.counters[f"breaker_rejected:{name}"] += 1
                degraded.append(name)
                continue
            attempts += 1
            try:
                self._execute_rung(rung, nd, sub, idx, out, plan)
                if not terminal and not np.isfinite(out[idx]).all():
                    raise NonFiniteOutput(
                        f"{name} produced non-finite scores for validated "
                        "inputs")
                if br is not None:
                    br.record_success()
                return attempts, degraded, rung, nd
            except Exception as exc:
                if br is not None:
                    br.record_failure()
                self.counters[f"errors:{name}"] += 1
                degraded.append(name)
                last_err = exc
                if rung in PACKED_PATHS:
                    self.last_pack_stats = None
        raise last_err if last_err is not None else RuntimeError(
            f"no executable rung for {start} (ladder exhausted)")

    def health(self) -> dict:
        """Breaker snapshots keyed by path and shape class, the error /
        degradation / quarantine counters, the embedding-LRU counters and
        the measured planner (profile size, fitted model support and
        residuals)."""
        rec = self.recorder
        planner: dict = {"mode": self.planner,
                         "enabled": self._model is not None
                         and bool(self._model.weights)}
        if rec is not None:
            planner.update(records=rec.total_records,
                           records_dropped=int(
                               rec.counters["records_dropped"]),
                           record_errors=int(rec.counters["record_errors"]))
        if self._model is not None:
            planner["model"] = self._model.snapshot()
        return {
            "breakers": {
                f"{path}[pairs<={b},nodes<={n}]": br.snapshot()
                for (path, (b, n)), br in sorted(self.breakers.items())},
            "counters": dict(self.counters),
            "cache": self.cache.stats(),
            "planner": planner,
        }

    # -------------------------------------------------------- training path

    def _sync(self) -> None:
        """Wait for the card (no-op on the CPU): a recorded wall covers the
        device work, not just its launches."""
        if self._on_card():
            torch.cuda.synchronize(self.device)

    def _train_fn(self, path: str, chunk_tiles: int,
                  devices: int = 1) -> Callable:
        """One value-and-grad executor per (train path, chunk tiles, device
        count, gradient-function kind), cached on the engine. It maps
        (params, targets, *arrays) -> (sum of squared errors, grads like
        params), looping over `chunk_tiles`-tile chunks of the packed batch
        with the grads summed in the loop (cache blocking and accumulation
        microbatching in one mechanism: the batch is packed once and only
        the slice moves). The loss -> (value, grads) transform is the
        engine's `grad_fn` object, applied per chunk. With `devices > 1`
        each of the first `devices` mesh devices runs the chunk loop over
        its span of the tile axis and the devices' losses and grads are
        summed on the first one (`kernels.ops.grad_tiles_sharded`), outside
        the grad object: per-chunk transforms (clipping) act before the
        cross-device sum, as the JAX engine's `psum` over its scan."""
        key = (path, chunk_tiles, devices, self.grad_fn.cache_key)
        if key not in self._train_fns:
            if path == "reference":
                from repro_torch.core.simgnn import pair_score_from_labels

                def sse(params, tgt, *arrays):
                    return torch.sum(
                        (pair_score_from_labels(params, *arrays) - tgt) ** 2)
            else:
                from repro_torch.kernels import grad as kgrad

                score_fn = (kgrad.sparse_pair_score_grad
                            if path == "packed_sparse"
                            else kgrad.packed_pair_score_grad)

                def sse(params, tgt, *arrays):
                    # Pad pair slots score exact zero against target zero.
                    return torch.sum((score_fn(params, *arrays) - tgt) ** 2)

            grad_fn = self.grad_fn.value_and_grad(sse)
            if path == "reference":
                fn = grad_fn
            else:
                def fn(params, tgt, *arrays):
                    n_chunks = tgt.shape[0] // chunk_tiles
                    if n_chunks <= 1:
                        return grad_fn(params, tgt, *arrays)
                    acc = (torch.zeros((), dtype=torch.float32,
                                       device=tgt.device),
                           _zeros_like_tree(params))
                    for c in range(n_chunks):
                        sl = slice(c * chunk_tiles, (c + 1) * chunk_tiles)
                        s, g = grad_fn(params, tgt[sl],
                                       *(x[sl] for x in arrays))
                        acc = (acc[0] + s, _tree_add(acc[1], g))
                    return acc
                if devices > 1:
                    from repro_torch.kernels import ops

                    mesh = self.runtime.mesh.first(devices)
                    scan = fn

                    def fn(params, tgt, *arrays):
                        return ops.grad_tiles_sharded(scan, params, tgt,
                                                      arrays, mesh)
            self._train_fns[key] = fn
        return self._train_fns[key]

    def _packed_sse(self, params, fit_pairs, fit_targets: np.ndarray,
                    plan: ScorePlan, accum_steps: int,
                    path: str | None = None, devices: int = 1):
        """Sum of squared errors and grads of the packed fit split: pack
        once, scatter the targets to the [T, P] pair slots, pad the tile
        axis to a chunk multiple (pad tiles are all zero: exact-zero
        scores, targets and grads) and run the chunk loop under the fault
        site `train:<path>`. With `devices > 1` the batch is packed on the
        host, T pads to a multiple of `devices` chunks, each device loops
        over its span (a span of pad tiles only runs nothing) and
        `last_pack_stats` adds `devices`, `tiles` and `tiles_padded`, under
        the fault site `sharded:train:<path>`."""
        from repro_torch.core.batching import next_pow2, pack_pairs
        from repro_torch.kernels import grad as kgrad

        path = plan.path if path is None else path
        sparse = path == "packed_sparse"
        slots = max(8, self.node_budget // 4)
        # a sharded call packs on the host: each shard copies its own span
        where = self.device if devices == 1 else torch.device("cpu")
        if sparse:
            packed, pstats = self._pack_sparse(fit_pairs, slots,
                                               plan.stats.avg_degree,
                                               device=where)
        else:
            packed, pstats = pack_pairs(fit_pairs, self.node_budget,
                                        slots_per_tile=slots, device=where)
        self.last_pack_stats = pstats

        pair_mask = packed.pair_mask.cpu().numpy()
        pair_index = packed.pair_index.cpu().numpy()
        tgt = np.zeros(pair_mask.shape, np.float32)
        live = pair_mask > 0
        tgt[live] = fit_targets[pair_index[live]]

        # A chunk small enough that accum_steps chunks exist and that
        # padding never exceeds the batch itself; T pads to a chunk
        # multiple (less than one chunk of pad tiles), or to a multiple of
        # `devices` chunks, so that every device loops over whole chunks
        # of its span.
        t = pair_mask.shape[0]
        chunk_tiles = min(self.TRAIN_TILE_CHUNK, next_pow2(t, floor=1))
        while chunk_tiles > 1 and (-(-t // chunk_tiles)) < accum_steps:
            chunk_tiles //= 2
        pad = (-t) % (chunk_tiles * devices)

        def pad_tiles(x):
            if not pad:
                return x
            return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

        arrays = tuple(pad_tiles(x)
                       for x in kgrad.packed_arrays(packed, sparse=sparse))
        if devices > 1:
            self.last_pack_stats = dict(pstats, devices=devices, tiles=t,
                                        tiles_padded=t + pad)
        fn = self._train_fn(path, chunk_tiles, devices)
        tgt_t = pad_tiles(torch.from_numpy(tgt).to(where))
        site = f"sharded:train:{path}" if devices > 1 else f"train:{path}"
        return _call(site, lambda: fn(params, tgt_t, *arrays))

    def _reference_sse(self, params, pairs, targets: np.ndarray):
        """SSE and grads of the plain reference executor (the train-mode
        fallback for oversized pairs and small batches), bucketed like
        `_score_bucketed` with power-of-two oversize buckets."""
        from repro_torch.core.batching import bucket_pairs

        fn = self._train_fn("reference", 1)
        sse = torch.zeros((), dtype=torch.float32, device=self.device)
        grads = _zeros_like_tree(params)
        for _, (lhs, rhs, idxs) in bucket_pairs(
                pairs, self.cfg.n_node_labels, allow_oversize=True,
                device=self.device).items():
            tgt = torch.from_numpy(targets[idxs]).to(self.device)
            s, g = _call("train:reference",
                         lambda lhs=lhs, rhs=rhs, tgt=tgt: fn(
                             params, tgt, lhs.adj, lhs.labels, lhs.mask,
                             rhs.adj, rhs.labels, rhs.mask))
            sse = sse + s
            grads = _tree_add(grads, g)
        return sse, grads

    def _run_train_ladder(self, start: str, params, sub, tgt: np.ndarray,
                          plan: ScorePlan, accum_steps: int) -> tuple:
        """Training twin of `_run_score_ladder`: walk `degrade_rungs` over
        `TRAIN_DEGRADE_LADDER` (the reference kept on the card too: no
        train rung launches a kernel), breaker-gated per (train:rung,
        shape class); a sharded start collapses to its one-device twin
        before crossing paths. Non-terminal rungs that emit a non-finite
        loss or grads for finite targets fail like crashes; the reference
        serves whatever it computes. Returns (sse, grads, attempts,
        degraded, the path that served, the devices it served on)."""
        rungs = degrade_rungs(
            start, on_card=False, degrade=self.degrade,
            devices=plan.devices if start == plan.path else 1,
            ladder=TRAIN_DEGRADE_LADDER)
        sc = self._shape_class(plan.stats)
        degraded: list[str] = []
        attempts = 0
        last_err: Exception | None = None
        for name in rungs:
            rung, nd = _rung_of(name)
            terminal = rung == "reference"
            br = None if terminal else self._breaker(f"train:{name}", sc)
            if br is not None and not br.allow():
                self.counters[f"breaker_rejected:train:{name}"] += 1
                degraded.append(name)
                continue
            attempts += 1
            try:
                if rung in PACKED_PATHS:
                    s, g = self._packed_sse(params, sub, tgt, plan,
                                            accum_steps, path=rung,
                                            devices=nd)
                else:
                    s, g = self._reference_sse(params, sub, tgt)
                if not terminal and not tree_all_finite(s, g):
                    raise NonFiniteOutput(
                        f"train:{name} produced non-finite loss/grads for "
                        "finite targets")
                if br is not None:
                    br.record_success()
                return s, g, attempts, degraded, rung, nd
            except Exception as exc:
                if br is not None:
                    br.record_failure()
                self.counters[f"errors:train:{name}"] += 1
                degraded.append(name)
                last_err = exc
                if rung in PACKED_PATHS:
                    self.last_pack_stats = None
        raise last_err if last_err is not None else RuntimeError(
            f"no executable train rung for {start} (ladder exhausted)")

    def loss_and_grad(self, pairs: Sequence[tuple], targets, *,
                      params=None, accum_steps: int = 1):
        """MSE loss and parameter gradients for one batch of graph pairs,
        the differentiable twin of `score()` (DESIGN.md §11).

        Plans over `TRAIN_PATHS` with the oversize split going to the
        reference. The packed paths pack once and always loop over
        `TRAIN_TILE_CHUNK`-tile chunks; `accum_steps` (a power of two)
        guarantees at least that many chunks. Non-finite targets are
        dropped before planning (counted in `nonfinite_targets`), invalid
        graphs are quarantined, and each work item walks
        `TRAIN_DEGRADE_LADDER` and lands a `train:<rung>` trace record with
        the devices it ran on. The loss is normalised by the pairs actually
        scored. On an engine with a runtime of N devices the packed split
        runs tile-sharded over the plan's `devices` (`_train_fn`).

        `params` defaults to the engine's own; a training loop passes its
        evolving copy, which every call reads (sharded calls too). Returns
        (loss, grads): a float32 scalar tensor and a float32 tree like
        params, on the engine's device."""
        if accum_steps < 1 or accum_steps & (accum_steps - 1):
            raise ValueError(f"accum_steps must be a power of two, got "
                             f"{accum_steps}")
        params = self.params if params is None else params_to(params,
                                                              self.device)
        if isinstance(targets, torch.Tensor):
            targets = targets.detach().cpu().numpy()
        targets = np.asarray(targets, np.float32).reshape(-1)
        if targets.shape[0] != len(pairs):
            raise ValueError(f"{len(pairs)} pairs but {targets.shape[0]} "
                             "targets")
        finite_t = np.isfinite(targets)
        if not finite_t.all():
            self.counters["nonfinite_targets"] += int((~finite_t).sum())
            keep = np.flatnonzero(finite_t)
            pairs = [pairs[i] for i in keep]
            targets = targets[keep]
        plan = self.plan(pairs, train=True)
        self.last_plan = plan
        self.last_pack_stats = None
        if plan.quarantined:
            self.counters["quarantined_graphs"] += len(plan.quarantined)
        zero = _zeros_like_tree(params)
        loss0 = torch.zeros((), dtype=torch.float32, device=self.device)
        if not len(pairs):
            return loss0, zero
        if not plan.stats.has_labels:
            raise ValueError(
                "graphs must carry int node labels ('labels'); a dense-"
                "feats executor is not implemented yet (ROADMAP open item)")
        sse = loss0
        grads = zero
        degraded: list[str] = []
        attempts = 0
        n_live = 0
        for start, idx in ((plan.path, plan.fit_idx),
                           ("reference", plan.over_idx)):
            if not len(idx):
                continue
            t0 = self._clock()
            s, g, a, d, rung, nd = self._run_train_ladder(
                start, params, [pairs[i] for i in idx], targets[idx],
                plan, accum_steps)
            self._sync()
            self._record_trace("train", f"train:{rung}", len(idx), plan,
                               self._clock() - t0, degraded=d, attempts=a,
                               n_devices=nd)
            sse = sse + s
            grads = _tree_add(grads, g)
            attempts += a
            degraded.extend(d)
            n_live += len(idx)
        self.last_plan = replace(plan, degraded_from=tuple(degraded),
                                 attempts=max(attempts, 1))
        if not n_live:
            return loss0, zero
        n = float(n_live)
        return sse / n, tree_map(lambda x: x / n, grads)

    # ------------------------------------------------- embedding-cached path

    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    def _tensor(self, x) -> torch.Tensor:
        """x (numpy or tensor) as a contiguous float32 tensor on the
        engine's device; numpy inputs are copied (they may be read-only
        views, e.g. `np.broadcast_to`)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32))
        return x.to(device=self.device, dtype=torch.float32).contiguous()

    def _embed_fn(self) -> Callable:
        """(params, adj, feats, mask) -> [B, F] embeddings of one padded
        bucket: A' normalised on the device, then the embedding kernel (its
        plain version on the CPU). Forced-reference engines embed with the
        model's own `graph_embedding`."""
        if self._bucket_flavor == "reference":
            return self._embed_fallback
        from repro_torch.core.gcn import normalized_adjacency
        from repro_torch.kernels import ops

        def fused(params, adj, feats, mask):
            return ops.graph_embeddings_fused(
                params, normalized_adjacency(adj, mask), feats, mask,
                device=self.device)
        return fused

    @staticmethod
    def _embed_fallback(params, adj, feats, mask):
        """The plain model's embedder: the CPU's retry of a failed embed
        bucket."""
        from repro_torch.core.simgnn import graph_embedding

        return graph_embedding(params_to(params, dtype=torch.float32), adj,
                               feats, mask)

    def embed_graphs(self, graphs: Sequence[dict], *,
                     keys: Sequence[bytes] | None = None) -> np.ndarray:
        """Per-graph `[F]` GCN+Att embeddings through the cache.

        Hits are served from the LRU; unique misses are bucketed by size
        (power-of-two oversize buckets), embedded in batched calls and
        inserted. Returns `[len(graphs), F]` float32 in input order;
        duplicates within one call are embedded once.

        A failing (or NaN-emitting) bucket is retried on the plain model's
        embedder on the CPU; on the card it is not. A bucket that cannot be
        embedded is dropped: its rows are NaN, never cached, and counted in
        `embed_dropped_graphs`; the other buckets and every hit still
        serve."""
        from repro_torch.core.batching import bucket_for, pad_graphs

        f = self.cfg.gcn_dims[-1]
        out = np.zeros((len(graphs), f), np.float32)
        if not graphs:
            return out
        if keys is None:
            keys = [graph_key(g) for g in graphs]
        # One LRU access per unique key; lookups carry the structural
        # fingerprint so a key collision evicts and misses.
        seen: dict[bytes, np.ndarray | None] = {}
        misses: OrderedDict[bytes, list[int]] = OrderedDict()
        for i, k in enumerate(keys):
            if k not in seen:
                seen[k] = self.cache.get(k, graph_fingerprint(graphs[i]))
            emb = seen[k]
            if emb is not None:
                out[i] = emb
            else:
                misses.setdefault(k, []).append(i)
        if not misses:
            return out
        buckets: dict[int, list[tuple[bytes, dict]]] = {}
        for k, idxs in misses.items():
            g = graphs[idxs[0]]
            b = bucket_for(g["adj"].shape[0], allow_oversize=True)
            buckets.setdefault(b, []).append((k, g))
        embed = self._embed_fn()
        for b, items in sorted(buckets.items()):
            batch = pad_graphs([g for _, g in items], self.cfg.n_node_labels,
                               b, device=self.device)

            def run(site, fn):
                h = _call(site, lambda: fn(self.params, batch.adj,
                                           batch.feats, batch.mask))
                h = h.detach().float().cpu().numpy()
                if not np.isfinite(h).all():
                    raise NonFiniteOutput(
                        f"{site} produced non-finite embeddings")
                return h

            hg = None
            try:
                hg = run("embed", embed)
            except Exception:
                self.counters["errors:embed"] += 1
                if not self._on_card():
                    try:
                        hg = run("embed_fallback", self._embed_fallback)
                        self.counters["embed_fallbacks"] += 1
                    except Exception:
                        self.counters["errors:embed_fallback"] += 1
            if hg is None:
                self.counters["embed_dropped_graphs"] += len(items)
                for k, _ in items:
                    out[misses[k]] = np.nan
                continue
            for (k, g), emb in zip(items, hg):
                emb = emb.copy()
                emb.setflags(write=False)
                self.cache.put(k, emb, graph_fingerprint(g))
                out[misses[k]] = emb
        return out

    def prefilter_topm(self, qv, corpus_emb, m: int, *,
                       block_cols: int | None = None,
                       ntn_operands: tuple | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Blocked streaming top-M prefilter scan (DESIGN.md §14): shortlist
        `m` corpus rows per query without materialising [Q, N]. With
        `ntn_operands=(uq, dq)` (from `kernels.retrieval.
        collapse_query_ntn`) the scan is the exact streamed NTN+FCN logit;
        otherwise `qv` is dotted with the corpus. Inputs may be numpy
        arrays or tensors; a corpus tensor already on the engine's device
        is used in place. Routed through the fault seam (site
        "prefilter"); raises on any failure, and promotes corrupt output
        (NaN scores, out-of-range indices) to `NonFiniteOutput`. Returns
        numpy (scores [Q, M] float32, indices [Q, M] int32)."""
        from repro_torch.kernels import retrieval

        self.counters["prefilter_calls"] += 1
        try:
            corpus = self._tensor(corpus_emb)
            if ntn_operands is not None:
                uq, dq = (self._tensor(x) for x in ntn_operands)
                s, i = _call("prefilter", lambda: retrieval.blocked_topm_ntn(
                    uq, dq, corpus, self.params["fcn"], m,
                    block_cols=block_cols))
            else:
                q = self._tensor(qv)
                s, i = _call("prefilter", lambda: retrieval.blocked_topm(
                    q, corpus, m, block_cols=block_cols))
            s = s.detach().float().cpu().numpy()
            i = i.cpu().numpy()
            n = corpus.shape[0]
            if i.size and not ((i >= 0) & (i < n)).all():
                raise NonFiniteOutput(
                    "prefilter returned out-of-range candidate indices")
            if s.size and np.isnan(s).any():
                raise NonFiniteOutput("prefilter returned NaN scores")
        except Exception:
            self.counters["errors:prefilter"] += 1
            raise
        self.counters["prefilter_queries"] += len(qv)
        return s, i

    def _head_kernel(self, params, h1, h2):
        from repro_torch.kernels import ops

        return ops.pair_scores_fused(params, h1, h2, device=self.device)

    @staticmethod
    def _head_plain(params, h1, h2):
        """The plain model's head: forced-reference engines score with it,
        and the CPU retries a failed head on it."""
        from repro_torch.core.simgnn import fcn_head, ntn_scores

        params = params_to(params, dtype=torch.float32)
        return fcn_head(params["fcn"], ntn_scores(params["ntn"], h1, h2))

    def pair_scores_from_embeddings(self, hg1, hg2) -> np.ndarray:
        """Batched NTN+FCN head on precomputed `[B, F]` embeddings (numpy
        or tensors) — the per-query cost of a warm 1-vs-N search. Runs the
        head kernel (its plain version on the CPU) except on forced-
        reference engines. A failing or NaN-emitting head raises on the
        card and retries once on the plain head on the CPU; pairs whose
        embeddings are already NaN score NaN without tripping either."""
        h1, h2 = self._tensor(hg1), self._tensor(hg2)
        row_ok = (torch.isfinite(h1).all(-1)
                  & torch.isfinite(h2).all(-1)).cpu().numpy()

        def run(site, fn):
            s = _call(site, lambda: fn(self.params, h1, h2))
            s = s.detach().float().cpu().numpy()
            if not np.isfinite(s[row_ok]).all():
                raise NonFiniteOutput(
                    f"{site} produced non-finite scores for finite "
                    "embeddings")
            return s

        head = (self._head_plain if self._bucket_flavor == "reference"
                else self._head_kernel)
        try:
            return run("head", head)
        except Exception:
            self.counters["errors:head"] += 1
            if self._on_card():
                raise
            return run("head_fallback", self._head_plain)

    def _score_cached(self, pairs, idx: np.ndarray, out: np.ndarray,
                      plan: ScorePlan):
        n = len(pairs)
        keys = plan.graph_keys if len(plan.graph_keys) == 2 * n else None
        hg1 = self.embed_graphs([p[0] for p in pairs],
                                keys=keys[:n] if keys else None)
        hg2 = self.embed_graphs([p[1] for p in pairs],
                                keys=keys[n:] if keys else None)
        out[idx] = self.pair_scores_from_embeddings(hg1, hg2)

    def score(self, pairs: Sequence[tuple]) -> np.ndarray:
        """Score a batch of graph-pair dicts in original order; quarantined
        pairs score NaN. The executed plan is republished on `last_plan`."""
        out = np.zeros(len(pairs), np.float32)
        plan = self.plan(pairs)
        self.last_plan = plan
        self.last_pack_stats = None
        if plan.quarantined:
            self.counters["quarantined_graphs"] += len(plan.quarantined)
            out[sorted({rec.pair for rec in plan.quarantined})] = np.nan
        if len(plan.fit_idx) or len(plan.over_idx):
            if not plan.stats.has_labels:
                raise ValueError(
                    "graphs must carry int node labels ('labels'); a dense-"
                    "feats executor is not implemented yet (ROADMAP open "
                    "item)")
            degraded: list[str] = []
            attempts = 0
            for start, idx in ((plan.path, plan.fit_idx),
                               (plan.fallback, plan.over_idx)):
                if not len(idx):
                    continue
                # The ladder returns with the scores on the host (each rung
                # copies them out), so the wall covers the device work.
                t0 = self._clock()
                a, d, rung, nd = self._run_score_ladder(
                    start, [pairs[i] for i in idx], idx, out, plan)
                self._record_trace("score", rung, len(idx), plan,
                                   self._clock() - t0, degraded=d,
                                   attempts=a, n_devices=nd)
                attempts += a
                degraded.extend(d)
            self.last_plan = replace(plan, degraded_from=tuple(degraded),
                                     attempts=max(attempts, 1))
        return out

    __call__ = score

