"""Query batching for serving — port of `repro.serve.batching`.

  * `MicroBatcher` / `FlushStats` / `TimeoutResult` — the JAX package's
    size- and deadline-bounded request accumulator, copied verbatim (it is
    plain Python);
  * `simgnn_query_server` — the paper's workload, a stream of graph pairs
    scored in batches, as a thin wrapper over the port's
    `core.engine.ScoringEngine` with the same flag -> path mapping and
    `score_fn` attributes as the JAX server.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class FlushStats:
    """Measured MicroBatcher behavior (benchmarks/fig11.py reads these
    instead of inferring occupancy from the request count)."""
    batches: int = 0               # total flushes that ran a batch
    requests: int = 0              # total requests flushed
    size_flushes: int = 0          # flushes triggered by reaching max_batch
    deadline_flushes: int = 0      # flushes triggered by max_wait_s
    expired_flushes: int = 0       # flushes triggered by a per-request
                                   # deadline (timeout_s), counted distinctly
                                   # from the group max_wait_s deadline
    manual_flushes: int = 0        # explicit flush() calls that ran a batch
                                   # (empty manual flushes are no-ops)
    occupancy_sum: float = 0.0     # sum of len(batch)/max_batch per flush
    expired_requests: int = 0      # requests answered with TimeoutResult
    retries: int = 0               # run_batch retry attempts after a failure
    failed_flushes: int = 0        # flushes whose run_batch exhausted retries
    dropped_requests: int = 0      # requests lost to a failed flush

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.batches if self.batches else 0.0


@dataclass(frozen=True)
class TimeoutResult:
    """Positional stand-in for a request whose per-request deadline had
    already passed when its batch flushed (DESIGN.md §12): the client gets
    a typed timeout instead of a stale score, and the expired request never
    consumes batch compute."""
    request: object
    waited_s: float


@dataclass
class MicroBatcher:
    """Size- and deadline-bounded request accumulator.

    `submit` flushes when the pending group reaches `max_batch` OR when the
    oldest pending request has already waited `max_wait_s`. Between arrivals
    the serving loop calls `poll()` (or checks `deadline_in()`) so a lull in
    traffic cannot strand a partial batch. `clock` is injectable for tests.

    Return contract (uniform across submit/poll/flush): `None` means
    NOTHING RAN — no batch was dispatched. A list (possibly empty, if
    `run_batch` returned no results) means a batch ran. An empty `flush()`
    is therefore `None`, not `[]`, and does not count in `FlushStats`.

    Resilience (DESIGN.md §12): `submit(req, timeout_s=...)` attaches a
    per-request deadline — an expired request is answered positionally with
    a `TimeoutResult` at flush instead of consuming batch compute, and
    `deadline_in()`/`poll()` honor the earliest per-request deadline so the
    serving loop wakes up in time. A `run_batch` that raises is retried up
    to `flush_retries` times with exponential backoff (`sleep` injectable);
    exhausting retries counts `failed_flushes`/`dropped_requests` and
    re-raises — the queue is already drained, so one poisoned batch cannot
    wedge every later request behind it.
    """
    run_batch: Callable            # list[request] -> list[result]
    max_batch: int = 256
    max_wait_s: float = 0.005
    clock: Callable[[], float] = time.monotonic
    flush_retries: int = 2         # run_batch attempts = 1 + flush_retries
    retry_backoff_s: float = 0.05  # sleep 1x, 2x, 4x... between attempts
    sleep: Callable[[float], None] = time.sleep
    pending: list = field(default_factory=list)
    oldest_ts: float | None = field(default=None, repr=False)
    stats: FlushStats = field(default_factory=FlushStats)
    #: (absolute deadline | None, enqueue ts) per pending request, aligned
    #: with `pending` (which stays a plain request list — public contract).
    _deadlines: list = field(default_factory=list, repr=False)

    def submit(self, request, *, timeout_s: float | None = None):
        now = self.clock()
        if not self.pending:
            self.oldest_ts = now
        self.pending.append(request)
        self._deadlines.append(
            (None if timeout_s is None else now + timeout_s, now))
        if len(self.pending) >= self.max_batch:
            return self.flush(reason="size")
        return self.poll()

    def _request_expired(self) -> bool:
        now = self.clock()
        return any(d is not None and now >= d for d, _ in self._deadlines)

    def _deadline_expired(self) -> bool:
        return (bool(self.pending)
                and self.clock() - self.oldest_ts >= self.max_wait_s)

    def deadline_in(self) -> float | None:
        """Seconds until the pending group must flush (None if empty) —
        the sooner of the group max_wait_s and the earliest per-request
        deadline, clamped to 0.0 once overdue (never negative: the serving
        loop can pass it straight to a wait/select call)."""
        if not self.pending:
            return None
        due = self.oldest_ts + self.max_wait_s
        for d, _ in self._deadlines:
            if d is not None:
                due = min(due, d)
        return max(0.0, due - self.clock())

    def poll(self):
        """Flush iff a deadline has expired; the serving loop's idle tick.
        Returns the batch results, or None if nothing was due."""
        if self._request_expired():
            return self.flush(reason="expired")
        if self._deadline_expired():
            return self.flush(reason="deadline")
        return None

    def flush(self, reason: str = "manual"):
        """Run the pending group now. Returns the batch results, or None if
        the queue was empty (nothing ran — indistinguishable from a real
        zero-result batch otherwise); empty flushes leave `stats` untouched.

        Requests whose per-request deadline has already passed are answered
        with `TimeoutResult` at their original positions (requires
        `run_batch` to return one result per request, which every scoring
        backend here does); the live remainder runs as one batch.
        """
        if not self.pending:
            return None
        batch, self.pending = self.pending, []
        deadlines, self._deadlines = self._deadlines, []
        self.oldest_ts = None
        now = self.clock()
        st = self.stats
        st.batches += 1
        st.requests += len(batch)
        st.occupancy_sum += len(batch) / self.max_batch
        if reason == "size":
            st.size_flushes += 1
        elif reason == "deadline":
            st.deadline_flushes += 1
        elif reason == "expired":
            st.expired_flushes += 1
        else:
            st.manual_flushes += 1
        expired = {i for i, (d, _) in enumerate(deadlines)
                   if d is not None and now >= d}
        live = [r for i, r in enumerate(batch) if i not in expired]
        st.expired_requests += len(expired)
        res = live and self._run_with_retries(live)
        if not expired:
            return res
        out: list = []
        it = iter(res or ())
        for i, r in enumerate(batch):
            out.append(TimeoutResult(r, now - deadlines[i][1])
                       if i in expired else next(it, None))
        return out

    def _run_with_retries(self, live: list):
        last_err = None
        for attempt in range(1 + self.flush_retries):
            if attempt:
                self.stats.retries += 1
                self.sleep(self.retry_backoff_s * 2 ** (attempt - 1))
            try:
                return self.run_batch(live)
            except Exception as exc:
                last_err = exc
        self.stats.failed_flushes += 1
        self.stats.dropped_requests += len(live)
        raise last_err


def simgnn_query_server(params, cfg, *, use_kernels: bool = False,
                        packing: bool = True, node_budget: int | None = None,
                        path: str | None = None, cache_size: int = 4096,
                        validation: str = "lenient",
                        clock: Callable[[], float] = time.perf_counter,
                        recorder=None, planner: str = "measured",
                        runtime=None, device=None):
    """Returns score_fn(list[(g1, g2)]) -> np.ndarray of similarity scores,
    scored on `device` (None = the card).

    No path selection happens here: `use_kernels=False` -> "reference";
    `use_kernels=True, packing=False` -> "bucketed_mega";
    `use_kernels=True, packing=True` -> "auto" (packed-sparse or
    packed-dense by measured density, bucketed fallback for oversized
    pairs). An explicit `path` overrides the flags. `cache_size` bounds
    the engine's per-graph embedding LRU (0 disables it); the LRU fills on
    the embedding-cached path (forced, or warmed through
    `score_fn.engine.embed_graphs`), after which auto dispatch serves
    recurring graphs embedding-free. `validation`, `clock`, `recorder` (a
    `core.profile.TraceRecorder` several servers may share), `planner`
    ("measured" or "threshold") and `runtime` (a multi-device
    `distributed.sharding.Runtime` lets the planner split packed calls'
    tiles over its mesh; None keeps every path on one device) are
    forwarded to the engine.

    The returned score_fn exposes `bucket_fns` (the engine's per-bucket
    callable cache), `last_pack_stats`, `node_budget`, `last_plan` and
    `engine`.
    """
    from repro_torch.core.engine import ScoringEngine

    if path is None:
        path = (("auto" if packing else "bucketed_mega") if use_kernels
                else "reference")
    engine = ScoringEngine(params, cfg, path=path, node_budget=node_budget,
                           cache_size=cache_size, validation=validation,
                           clock=clock, recorder=recorder, planner=planner,
                           runtime=runtime, device=device)

    def score(pairs):
        out = engine.score(pairs)
        score.last_pack_stats = engine.last_pack_stats
        score.last_plan = engine.last_plan
        return out

    score.engine = engine
    score.bucket_fns = engine.bucket_fns       # same dict object: live view
    score.last_pack_stats = None
    score.last_plan = None
    score.node_budget = engine.node_budget
    return score
