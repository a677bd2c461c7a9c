"""Per-call trace recording and the measured per-path latency cost model —
port of `repro.core.profile` (DESIGN.md §15).

numpy only, copied so the port imports nothing of the JAX package. The
file format is the JAX package's byte for byte: same header, same record
schema and digests, records serialised by the same `json.dumps(...,
sort_keys=True)`, so a profile written by either package loads in the
other. The fit is numpy float64 in both, so a profile gives both packages
the same weights bit for bit.

  * `TraceRecorder` — an in-memory ring of `TraceRecord`s (one per executed
    engine work item: path, shape stats, pack occupancy, degradation tail,
    wall seconds) plus an append-only JSONL profile persisted through
    `core.store.atomic_write_bytes` (site ``"profile"`` on the filesystem
    fault seam). The clock is injectable.

  * `fit_cost_model` — a small ridge regression per path on shape features
    (pairs, total nodes, total edges, embeddings to compute).
    `ScoringEngine.plan()` argmins the predicted cost when every candidate
    path has enough support, and falls back bit-identically to the
    threshold rules when cold.

Profile format (one JSON object per line):

    line 0:  {"profile_format_version": 2, "schema_digest": "<hex>"}
    line 1+: one record with EXACTLY the `TRACE_SCHEMA` fields

Version 1 profiles (no `n_devices` field) are still read (`n_devices=1`)
and upgrade to v2 in place on the next flush. A header this reader does
not understand raises `ProfileError`; a garbled record line is skipped and
counted (`records_dropped`).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from collections import Counter, deque
from dataclasses import asdict, astuple, dataclass
from typing import Callable, Iterable, Sequence

import numpy as np

from repro_torch.core.store import StoreError, atomic_write_bytes

#: Bump when `TRACE_SCHEMA` changes shape or meaning. Readers refuse any
#: other version (ProfileError) instead of guessing — a mis-parsed latency
#: sample silently steers every later dispatch decision. v2 added
#: `n_devices` (DESIGN.md §16): v1 profiles are still read (every v1 record
#: ran single-device, so `n_devices=1` is a fact, not a guess) and are
#: upgraded to v2 in place on the next flush.
PROFILE_FORMAT_VERSION = 2

#: The versioned record schema: (field, json-type) in canonical order.
#: `schema_digest()` hashes this, so ANY rename / retype / reorder changes
#: the digest and old profiles are refused loudly rather than mis-read.
TRACE_SCHEMA = (
    ("kind", "str"),           # "score" | "train" | "step" (entry point)
    ("path", "str"),           # executed path; cost-model key
    ("n_pairs", "int"),        # pairs this work item scored
    ("max_nodes", "int"),      # ScorePlan shape stats, measured
    ("mean_nodes", "float"),
    ("avg_degree", "float"),
    ("density", "float"),
    ("occupancy", "float"),    # packed-tile occupancy (0 on unpacked paths)
    ("to_embed", "int"),       # cache misses actually embedded (cached path)
    ("degraded_from", "list"),  # rungs that failed before `path` served
    ("attempts", "int"),       # executor invocations tried
    ("wall_s", "float"),       # measured wall seconds (injectable clock)
    ("seq", "int"),            # recorder-assigned sequence number
    ("n_devices", "int"),      # mesh devices the call ran on (v2; v1 -> 1)
)

#: The v1 schema (everything before `n_devices`), kept so v1 profiles load.
_V1_SCHEMA = TRACE_SCHEMA[:-1]

_TYPE_CHECK = {
    "str": lambda v: isinstance(v, str),
    "int": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "float": lambda v: isinstance(v, (int, float))
    and not isinstance(v, bool),
    "list": lambda v: isinstance(v, list),
}


def _digest_of(version: int, schema: tuple) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(str(version).encode())
    for name, typ in schema:
        h.update(f"{name}:{typ};".encode())
    return h.hexdigest()


def schema_digest() -> str:
    """blake2b-128 hex of (format version, schema) — the golden-pinned
    format contract for persisted profiles."""
    return _digest_of(PROFILE_FORMAT_VERSION, TRACE_SCHEMA)


def v1_schema_digest() -> str:
    """Digest of the retired v1 schema — what a v1 header must carry for
    this reader to accept (and upgrade) it."""
    return _digest_of(1, _V1_SCHEMA)


class ProfileError(StoreError):
    """A persisted profile this reader cannot trust as a whole: missing /
    garbled header line, or a format version / schema digest it does not
    understand. Per-line damage is NOT this — garbled record lines are
    skipped and counted instead (losing a sample is recoverable; guessing
    a schema is not)."""


@dataclass(frozen=True)
class TraceRecord:
    """One executed engine work item, as the profile persists it."""
    kind: str
    path: str
    n_pairs: int
    max_nodes: int
    mean_nodes: float
    avg_degree: float
    density: float
    occupancy: float
    to_embed: int
    degraded_from: tuple
    attempts: int
    wall_s: float
    seq: int
    n_devices: int = 1        # v2 field; defaulted LAST so v1 loads fill it

    def to_json(self) -> str:
        d = asdict(self)
        d["degraded_from"] = list(self.degraded_from)
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "TraceRecord":
        """Strict schema validation: exactly the v2 schema fields — or
        exactly the v1 fields, in which case `n_devices=1` is filled in
        (every v1 record ran single-device). Anything else is a
        garbled/foreign line."""
        if not isinstance(d, dict):
            raise ValueError("record not an object")
        names = {n for n, _ in TRACE_SCHEMA}
        if set(d) == {n for n, _ in _V1_SCHEMA}:
            d = dict(d, n_devices=1)
        elif set(d) != names:
            raise ValueError(f"record fields {sorted(d)!r} != schema")
        for name, typ in TRACE_SCHEMA:
            if not _TYPE_CHECK[typ](d[name]):
                raise ValueError(f"field {name!r} is not {typ}")
        d = dict(d)
        d["degraded_from"] = tuple(str(x) for x in d["degraded_from"])
        for name, typ in TRACE_SCHEMA:
            if typ == "float":
                d[name] = float(d[name])
        return cls(**d)


def _header_line() -> str:
    return json.dumps({"profile_format_version": PROFILE_FORMAT_VERSION,
                       "schema_digest": schema_digest()}, sort_keys=True)


def _check_header(line: str, path: str) -> None:
    try:
        head = json.loads(line)
    except ValueError as exc:
        raise ProfileError(f"unreadable profile header at {path}: {exc}")
    if not isinstance(head, dict):
        raise ProfileError(f"profile header at {path} is not an object")
    version = head.get("profile_format_version")
    if version not in (1, PROFILE_FORMAT_VERSION):
        raise ProfileError(
            f"profile format version {version!r} != supported "
            f"{{1, {PROFILE_FORMAT_VERSION}}} at {path}: refusing to guess "
            "the record schema")
    digest = head.get("schema_digest")
    want = v1_schema_digest() if version == 1 else schema_digest()
    if digest != want:
        raise ProfileError(
            f"profile schema digest {digest!r} != {want!r} at "
            f"{path}: the record schema changed without a version bump — "
            "refusing to mis-parse")


class TraceRecorder:
    """In-memory ring + append-only JSONL persistence for trace records.

    `record()` NEVER raises (a broken recorder must never fail a scoring
    call — failures count on `counters["record_errors"]`); `flush()`
    appends the unpersisted tail to the JSONL profile at `path` through
    `atomic_write_bytes` (fault-seam site ``"profile"``), re-validating the
    existing file so a torn previous append self-heals: garbled lines are
    dropped-and-counted, never re-persisted. `clock` is the timestamp /
    timing source engines share so tests inject a fake one.
    """

    def __init__(self, capacity: int = 4096, path: str | None = None,
                 clock: Callable[[], float] = time.perf_counter,
                 flush_every: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.path = path
        self.clock = clock
        #: auto-flush after this many unpersisted records (0 = manual only).
        self.flush_every = int(flush_every)
        self._ring: deque[TraceRecord] = deque(maxlen=self.capacity)
        self._pending: list[TraceRecord] = []
        #: monotonic count of records ever accepted (ring evictions and
        #: flushes never decrease it) — drives the engine's refit cadence.
        self.total_records = 0
        self._seq = 0
        self.counters: Counter = Counter()

    # ------------------------------------------------------------ recording

    def record(self, *, kind: str, path: str, n_pairs: int, max_nodes: int,
               mean_nodes: float, avg_degree: float, density: float,
               occupancy: float = 0.0, to_embed: int = 0,
               degraded_from: Sequence[str] = (), attempts: int = 1,
               wall_s: float = 0.0, n_devices: int = 1
               ) -> TraceRecord | None:
        """Append one record; returns it, or None if recording failed
        (counted, swallowed — observability must not take down serving)."""
        try:
            rec = TraceRecord(
                kind=str(kind), path=str(path), n_pairs=int(n_pairs),
                max_nodes=int(max_nodes), mean_nodes=float(mean_nodes),
                avg_degree=float(avg_degree), density=float(density),
                occupancy=float(occupancy), to_embed=int(to_embed),
                degraded_from=tuple(str(d) for d in degraded_from),
                attempts=int(attempts), wall_s=float(wall_s), seq=self._seq,
                n_devices=int(n_devices))
            self._seq += 1
            self._ring.append(rec)
            self._pending.append(rec)
            self.total_records += 1
            if (self.path and self.flush_every
                    and len(self._pending) >= self.flush_every):
                self.flush()
            return rec
        except Exception:
            self.counters["record_errors"] += 1
            return None

    def records(self) -> list[TraceRecord]:
        """Snapshot of the in-memory ring, oldest first."""
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    # ---------------------------------------------------------- persistence

    def _read_valid_lines(self, path: str) -> list[str]:
        """Existing profile's record lines that still parse + validate,
        re-serialized in the CURRENT schema (so a v1 profile upgrades to v2
        on the next flush — `n_devices=1` filled in); damaged lines (torn
        tail, bit rot) are dropped-and-counted. A bad HEADER raises
        ProfileError — appending to a profile of unknown schema would
        poison every future reader."""
        with open(path, "rb") as f:
            raw = f.read().decode("utf-8", errors="replace")
        lines = [ln for ln in raw.split("\n") if ln.strip()]
        if not lines:
            return []
        _check_header(lines[0], path)
        keep = []
        for ln in lines[1:]:
            try:
                keep.append(TraceRecord.from_dict(json.loads(ln)).to_json())
            except (ValueError, TypeError):
                self.counters["records_dropped"] += 1
        return keep

    def flush(self) -> int:
        """Persist the unpersisted tail; returns records now on disk.
        No-op without a configured `path`. Never raises — a full disk must
        degrade observability, not scoring (`counters["flush_errors"]`)."""
        if not self.path or not self._pending:
            return 0
        try:
            existing = (self._read_valid_lines(self.path)
                        if os.path.exists(self.path) else [])
            lines = ([_header_line()] + existing
                     + [r.to_json() for r in self._pending])
            atomic_write_bytes(self.path, ("\n".join(lines) + "\n").encode(),
                               site="profile")
            n = len(self._pending)
            self._pending = []
            self.counters["flushes"] += 1
            return n
        except Exception:
            self.counters["flush_errors"] += 1
            return 0

    @classmethod
    def load(cls, path: str, *, capacity: int | None = None,
             clock: Callable[[], float] = time.perf_counter
             ) -> "TraceRecorder":
        """Recorder seeded from a persisted profile. Header problems raise
        `ProfileError` (whole file untrusted); damaged record lines are
        skipped-and-counted on `counters["records_dropped"]`. Loaded
        records count as already persisted (a later `flush()` appends only
        new ones)."""
        if not os.path.exists(path):
            raise ProfileError(f"no profile at {path}")
        probe = cls(capacity=1)
        lines = probe._read_valid_lines(path)
        records = [TraceRecord.from_dict(json.loads(ln)) for ln in lines]
        rec = cls(capacity=capacity or max(len(records) * 2, 4096),
                  path=path, clock=clock)
        rec._ring.extend(records)
        rec.total_records = len(records)
        rec._seq = max((r.seq for r in records), default=-1) + 1
        rec.counters["records_dropped"] = probe.counters["records_dropped"]
        return rec


def read_profile(path: str) -> tuple[list[TraceRecord], int]:
    """(records, dropped-line count) of a persisted profile — the read-only
    flavor of `TraceRecorder.load` for analysis/benchmarks."""
    rec = TraceRecorder.load(path)
    return rec.records(), int(rec.counters["records_dropped"])


# ---------------------------------------------------------------- cost model

#: Shape features of one call for the per-path latency model. Deliberately
#: tiny: every term is a quantity the planner already measures host-side,
#: and per-path weights absorb the per-path constants (launch overhead,
#: per-pair head cost, per-node aggregation cost, per-edge gather cost,
#: per-miss embedding cost).
FEATURE_NAMES = ("bias", "pairs", "nodes", "edges", "to_embed")


def trace_features(n_pairs: float, mean_nodes: float, avg_degree: float,
                   to_embed: float = 0.0) -> np.ndarray:
    nodes = 2.0 * float(n_pairs) * float(mean_nodes)
    return np.array([1.0, float(n_pairs), nodes,
                     nodes * float(avg_degree), float(to_embed)], np.float64)


def _record_features(r: TraceRecord) -> np.ndarray:
    return trace_features(r.n_pairs, r.mean_nodes, r.avg_degree, r.to_embed)


def cost_key(path: str, n_devices: int = 1) -> str:
    """Cost-model group key: multi-device walls live under `path@Nd` so the
    planner never mixes single- and multi-device latency samples (a 2-device
    wall predicting a 1-device call would bias every dispatch). Single-device
    keys stay the bare path — v1 profiles keep fitting unchanged."""
    n = int(n_devices)
    return path if n <= 1 else f"{path}@{n}d"


@dataclass(frozen=True)
class CostModel:
    """Per-path ridge fit latency model: weights over `FEATURE_NAMES`,
    plus the support and training residual every fit exposes for
    `engine.health()["planner"]` and the replay gate."""
    weights: dict                   # path -> [len(FEATURE_NAMES)] float64
    support: dict                   # path -> clean records fitted from
    residual_medape: dict           # path -> median |pred-y|/y on train set
    n_records: int
    min_support: int

    def supports(self, paths: Iterable[str]) -> bool:
        return all(p in self.weights for p in paths)

    def predict(self, path: str, feats: np.ndarray) -> float:
        """Predicted wall seconds (clamped positive: a ridge fit can dip
        negative outside its support, and a negative latency would make
        argmin meaningless)."""
        return float(max(feats @ self.weights[path], 1e-9))

    def snapshot(self) -> dict:
        return {"paths": sorted(self.weights),
                "support": dict(self.support),
                "residual_medape": {k: round(v, 4)
                                    for k, v in self.residual_medape.items()},
                "n_records": self.n_records,
                "min_support": self.min_support}


def fit_cost_model(records: Sequence[TraceRecord], *, min_support: int = 8,
                   ridge: float = 1e-3) -> CostModel:
    """Fit one ridge regression per path from clean trace records.

    Clean = no degradation tail and a positive measured wall (a record
    whose timing includes failed attempts on other rungs would bill that
    rung's latency to the path that finally served). Rows are sorted by
    the full record tuple before any linear algebra, so the fit — and
    therefore every argmin the planner takes from it — is bit-identical
    under any record ordering (pinned by a property test). Paths with
    fewer than `min_support` clean records get no weights: the planner
    treats them as cold and keeps the threshold rules.
    """
    by_path: dict[str, list[TraceRecord]] = {}
    for r in records:
        if r.wall_s > 0.0 and not r.degraded_from:
            by_path.setdefault(cost_key(r.path, r.n_devices), []).append(r)
    weights: dict[str, np.ndarray] = {}
    support: dict[str, int] = {}
    residual: dict[str, float] = {}
    k = len(FEATURE_NAMES)
    for path, group in sorted(by_path.items()):
        if len(group) < min_support:
            continue
        group = sorted(group, key=astuple)
        x = np.stack([_record_features(r) for r in group])
        y = np.array([r.wall_s for r in group], np.float64)
        # Column scaling before the ridge penalty: the feature magnitudes
        # span ~5 orders (bias=1 vs edges~1e4), and an unscaled penalty
        # would regularize them incomparably.
        scale = np.maximum(np.abs(x).max(axis=0), 1e-12)
        xs = x / scale
        w = np.linalg.solve(xs.T @ xs + ridge * np.eye(k), xs.T @ y)
        w = w / scale
        pred = np.maximum(x @ w, 1e-9)
        weights[path] = w
        support[path] = len(group)
        residual[path] = float(np.median(
            np.abs(pred - y) / np.maximum(y, 1e-9)))
    return CostModel(weights=weights, support=support,
                     residual_medape=residual, n_records=len(records),
                     min_support=min_support)
