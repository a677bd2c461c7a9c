"""Input quarantine — graph sanitation before planning (DESIGN.md §12).
The port's copy of `repro.core.validate` (numpy only), kept verbatim so
both packages quarantine the same inputs with the same records.

Every scoring path downstream of `ScoringEngine.plan()` assumes clean
inputs: square binary symmetric adjacency, int labels in range, no
non-finite values. A production stream violates each of those eventually,
and one malformed graph used to poison the whole micro-batch (a shape error
deep inside packing, or NaNs silently spreading through a packed tile that
also holds 30 healthy pairs).

This module turns that into a per-request outcome: `validate_pairs` scans a
batch host-side and splits it into valid pairs (scored normally) and
quarantined pairs, each with a structured `InvalidGraph` record naming the
pair, side and every reason. The engine (lenient mode, the default) scores
quarantined pairs as NaN — the standard "no answer" marker that survives
serialization — and surfaces the records on the `ScorePlan`; strict mode
raises `GraphValidationError` with the same records attached.

The checks are single-pass numpy reductions per graph (isfinite / binary /
symmetry), so validation costs about as much as the density measurement the
auto planner already performs. Engines built with `validation="off"` skip
it entirely (trusted in-process generators, benchmarks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class InvalidGraph:
    """One quarantined graph: which pair and side of the call it came from,
    and every validation failure found (not just the first — a client fixing
    its producer wants the full list)."""
    pair: int                 # pair position within the call
    side: int                 # 0 = lhs, 1 = rhs
    reasons: tuple            # tuple[str, ...], human-readable

    def __str__(self) -> str:
        return (f"pair {self.pair} side {self.side}: "
                + "; ".join(self.reasons))


class GraphValidationError(ValueError):
    """Strict-mode rejection; `.records` carries the InvalidGraph list."""

    def __init__(self, records: Sequence[InvalidGraph]):
        self.records = tuple(records)
        lines = ", ".join(str(r) for r in self.records[:4])
        more = (f" (+{len(self.records) - 4} more)"
                if len(self.records) > 4 else "")
        super().__init__(
            f"{len(self.records)} invalid graph(s) in batch: {lines}{more}")


def graph_problems(g, *, n_labels: int | None = None) -> list[str]:
    """Every validation failure of one graph dict (empty list == valid).

    Checks, in dependency order (later checks assume earlier ones hold):
      * structure — a dict with an "adj" key; adjacency array-like, 2-D,
        square, at least one node;
      * dtype — numeric adjacency (object/str arrays are rejected before
        any arithmetic touches them);
      * values — finite (no NaN/Inf), binary {0, 1} (covers negative
        entries), zero diagonal (raw adjacency carries no self loops —
        normalization adds A+I itself), symmetric (undirected contract;
        the symmetric-A' training VJP exploits it);
      * labels, when present — 1-D of length n, integer dtype (float labels
        can smuggle NaN and break the W1 row gather), in [0, n_labels).
    Missing labels are NOT invalid here: the engine's label-free contract
    error stays in charge of that case.
    """
    if not isinstance(g, dict) or "adj" not in g:
        return ["missing adjacency ('adj')"]
    problems: list[str] = []
    try:
        adj = np.asarray(g["adj"])
    except Exception:
        return ["adjacency is not array-like"]
    if adj.dtype == object or adj.dtype.kind in "USV":
        return [f"non-numeric adjacency dtype {adj.dtype}"]
    if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
        return [f"adjacency not square (shape {adj.shape})"]
    n = adj.shape[0]
    if n == 0:
        return ["empty graph (0 nodes)"]
    if not np.isfinite(adj).all():
        problems.append("non-finite adjacency entries (NaN/Inf)")
    else:
        if not ((adj == 0) | (adj == 1)).all():
            problems.append("non-binary adjacency entries")
        if np.asarray(adj.diagonal()).any():
            problems.append("self loops on the diagonal (raw adjacency "
                            "must be hollow; normalization adds A+I)")
        if not (adj == adj.T).all():
            problems.append("asymmetric adjacency (graphs are undirected)")
    if "labels" in g:
        try:
            labels = np.asarray(g["labels"])
        except Exception:
            problems.append("labels are not array-like")
            return problems
        if labels.ndim != 1 or labels.shape[0] != n:
            problems.append(f"ragged labels (shape {labels.shape} for "
                            f"{n} nodes)")
        elif labels.dtype.kind not in "iu":
            problems.append(f"non-integer label dtype {labels.dtype}")
        else:
            if labels.size and int(labels.min()) < 0:
                problems.append("negative node labels")
            if (n_labels is not None and labels.size
                    and int(labels.max()) >= n_labels):
                problems.append(f"node label {int(labels.max())} out of "
                                f"range [0, {n_labels})")
    return problems


def validate_pairs(pairs: Sequence[tuple], *, n_labels: int | None = None
                   ) -> tuple[np.ndarray, tuple]:
    """Split a batch of graph pairs into valid and quarantined.

    Returns `(valid_idx, records)`: `valid_idx` the int64 positions of pairs
    where BOTH sides pass, `records` a tuple of `InvalidGraph` (one per bad
    graph — a pair with two bad sides yields two records). Distinct graph
    *objects* are validated once per call (1-vs-N batches repeat the query
    and hot corpus dicts; the memo is per-call only, like the engine's
    graph-key memo, because id() values are not stable across GC).
    """
    memo: dict[int, list[str]] = {}
    records: list[InvalidGraph] = []
    valid: list[int] = []
    for i, pair in enumerate(pairs):
        if not isinstance(pair, (tuple, list)) or len(pair) != 2:
            records.append(InvalidGraph(i, 0, ("not a (g1, g2) pair",)))
            continue
        ok = True
        for side, g in enumerate(pair):
            key = id(g)
            problems = memo.get(key)
            if problems is None:
                problems = memo[key] = graph_problems(g, n_labels=n_labels)
            if problems:
                ok = False
                records.append(InvalidGraph(i, side, tuple(problems)))
        if ok:
            valid.append(i)
    return np.asarray(valid, np.int64), tuple(records)
