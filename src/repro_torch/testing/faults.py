"""Deterministic fault injection for the scoring engine — port of
`repro.testing.faults` (DESIGN.md §12, §13).

The engine routes every executor invocation through a module-level hook
seam (`core.engine._FAULT_HOOK`, `None` in production), and `inject()` arms
that seam for the duration of a `with` block, so a fault reaches warm
engines whose executors are cached on the instance.

Sites are the engine's execution points, named as in the JAX package:

    "packed_sparse" | "packed_dense" | "bucketed_mega" | "two_kernel"
    | "reference"          — score-path executor calls (one per bucket/pack)
    "embed"                — the per-bucket embedding call (cache misses)
    "embed_fallback"       — the CPU's plain retry of a failed embed bucket
    "head"                 — the NTN+FCN head
    "head_fallback"        — the CPU's plain retry of a failed head call
    "prefilter"            — the blocked top-M retrieval scan
    "train:packed_sparse" | "train:packed_dense" | "train:reference"
                           — loss_and_grad executor calls
    "profile"              — the engine's trace-record append: a failing
                             recorder never fails the scoring call, it
                             counts `profile_record_errors`
    "sharded:packed_sparse" | "sharded:packed_dense"
                           — a packed call scored over several mesh
                             devices (one per call, all shards): a fault
                             here collapses the call to the same path on
                             one device (rung `path@Nd` -> `path`)
    "sharded:train:packed_sparse" | "sharded:train:packed_dense"
                           — a loss_and_grad call run over several mesh
                             devices (one per call, all spans): a fault
                             here collapses the call to the same path on
                             one device (rung `path@Nd` -> `path`)

Modes:

    "raise"  — raise `FaultError` (a generic kernel crash);
    "oom"    — raise `ResourceExhausted` (an allocation failure on the
               chosen path);
    "nan"    — let the call run, then replace every floating torch tensor
               or numpy array of the result with NaN (a silently corrupting
               kernel, caught by the engine's finite checks).

`after` skips the first N matching calls before firing; `times` bounds how
many calls fire (None = every one while armed). Blocks nest; each yields
its `FaultPlan`, whose `calls` / `triggered` counters tell tests exactly
which executions were hit.

    with faults.inject("packed_sparse", mode="raise") as plan:
        out = engine.score(pairs)          # completes via packed_dense
    assert plan.triggered >= 1
"""

from __future__ import annotations

import json
import os
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch


class FaultError(RuntimeError):
    """An injected kernel failure (generic crash)."""


class ResourceExhausted(FaultError):
    """An injected allocation failure on a specific path."""


@dataclass
class FaultPlan:
    """One armed fault: where, how and when it fires, with observed
    counters for assertions."""
    site: str
    mode: str = "raise"            # raise | oom | nan
    after: int = 0                 # skip the first `after` matching calls
    times: int | None = None       # fire at most this many times
    calls: int = field(default=0, init=False)       # matching calls seen
    triggered: int = field(default=0, init=False)   # calls actually failed

    def _fires(self) -> bool:
        i = self.calls
        self.calls += 1
        if i < self.after or (self.times is not None
                              and self.triggered >= self.times):
            return False
        self.triggered += 1
        return True


_ACTIVE: list[FaultPlan] = []


def _nan_like(x):
    """NaN in place of every floating tensor or array of a result tree
    (dicts, lists, tuples and named tuples are walked)."""
    if isinstance(x, torch.Tensor):
        return torch.full_like(x, float("nan")) if x.is_floating_point() \
            else x
    if isinstance(x, np.ndarray):
        return np.full_like(x, np.nan) if np.issubdtype(x.dtype,
                                                        np.inexact) else x
    if isinstance(x, dict):
        return {k: _nan_like(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_nan_like(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_nan_like(v) for v in x)
    if isinstance(x, float):
        return float("nan")
    return x


def _hook(site: str, thunk):
    """The seam the engine calls around every executor invocation."""
    corrupt = False
    for plan in list(_ACTIVE):
        if plan.site != site:
            continue
        if plan._fires():
            if plan.mode == "oom":
                raise ResourceExhausted(
                    f"injected RESOURCE_EXHAUSTED at {site} "
                    f"(call {plan.calls - 1})")
            if plan.mode == "raise":
                raise FaultError(
                    f"injected fault at {site} (call {plan.calls - 1})")
            corrupt = True                          # mode == "nan"
    out = thunk()
    if corrupt:
        out = _nan_like(out)
    return out


@contextmanager
def inject(site: str, mode: str = "raise", *, after: int = 0,
           times: int | None = None):
    """Arm one fault for the duration of the block; yields its FaultPlan."""
    if mode not in ("raise", "oom", "nan"):
        raise ValueError(f"unknown fault mode {mode!r}")
    from repro_torch.core import engine as engine_mod

    plan = FaultPlan(site, mode, after, times)
    _ACTIVE.append(plan)
    engine_mod._FAULT_HOOK = _hook
    try:
        yield plan
    finally:
        _ACTIVE.remove(plan)
        if not _ACTIVE:
            engine_mod._FAULT_HOOK = None


# --------------------------------------------------------------------------
# Filesystem faults (DESIGN.md §13): the durable-state twin of the executor
# seam above. Every durable write of the port funnels through
# `core.store.atomic_write_bytes(path, data, site=...)`; `fs_inject()` arms
# its `_FS_HOOK` so a test corrupts exactly the bytes of one named write.
# Sites:
#
#     "store:shard"    — one ShardStore row-shard file
#     "store:manifest" — the ShardStore JSON manifest
#     "ckpt:arrays"    — a checkpoint's arrays.<proc>.npz payload
#     "ckpt:manifest"  — a checkpoint's msgpack manifest
#     "profile"        — a TraceRecorder JSONL flush: torn or garbled record
#                        lines are skipped and counted on the next read
#
# Write-time modes:
#
#     "torn"    — the write is truncated at byte `at_byte` (default: half);
#     "bitflip" — one bit of byte `at_byte` is flipped (silent bit rot);
#     "missing" — the write is dropped, the writer believes it succeeded;
#     "stale"   — manifest sites only: the manifest is written with a
#                 format version this reader does not support (JSON for the
#                 store, msgpack for a checkpoint).
#
# `corrupt_file()` applies the same damage to a file already on disk.


@dataclass
class FsFaultPlan:
    """One armed filesystem fault, with observed counters for assertions."""
    site: str
    mode: str = "torn"             # torn | bitflip | missing | stale
    at_byte: int | None = None     # position for torn/bitflip (default mid)
    after: int = 0
    times: int | None = None
    calls: int = field(default=0, init=False)
    triggered: int = field(default=0, init=False)

    _fires = FaultPlan._fires


_FS_ACTIVE: list[FsFaultPlan] = []


def _damage_bytes(data: bytes, mode: str, at_byte: int | None,
                  site: str) -> bytes | None:
    if mode == "missing":
        return None
    if mode == "stale":
        if not site.endswith("manifest"):
            raise ValueError(f"mode 'stale' only applies to manifest sites, "
                             f"got {site!r}")
        if site.startswith("store:"):
            man = json.loads(data.decode())
            man["format_version"] = man.get("format_version", 0) + 1000
            return json.dumps(man).encode()
        from repro_torch.ckpt import msgpack_codec

        man = msgpack_codec.unpackb(data)
        man["format_version"] = man.get("format_version", 0) + 1000
        return msgpack_codec.packb(man)
    at = len(data) // 2 if at_byte is None else min(at_byte, len(data) - 1)
    if mode == "torn":
        return data[:at]
    buf = bytearray(data)          # mode == "bitflip"
    buf[at] ^= 0x01
    return bytes(buf)


def _fs_hook(site: str, path: str, data: bytes) -> bytes | None:
    for plan in list(_FS_ACTIVE):
        if plan.site != site:
            continue
        if plan._fires():
            data = _damage_bytes(data, plan.mode, plan.at_byte, site)
            if data is None:
                return None
    return data


@contextmanager
def fs_inject(site: str, mode: str = "torn", *, at_byte: int | None = None,
              after: int = 0, times: int | None = None):
    """Arm one filesystem fault for the block; yields its FsFaultPlan."""
    if mode not in ("torn", "bitflip", "missing", "stale"):
        raise ValueError(f"unknown filesystem fault mode {mode!r}")
    from repro_torch.core import store as store_mod

    plan = FsFaultPlan(site, mode, at_byte, after, times)
    _FS_ACTIVE.append(plan)
    store_mod._FS_HOOK = _fs_hook
    try:
        yield plan
    finally:
        _FS_ACTIVE.remove(plan)
        if not _FS_ACTIVE:
            store_mod._FS_HOOK = None


def corrupt_file(path: str, mode: str = "bitflip", *,
                 at_byte: int | None = None) -> None:
    """Deterministically damage a file already on disk (at-rest bit rot,
    truncation or loss), bypassing the atomic-write seam on purpose: the
    write succeeded, the disk failed later."""
    if mode == "missing":
        os.remove(path)
        return
    # Map the file back to its manifest dialect so mode="stale" works at
    # rest too (store manifests are JSON, checkpoint manifests msgpack).
    site = ("store:manifest" if path.endswith(".json")
            else "ckpt:manifest" if path.endswith(".msgpack") else path)
    with open(path, "rb") as f:
        data = f.read()
    data = _damage_bytes(data, mode, at_byte, site=site)
    with open(path, "wb") as f:
        f.write(data)
