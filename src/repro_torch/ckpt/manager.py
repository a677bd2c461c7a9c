"""Checkpointing: atomic, keep-k, async, integrity-verified — port of
`repro.ckpt.manager` (DESIGN.md §6, §13), on trees of tensors.

Layout per step, the JAX package's:
    <dir>/step_<N:09d>.tmp/        (written first)
        arrays.<proc>.npz          flat leaves, named "0".."n-1"
        manifest.msgpack           keys + dtypes + shapes + format version
                                   + per-file checksums (written LAST: it is
                                   the commit record)
    <dir>/step_<N:09d>/            (atomic rename when complete)

Restart contract: `latest_step()` ignores .tmp directories (and sweeps
orphaned ones left by crashed saves); every durable write goes through
`core.store.atomic_write_bytes` (sites "ckpt:arrays" and "ckpt:manifest",
the fault seam of `testing.faults`); the manifest records a format version
and a blake2b checksum per arrays file, and `restore()` verifies them
before deserializing. `latest_valid_step()` walks the keep-k chain
newest-to-oldest past torn, bit-flipped or missing checkpoints.

Cross-restore: key paths, leaf order, dtype names, shapes and array
contents are the JAX manager's (`_flatten_with_paths`: dict keys sorted,
list items by index, named-tuple fields in field order under their names),
and the manifest is msgpack (`ckpt.msgpack_codec`), so either package
restores the other's checkpoints. The npz bytes themselves differ between
any two saves (zip entries carry the wall clock), and so do checksums.

bfloat16 leaves are written as the JAX manager writes them, 2-byte void
entries with "bfloat16" in the manifest's `dtypes`, and read back through
an int16 view into `torch.bfloat16`.

Sharded trees. A leaf stored as per-device blocks on an LM mesh
(`distributed.placement.ShardedTensor`) is gathered into the whole leaf
before it is written, so the manifest and npz equal an unsharded save's,
as the JAX manager stores full leaves. `restore(..., shardings=)` lays the
leaves out onto the given shardings, which is also the elastic-resharding
entry point (`ckpt/reshard.py`: save on mesh A, restore on mesh B).
"""

from __future__ import annotations

import io
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.ckpt import msgpack_codec
from repro_torch.core.store import StoreError, atomic_write_bytes, checksum
from repro_torch.distributed.placement import (ShardedTensor, shard,
                                               tree_shardings)
from repro_torch.params import tree_leaves, tree_map

#: Bump when the manifest schema or arrays encoding changes; restore
#: refuses other versions (the §13 stale-manifest contract).
CKPT_FORMAT_VERSION = 1

#: tmp directories of saves currently in flight IN THIS PROCESS — the
#: orphan sweep skips them so `latest_step()` racing an async save never
#: deletes the save out from under its own writer thread. Crashed saves
#: (a fresh process) have no entry here and get swept.
_ACTIVE_TMPS: set[str] = set()
_ACTIVE_LOCK = threading.Lock()


class CheckpointCorrupt(StoreError):
    """A checkpoint failed integrity verification; `.step` and `.problems`
    carry the structured diagnosis (the §13 never-load-garbage contract)."""

    def __init__(self, step: int, problems: list[str]):
        super().__init__(f"checkpoint step {step} failed verification: "
                         + "; ".join(problems))
        self.step = step
        self.problems = list(problems)


def _walk(tree, path=()):
    """(key path, leaf) in JAX's flattening order: dict keys sorted, list
    and tuple items by index, named-tuple fields in order under their
    names; None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _walk(v, path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def _flatten_with_paths(tree) -> tuple[list[str], list]:
    """The JAX manager's "/"-joined key paths and the leaves, in order."""
    flat = list(_walk(tree))
    return ["/".join(p) for p, _ in flat], [v for _, v in flat]


def _unflatten(like, leaves):
    """`like`'s structure with its leaves replaced, in `_walk` order."""
    it = iter(leaves)

    def build(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            new = {k: build(tree[k]) for k in sorted(tree)}
            return {k: new[k] for k in tree}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(build(v) for v in tree))
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v) for v in tree)
        return next(it)
    return build(like)


def _host(leaf) -> tuple[np.ndarray, str]:
    """A host numpy copy of a leaf and its dtype name as the JAX manager
    records it; bf16 tensors become 2-byte void entries named
    "bfloat16". A sharded leaf is gathered whole."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.dtype("V2"))
            return arr, "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """An npz entry as a CPU tensor, bf16 by the manifest's dtype name."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype_name)))


def sweep_orphan_tmps(directory: str) -> list[str]:
    """Remove `step_<N>.tmp` directories left by crashed saves; returns the
    names removed. Called from `save()` and `latest_step()` so orphans
    never accumulate. In-flight saves of THIS process (`_ACTIVE_TMPS`) are
    exempt."""
    if not os.path.isdir(directory):
        return []
    removed = []
    with _ACTIVE_LOCK:
        active = set(_ACTIVE_TMPS)
    for name in os.listdir(directory):
        if not re.fullmatch(r"step_\d+\.tmp", name):
            continue
        path = os.path.join(directory, name)
        if path in active:
            continue
        shutil.rmtree(path, ignore_errors=True)
        removed.append(name)
    return removed


def save(directory: str, step: int, tree: Any, *, keep: int = 3,
         process_index: int = 0) -> str:
    """Write the checkpoint of `step`; returns the final path."""
    os.makedirs(directory, exist_ok=True)
    sweep_orphan_tmps(directory)
    tmp = os.path.join(directory, f"step_{step:09d}.tmp")
    final = os.path.join(directory, f"step_{step:09d}")
    with _ACTIVE_LOCK:
        _ACTIVE_TMPS.add(tmp)
    try:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        keys, vals = _flatten_with_paths(tree)
        host = [_host(v) for v in vals]                # device -> host
        arrays_name = f"arrays.{process_index}.npz"
        buf = io.BytesIO()
        np.savez(buf, **{str(i): a for i, (a, _) in enumerate(host)})
        arrays_bytes = buf.getvalue()
        manifest = {
            "format_version": CKPT_FORMAT_VERSION,
            "keys": keys,
            "dtypes": [name for _, name in host],
            "shapes": [list(a.shape) for a, _ in host],
            "step": step,
            "checksums": {arrays_name: checksum(arrays_bytes)},
        }
        # Arrays first, manifest LAST: the manifest is the commit record —
        # verification treats "manifest present but an arrays file torn"
        # as corruption, and a crash before the manifest leaves a tmp dir
        # the sweep reclaims.
        atomic_write_bytes(os.path.join(tmp, arrays_name), arrays_bytes,
                           site="ckpt:arrays")
        atomic_write_bytes(os.path.join(tmp, "manifest.msgpack"),
                           msgpack_codec.packb(manifest),
                           site="ckpt:manifest")
        if os.path.exists(final):                      # re-save of same step
            shutil.rmtree(final)
        os.rename(tmp, final)                          # atomic commit
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE_TMPS.discard(tmp)
    _gc(directory, keep)
    return final


def save_async(directory: str, step: int, tree: Any, *,
               keep: int = 3) -> threading.Thread:
    """Fire-and-forget save on a worker thread; the tree is copied to host
    memory now (tensors onto the CPU, arrays copied), so training can go
    on updating the originals. Join the returned thread to wait."""
    keys, vals = _flatten_with_paths(tree)

    def snap(v):
        if isinstance(v, ShardedTensor):
            return v.gather("cpu")
        if isinstance(v, torch.Tensor):
            return v.detach().to("cpu", copy=True)
        return np.array(v)
    snapshot = _unflatten(tree, [snap(v) for v in vals])

    t = threading.Thread(target=save, args=(directory, step, snapshot),
                         kwargs={"keep": keep}, daemon=True)
    t.start()
    return t


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    sweep_orphan_tmps(directory)
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.msgpack")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _read_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        return msgpack_codec.unpackb(f.read())


def verify_step(directory: str, step: int) -> list[str]:
    """Integrity report for one checkpoint — empty list means valid.

    Checks, in order of how little can be trusted when they fail: manifest
    present and decodable, format version supported, every checksummed
    arrays file present with a matching blake2b. Content problems (wrong
    tree structure for a given `like`) are restore()'s job — they depend
    on the caller, not the bytes.
    """
    path = os.path.join(directory, f"step_{step:09d}")
    if not os.path.isdir(path):
        return [f"missing checkpoint directory {path}"]
    try:
        manifest = _read_manifest(path)
    except FileNotFoundError:
        return ["manifest missing"]
    except msgpack_codec.MsgpackError as exc:          # torn/garbled bytes
        return [f"manifest unreadable: {exc!r}"]
    if not isinstance(manifest, dict):
        return [f"manifest unreadable: {type(manifest).__name__} where a "
                "map was expected"]
    version = manifest.get("format_version")
    if version != CKPT_FORMAT_VERSION:
        return [f"unsupported format_version {version!r} "
                f"(expected {CKPT_FORMAT_VERSION})"]
    problems = []
    checksums = manifest.get("checksums", {})
    if not checksums:
        problems.append("manifest carries no checksums")
    for name, want in checksums.items():
        fpath = os.path.join(path, name)
        if not os.path.exists(fpath):
            problems.append(f"{name} missing")
            continue
        with open(fpath, "rb") as f:
            got = checksum(f.read())
        if got != want:
            problems.append(f"{name} checksum mismatch "
                            f"(manifest {want[:8]}.., file {got[:8]}..)")
    return problems


def valid_steps(directory: str) -> tuple[list[int], list[tuple[int, list]]]:
    """All complete steps split into (valid, [(step, problems), ...]),
    both newest-first."""
    steps = []
    if os.path.isdir(directory):
        sweep_orphan_tmps(directory)
        for name in os.listdir(directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                steps.append(int(m.group(1)))
    good, bad = [], []
    for s in sorted(steps, reverse=True):
        problems = verify_step(directory, s)
        (good.append(s) if not problems else bad.append((s, problems)))
    return good, bad


def latest_valid_step(directory: str
                      ) -> tuple[int | None, list[tuple[int, list]]]:
    """Newest checkpoint that passes verification, walking the keep-k
    chain back past corrupt ones. Returns (step or None, skipped), where
    skipped lists every NEWER checkpoint that failed, with its problems —
    callers surface these as counters."""
    good, bad = valid_steps(directory)
    best = good[0] if good else None
    skipped = [(s, p) for s, p in bad if best is None or s > best]
    return best, skipped


def restore(directory: str, step: int, like: Any, *,
            shardings: Any = None, verify: bool = True) -> Any:
    """Restore into the structure of `like`, a tree of tensors, sharded
    leaves (or numpy arrays): each tensor leaf comes back in the dtype of
    `like`'s leaf and placed as it is (on its device, a CUDA `like`
    restoring onto the card; a sharded leaf in blocks of its sharding),
    each other leaf as a CPU tensor of the stored dtype.

    `shardings` (a tree like `like` of `NamedSharding`s or None) places
    the leaves instead: a leaf with a sharding is laid out on it, a leaf
    with None comes back whole on its `like` leaf's device. This is the
    elastic-resharding entry point (save on mesh A, restore on mesh B).

    `verify=True` (default) checks format version + checksums first and
    raises `CheckpointCorrupt` instead of deserializing damaged bytes.
    A `like` whose key paths differ from the manifest's raises ValueError.
    """
    if verify:
        problems = verify_step(directory, step)
        if problems:
            raise CheckpointCorrupt(step, problems)
    path = os.path.join(directory, f"step_{step:09d}")
    manifest = _read_manifest(path)
    arrays = {}
    for name in sorted(os.listdir(path)):
        if name.startswith("arrays.") and name.endswith(".npz"):
            with np.load(os.path.join(path, name)) as z:
                for k in z.files:
                    arrays[int(k)] = z[k]

    keys, _ = _flatten_with_paths(like)
    if keys != manifest["keys"]:
        missing = set(manifest["keys"]) ^ set(keys)
        raise ValueError(f"checkpoint/model structure mismatch: "
                         f"{sorted(missing)[:5]} ...")
    stored = _unflatten(like, [_to_tensor(arrays[i], manifest["dtypes"][i])
                               for i in range(len(keys))])
    refs = iter(tree_leaves(like))
    targets = iter(tree_leaves(tree_shardings(like) if shardings is None
                               else shardings))

    def place(t):
        ref, target = next(refs), next(targets)
        placed = isinstance(ref, (torch.Tensor, ShardedTensor))
        if target is not None:
            return shard(t, target, dtype=ref.dtype if placed else None)
        if placed:
            return t.to(device=ref.device, dtype=ref.dtype)
        return t

    return tree_map(place, stored)


def _gc(directory: str, keep: int):
    steps = sorted(
        int(m.group(1)) for name in os.listdir(directory)
        if (m := re.fullmatch(r"step_(\d+)", name)))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)
