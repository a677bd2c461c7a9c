"""Durable shard store: crash-safe persistence for precomputed state — the
port's copy of `repro.core.store` (numpy only; the bytes on disk, the
manifest and `tree_digest` equal the JAX package's, so an index saved by
either package loads in the other).

  * `atomic_write_bytes` — tmp + flush + fsync + rename, then fsync on the
    containing directory. It is also the filesystem fault seam: tests arm
    `_FS_HOOK` to tear, bit-flip or drop exactly the bytes they choose.
  * `ShardStore` — a directory of raw row-shard files described by ONE
    versioned JSON manifest written last, atomically, recording per-shard
    shape / dtype / blake2b checksum and the WL `graph_key`s each shard
    covers, so a loader verifies every shard and rebuilds only bad ones.

Layout:

    <dir>/manifest.json              versioned manifest (atomic, last)
    <dir>/shard_00000.bin            raw C-order rows (atomic, checksummed)

Error taxonomy: `ManifestError` (the directory as a whole cannot be
trusted) vs per-shard statuses "ok" | "missing" | "corrupt" from `verify()`;
`StoreError` is the common base.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

#: Bump when the manifest schema or shard byte layout changes. A reader
#: that sees any other version MUST refuse (ManifestError) rather than
#: guess: shard descriptions it misparses would deserialize garbage that
#: passes no further check.
STORE_FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"

#: Rows per shard for the similarity-search index (DESIGN.md §13/§14).
#: Doubles as the retrieval prefilter's column-block size so the streaming
#: top-M scan's sequential block loop walks the corpus in 1:1
#: correspondence with the persisted shards — the partition unit a later
#: multi-process sharded server distributes. Keep it a power of two no
#: larger than `kernels.retrieval.RETRIEVAL_MAX_BLOCK_COLS`.
DEFAULT_SHARD_ROWS = 256


class StoreError(RuntimeError):
    """Base class for durable-state failures (structured, never silent)."""


class ManifestError(StoreError):
    """The manifest is missing, unreadable, or a format version this
    reader does not understand — nothing in the directory can be trusted,
    so recovery is rebuild-from-source, not selective repair."""


#: Filesystem fault seam (DESIGN.md §13): tests arm this with a hook
#: mapping (site, path, data) -> data | None;
#: production leaves it None (one attribute read per durable write).
#: Returning None simulates a write the caller believes succeeded but
#: never reached disk ("missing"); returning mutated bytes simulates torn
#: writes / bit rot that survived the fsync path.
_FS_HOOK: Callable | None = None


def _fs(site: str, path: str, data: bytes) -> bytes | None:
    hook = _FS_HOOK
    return hook(site, path, data) if hook is not None else data


def checksum(data: bytes) -> str:
    """Content checksum used by both the shard store and the checkpoint
    manager — blake2b-128 hex (collision floor far below disk-error rates,
    ~an order of magnitude faster than sha256 on large arrays)."""
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def atomic_write_bytes(path: str, data: bytes, *, site: str = "store:blob"
                       ) -> None:
    """Durably write `data` to `path`: tmp file + flush + fsync + atomic
    rename + directory fsync. A crash at ANY point leaves either the old
    complete file or no file — never a prefix. `site` names this write for
    the fault seam."""
    data = _fs(site, path, data)
    if data is None:                 # injected lost write
        return
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


class _DictKey:
    """Writes a dict step of a key path as JAX's `DictKey` reprs it."""

    def __init__(self, key):
        self.key = key

    def __repr__(self) -> str:
        return f"DictKey(key={self.key!r})"


class _SequenceKey:
    """Writes a list/tuple step of a key path as JAX's `SequenceKey`."""

    def __init__(self, idx: int):
        self.idx = idx

    def __repr__(self) -> str:
        return f"SequenceKey(idx={self.idx!r})"


def _leaves_with_path(tree, path=()):
    """(key path, leaf) in JAX's flattening order: dict keys sorted, list
    and tuple items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (_DictKey(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (_SequenceKey(i),))
    else:
        yield path, tree


def _host_array(leaf) -> np.ndarray:
    """A host numpy copy of a leaf; tensors (bf16 included) go through
    `params_to_numpy`, so their dtype names and bytes are the JAX arrays'."""
    if hasattr(leaf, "detach"):
        from repro_torch.params import params_to_numpy

        return params_to_numpy(leaf)
    return np.asarray(leaf)


def tree_digest(tree) -> str:
    """Checksum of a parameter tree (key paths + dtype names + leaf bytes):
    the store stamps it into index manifests so an index built by one model
    can never silently serve under another's params. Equal to the JAX
    package's `tree_digest` of the same tree: each key path is hashed as
    the `repr` of JAX's key-path tuple."""
    h = hashlib.blake2b(digest_size=16)
    for path, leaf in _leaves_with_path(tree):
        arr = _host_array(leaf)
        h.update(repr(path).encode())
        h.update(str(arr.dtype).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


@dataclass(frozen=True)
class ShardInfo:
    """One shard as the manifest describes it (the trusted side of every
    integrity comparison)."""
    name: str                        # file name inside the store directory
    shape: tuple                     # row-shard shape, C order
    dtype: str
    checksum: str                    # blake2b-128 hex of the file bytes
    graph_keys: tuple = ()           # hex WL key per row (optional)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)
                   * np.dtype(self.dtype).itemsize)


class ShardStore:
    """Integrity-verified row-sharded array persistence in one directory.

    `write()` replaces the store's contents atomically-enough for readers:
    shards land first (each individually atomic), the manifest last — a
    reader concurrent with a writer (or after a mid-write crash) sees a
    complete manifest whose shards either verify or are individually
    reported bad. `verify()`/`read_shard()` never return bytes that fail
    their manifest checksum.
    """

    def __init__(self, directory: str):
        self.directory = str(directory)

    # -------------------------------------------------------------- writing

    def write(self, matrix: np.ndarray, *, shard_rows: int = 1024,
              graph_keys: Sequence[str] | None = None,
              meta: dict | None = None) -> dict:
        """Persist `matrix` as row shards + manifest; returns the manifest.

        `graph_keys` (hex strings, one per row) record which WL-keyed
        graphs each shard covers so a loader can re-embed exactly the rows
        a bad shard loses. `meta` is caller context stored verbatim
        (model digest, dims, flags).
        """
        matrix = np.ascontiguousarray(matrix)
        if graph_keys is not None and len(graph_keys) != matrix.shape[0]:
            raise ValueError(f"{len(graph_keys)} graph_keys for "
                             f"{matrix.shape[0]} rows")
        if shard_rows < 1:
            raise ValueError(f"shard_rows must be >= 1, got {shard_rows}")
        os.makedirs(self.directory, exist_ok=True)
        shards = []
        for i, row0 in enumerate(range(0, max(matrix.shape[0], 1),
                                       shard_rows)):
            part = matrix[row0:row0 + shard_rows]
            name = f"shard_{i:05d}.bin"
            data = part.tobytes()
            atomic_write_bytes(os.path.join(self.directory, name), data,
                               site="store:shard")
            shards.append({
                "name": name, "shape": list(part.shape),
                "dtype": str(part.dtype), "checksum": checksum(data),
                "graph_keys": (list(graph_keys[row0:row0 + part.shape[0]])
                               if graph_keys is not None else []),
            })
        manifest = {"format_version": STORE_FORMAT_VERSION,
                    "shape": list(matrix.shape), "dtype": str(matrix.dtype),
                    "shards": shards, "meta": dict(meta or {})}
        # Manifest LAST: its atomic rename is the commit point of the whole
        # write — a crash before it leaves the previous index intact.
        atomic_write_bytes(os.path.join(self.directory, MANIFEST_NAME),
                           json.dumps(manifest, indent=1).encode(),
                           site="store:manifest")
        # Shards beyond this manifest's coverage (a previous, larger index)
        # are dead bytes a future writer would half-overwrite: sweep them.
        live = {s["name"] for s in shards}
        for fname in os.listdir(self.directory):
            if (fname.startswith("shard_") and fname.endswith(".bin")
                    and fname not in live):
                os.remove(os.path.join(self.directory, fname))
        return manifest

    # -------------------------------------------------------------- reading

    def manifest(self) -> dict:
        """Load + validate the manifest; raises ManifestError when the
        directory as a whole cannot be trusted (missing / unparseable /
        unknown format version / missing required fields)."""
        path = os.path.join(self.directory, MANIFEST_NAME)
        if not os.path.exists(path):
            raise ManifestError(f"no manifest at {path}")
        try:
            with open(path, "rb") as f:
                man = json.loads(f.read().decode())
        except (ValueError, UnicodeDecodeError) as exc:
            raise ManifestError(f"unreadable manifest at {path}: {exc}")
        version = man.get("format_version")
        if version != STORE_FORMAT_VERSION:
            raise ManifestError(
                f"manifest format_version {version!r} != supported "
                f"{STORE_FORMAT_VERSION} at {path}: refusing to guess the "
                "shard layout")
        for field in ("shape", "dtype", "shards"):
            if field not in man:
                raise ManifestError(f"manifest at {path} missing {field!r}")
        return man

    def shard_infos(self, man: dict | None = None) -> list[ShardInfo]:
        man = self.manifest() if man is None else man
        return [ShardInfo(name=s["name"], shape=tuple(s["shape"]),
                          dtype=s["dtype"], checksum=s["checksum"],
                          graph_keys=tuple(s.get("graph_keys", ())))
                for s in man["shards"]]

    def verify_shard(self, info: ShardInfo) -> str:
        """"ok" | "missing" | "corrupt" — corrupt covers size mismatch
        (torn write) and checksum mismatch (bit rot) alike: either way the
        bytes are not the bytes the manifest committed."""
        path = os.path.join(self.directory, info.name)
        if not os.path.exists(path):
            return "missing"
        if os.path.getsize(path) != info.nbytes:
            return "corrupt"
        with open(path, "rb") as f:
            if checksum(f.read()) != info.checksum:
                return "corrupt"
        return "ok"

    def read_shard(self, info: ShardInfo, *, mmap: bool = True,
                   verify: bool = True) -> np.ndarray:
        """Checksummed shard read-back; `mmap=True` returns a read-only
        memmap view (zero-copy until touched). Raises StoreError rather
        than returning bytes that fail verification."""
        if verify:
            status = self.verify_shard(info)
            if status != "ok":
                raise StoreError(f"shard {info.name} is {status}")
        path = os.path.join(self.directory, info.name)
        if mmap:
            return np.memmap(path, dtype=np.dtype(info.dtype), mode="r",
                             shape=info.shape)
        with open(path, "rb") as f:
            return np.frombuffer(f.read(), dtype=np.dtype(info.dtype)
                                 ).reshape(info.shape)

    def verify(self) -> dict:
        """Whole-store integrity report: {shard name: status}. Manifest
        problems raise ManifestError (there is no per-shard story without
        a trusted manifest)."""
        return {info.name: self.verify_shard(info)
                for info in self.shard_infos()}
