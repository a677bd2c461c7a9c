"""Sharding — port of `repro.distributed.sharding`: the tile mesh of
device-sharded SimGNN serving and training (DESIGN.md §16), and the LM
mesh's named axes and param rules (DESIGN.md §6).

A `TileMesh` is an ordered list of devices over one axis, `TILE_AXIS`: the
leading [T, ...] axis of packed pair tiles and the prefilter's corpus
spans are split over it. Each member is a torch device with the CUDA
stream its shard launches on (None on the CPU). `tile_mesh(n)` takes the
first n devices of the engine's kind and raises, as the JAX helper does,
when there are fewer.

An `LMMesh` names its axes (`("data", "model")`, or `("pod", "data",
"model")` across pods) and holds its devices row-major, each with a
stream. Axis roles, as in the JAX package:
  pod    — data parallelism across pods;
  data   — data parallelism for the batch and storage sharding (FSDP) of
           the params and their optimizer state;
  model  — tensor parallelism: serving (`lm.prefill` / `decode_step` /
           `serve.step` with a runtime) and training (`lm.lm_loss` with
           a runtime, the mesh `train.step.build_train_step`) compute
           each layer's shard of heads, hidden units, Mamba channels and
           vocabulary on the members of a model row
           (`distributed.tensor_parallel`; the enc-dec model's too);
           a config that does not split over it trains on rows of one
           member.
`_PARAM_RULES` / `param_spec` give each param path its `P` spec (the JAX
package's rules, right-aligned to the leaf's rank, so the stacked group
axis is replicated); `param_shardings` turns them into `NamedSharding`s,
which `distributed.placement` uses to store a leaf as per-device blocks.
An uneven split raises ValueError: every config of the repo divides
evenly on its meshes, so the port need not invent a padded layout.
`resolve_spec` is the JAX `constrain`'s divisibility guard, the spec a
batch-sharded activation would take. Nothing in the port constrains
activations: a data-parallel replica already holds only its rows, and a
model row's member only its shard.

Logical devices. The JAX package runs its meshes on simulated host
devices (`--xla_force_host_platform_device_count`). The port's
counterpart, `force_logical_device_count(n, device)`, arms n logical
devices over one named physical device: `"cpu"` in the tests, `"cuda:0"`
on a one-card machine, where each logical device is its own CUDA stream
on that card and the sharded paths run real kernel launches. It is never
armed implicitly; `disarm_logical_devices()` undoes it, and
`logical_devices(n, device)` arms it for a `with` block only. With
nothing armed a mesh holds physical devices only: the CPU is one device,
and a machine with N cards has N.

`StreamFan` is how every sharded path runs work on the members' streams:
each member's stream waits for the caller's before its work, and the
caller's stream waits for all of them once every member is launched.

`Runtime` carries either mesh: a tile mesh into `ScoringEngine(runtime=
...)` and the search server, an LM mesh (with its `batch_axes` and
`tp_axis`) into `train.step.build_train_step` and the serving steps.

Hand-offs. `handoffs()` opens a `with` block that collects every
hand-off between mesh positions at the port's hand-off points, by kind:
{kind: {"bytes": n, "count": n}} (the dry run's counterpart of the JAX
package's collective bytes, `launch/step_analysis.py`). The points call
`note_handoff`; with no block open nothing is counted and the points do
no accounting work (`handoffs_open()`). The kinds:
  gather          — `placement.gather`: each distinct block read from a
                    position other than the destination's;
  shard           — `placement.shard`: each block written to a position
                    other than the source's (position 0);
  constrain_grads — the same for `train.step.constrain_grads`;
  grad_sum        — `train.step._mean_over_replicas`: each replica's
                    gradient but the first's, to the first device;
  param_cut       — `tensor_parallel.tp_layout` and the training row's
                    `member_params`: each member's slice for a position
                    other than the one holding the whole params;
  row_sum, row_gather — `tensor_parallel.row_sum` / `row_gather`: the
                    m - 1 partials or parts to the row's first member and,
                    unless the result stays there, the result to the m - 1
                    others;
  row_sum.backward, row_gather.backward, param_cut.backward — the same
                    bytes again when autograd runs the hand-off backward.
Each count is the hand-offs of one call, so a hand-off of B bytes to m - 1
members counts B (m - 1) bytes and m - 1 hand-offs.

Positions. `at_position(p)` names the mesh position whose work runs in
its `with` block (`StreamFan.member` with a position and `Row.map` open
one); `current_position()` reads it. The storage tracker of the dry run
attributes what is made inside to that position; with no tracker open
(`track_positions`) the blocks do nothing.
"""

from __future__ import annotations

import itertools
import math
import re
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from repro_torch.device import resolve_device

#: the one axis of the tile mesh (DESIGN.md §16).
TILE_AXIS = "tile"

#: (physical device, count) of the armed logical devices, or None.
_LOGICAL: tuple[torch.device, int] | None = None

#: the totals `handoffs()` collects into, or None
_HANDOFFS: dict | None = None

#: the stack of `at_position` blocks, or None while no tracker listens
_POSITIONS: list | None = None


@contextmanager
def handoffs():
    """Collect the hand-offs of the `with` block into the dict it yields,
    {kind: {"bytes": n, "count": n}} (module docstring); an enclosing
    block gets them too when this one ends."""
    global _HANDOFFS
    before, _HANDOFFS = _HANDOFFS, {}
    try:
        yield _HANDOFFS
    finally:
        if before is not None:
            for kind, v in _HANDOFFS.items():
                into = before.setdefault(kind, {"bytes": 0, "count": 0})
                into["bytes"] += v["bytes"]
                into["count"] += v["count"]
        _HANDOFFS = before


def handoffs_open() -> bool:
    """True inside a `handoffs()` block: the hand-off points count."""
    return _HANDOFFS is not None


def note_handoff(kind: str, nbytes: int, count: int = 1) -> None:
    """Add `count` hand-offs of `nbytes` bytes in all to `kind` of the
    open `handoffs()` block (nothing when none is open)."""
    if _HANDOFFS is None or count == 0:
        return
    into = _HANDOFFS.setdefault(kind, {"bytes": 0, "count": 0})
    into["bytes"] += int(nbytes)
    into["count"] += int(count)


def tensor_bytes(t) -> int:
    """The bytes of a tensor's elements."""
    return t.numel() * t.element_size()


@contextmanager
def track_positions():
    """Keep the `at_position` stack for the `with` block (the dry run's
    storage tracker reads it)."""
    global _POSITIONS
    before, _POSITIONS = _POSITIONS, []
    try:
        yield
    finally:
        _POSITIONS = before


@contextmanager
def at_position(position: int | None):
    """The work of the `with` block runs for mesh `position` (None: not
    named); a no-op unless `track_positions` is open."""
    if _POSITIONS is None or position is None:
        yield
        return
    _POSITIONS.append(position)
    try:
        yield
    finally:
        _POSITIONS.pop()


def current_position() -> int | None:
    """The innermost `at_position` of a tracked block, or None."""
    return _POSITIONS[-1] if _POSITIONS else None


def force_logical_device_count(n: int, device="cpu") -> int:
    """Arm `n` logical devices over the one physical `device` (the port's
    counterpart of `force_host_device_count`); returns the count of
    devices a mesh of that kind may now take. Meshes built before keep
    their members."""
    global _LOGICAL
    n = int(n)
    if n < 1:
        raise ValueError(f"need at least one logical device, got {n}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _LOGICAL = (dev, n)
    return n


def disarm_logical_devices() -> None:
    """Drop the armed logical devices: meshes take physical devices only."""
    global _LOGICAL
    _LOGICAL = None


@contextmanager
def logical_devices(n: int, device="cpu"):
    """`force_logical_device_count(n, device)` for the `with` block; the
    arming before it (or none) comes back after it. Meshes built inside
    keep their members."""
    global _LOGICAL
    before = _LOGICAL
    try:
        yield force_logical_device_count(n, device)
    finally:
        _LOGICAL = before


def _device_pool(kind: str) -> tuple[list[torch.device], bool]:
    """(devices a mesh of this kind may take, whether they are logical)."""
    if _LOGICAL is not None and _LOGICAL[0].type == kind:
        return [_LOGICAL[0]] * _LOGICAL[1], True
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())], False
    return [torch.device(kind)], False


@dataclass(frozen=True)
class TileMesh:
    """The tile axis' members in order: `devices[d]` scores shard d on
    `streams[d]` (a `torch.cuda.Stream`; None on the CPU). `logical` is
    True when the members are logical devices over one physical device."""
    devices: tuple
    streams: tuple
    logical: bool = False

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def kind(self) -> str:
        return self.devices[0].type

    def first(self, n: int) -> TileMesh:
        """The sub-mesh of the first `n` members (their streams shared)."""
        if not 1 <= n <= self.size:
            raise ValueError(f"sub-mesh of {n} devices from {self.size}")
        return TileMesh(self.devices[:n], self.streams[:n], self.logical)


def tile_mesh(n_devices: int | None = None, device=None) -> TileMesh:
    """1-D mesh over `TILE_AXIS` spanning the first `n_devices` devices of
    `device`'s kind (None = the card; all of them when `n_devices` is
    None). Raises when more are asked for than exist, unless logical
    devices were armed first (`force_logical_device_count`)."""
    kind = resolve_device(device).type
    pool, logical = _device_pool(kind)
    n = len(pool) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(pool):
        raise ValueError(
            f"tile_mesh: requested {n} devices, have {len(pool)} "
            "(use force_logical_device_count() to arm logical devices)")
    devices = tuple(pool[:n])
    streams = tuple(torch.cuda.Stream(device=d) if d.type == "cuda"
                    else None for d in devices)
    return TileMesh(devices, streams, logical)


class StreamFan:
    """Work fanned out over mesh members' streams and joined on the
    callers' streams.

    `with fan.member(stream) as (reads, out):` runs its block on `stream`
    (None: on the caller's stream, as on the CPU) after that stream has
    waited for the caller's (`position`: the mesh position it runs for,
    `at_position`). The block adds to `reads` the tensors made
    on the caller's stream that it reads (recorded on `stream` when the
    block ends) and to `out` what it makes for the caller. `join()` makes
    each caller's stream wait for every member's stream and records each
    `out` tensor on the caller's stream, so the caching allocator does not
    hand memory out while another stream may still use it. The caller
    waits only in `join`, after every member has been launched, so the
    members' work overlaps on the device."""

    def __init__(self):
        self._launched: list = []

    @contextmanager
    def member(self, stream, position: int | None = None):
        reads: list = []
        out: list = []
        if stream is None:
            with at_position(position):
                yield reads, out
            return
        caller = torch.cuda.current_stream(stream.device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream), at_position(position):
            yield reads, out
        for t in reads:
            t.record_stream(stream)
        self._launched.append((caller, stream, out))

    def join(self) -> None:
        for caller, stream, out in self._launched:
            caller.wait_stream(stream)
            for t in out:
                t.record_stream(caller)
        self._launched.clear()


# ------------------------------------------------------------ the LM mesh

class P(tuple):
    """A PartitionSpec: one entry per dim, each None (replicated), an axis
    name, or a tuple of axis names (the dim split over their product,
    row-major). A one-name tuple is stored as the name, as JAX's spec
    compares it; a P equals the tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# (regex over '/'-joined path, base spec for the *unstacked* param): the
# JAX package's rules, rule for rule.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed/table$",        ("model", "data")),   # [V, D] vocab-TP, D-FSDP
    (r"lm_head/w$",          ("data", "model")),   # [D, V]
    (r"(wq|wk|wv)$",         ("data", "model")),   # [D, H*hd]
    (r"(wq_b|wk_b|wv_b)$",   ("model",)),          # qkv bias [H*hd]
    (r"wo$",                 ("model", "data")),   # [H*hd, D]
    (r"mlp/w_in$",           ("data", "model")),   # [D, 2F] (fused gate+up)
    (r"mlp/w_out$",          ("model", "data")),   # [F, D]
    (r"moe/router$",         (None, None)),        # [D, E] small, replicated
    (r"moe/w_in$",           (None, "data", "model")),   # [E, D, 2F]
    (r"moe/w_out$",          (None, "model", "data")),   # [E, F, D]
    (r"mamba/in_proj$",      ("data", "model")),   # [D, 2*Din]
    (r"mamba/conv_w$",       ("model", None)),     # [Din, k]
    (r"mamba/conv_b$",       ("model",)),
    (r"mamba/x_proj$",       ("model", None)),     # [Din, R+2N]
    (r"mamba/dt_proj$",      (None, "model")),     # [R, Din]
    (r"mamba/dt_bias$",      ("model",)),
    (r"mamba/a_log$",        ("model", None)),     # [Din, N]
    (r"mamba/d$",            ("model",)),
    (r"mamba/out_proj$",     ("model", "data")),   # [Din, D]
    (r"rwkv/(wr|wk|wv|wg)$", ("data", "model")),
    (r"rwkv/wo$",            ("model", "data")),
    (r"rwkv/(w0|u)$",        ("model", None)),     # [H, K]
    (r"rwkv/(lora_a\w*)$",   (None, None)),        # tiny LoRAs, replicated
    (r"rwkv/(lora_b\w*)$",   (None, None)),
    (r"rwkv/(mix_\w+)$",     (None,)),
    (r"cmix/w_in$",          ("data", "model")),
    (r"cmix/w_out$",         ("model", "data")),
    (r"cmix/wr$",            ("data", "model")),
    (r"norm|scale|ln",       (None,)),             # norms replicated
]


def param_spec(path: str, ndim: int) -> P:
    """The spec of a param path, right-aligned to rank (the first matching
    rule; replicated when none matches)."""
    for pat, base in _PARAM_RULES:
        if re.search(pat, path):
            spec = tuple(base)
            if len(spec) > ndim:                # e.g. bias folded smaller
                spec = spec[-ndim:]
            return P(*((None,) * (ndim - len(spec)) + spec))
    return P(*((None,) * ndim))                 # default: replicated


def _path_str(path) -> str:
    """A key path (dict keys, list indices) as the JAX package joins it."""
    return "/".join(str(p) for p in path)


def map_with_path(fn, tree, path=()):
    """`fn(path_str, leaf)` over a nested dict / list / tuple tree (named
    tuples by field name), keeping its structure; the paths are the JAX
    package's `_path_str` of the same leaves."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, path + (n,))
                            for n, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(_path_str(path), tree)


@dataclass(frozen=True)
class LMMesh:
    """A mesh of named axes: `devices[i]` and `streams[i]` are the member
    at row-major position i of `axis_sizes` (streams None on the CPU).
    `logical` is True when the members are logical devices over one
    physical device. `origin`, for a mesh cut from another (a training
    model row), is each member's position in that mesh."""
    axis_names: tuple
    axis_sizes: tuple
    devices: tuple
    streams: tuple
    logical: bool = False
    origin: tuple | None = None

    @property
    def shape(self) -> dict:
        """{axis name: size}, as JAX's `Mesh.shape`."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, i: int) -> dict:
        """{axis name: coordinate} of row-major position i."""
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.axis_sizes))):
            out[name] = i % n
            i //= n
        return {name: out[name] for name in self.axis_names}

    def root(self, i: int) -> int:
        """Position i's position in the mesh this one was cut from (i
        itself when it was cut from none)."""
        return i if self.origin is None else self.origin[i]

    def position(self, coords: dict) -> int:
        """The row-major position of {axis name: coordinate} (0 for an
        axis not named)."""
        i = 0
        for name, n in zip(self.axis_names, self.axis_sizes):
            i = i * n + coords.get(name, 0)
        return i


def lm_mesh(axis_sizes, axis_names, device=None) -> LMMesh:
    """An `LMMesh` of `axis_sizes` over the first prod(axis_sizes) devices
    of `device`'s kind (None = the card): physical devices, or the armed
    logical devices (`force_logical_device_count`). Raises when fewer
    exist."""
    sizes, names = tuple(int(n) for n in axis_sizes), tuple(axis_names)
    if len(sizes) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh axes {names} do not fit shape {sizes}")
    kind = resolve_device(device).type
    pool, logical = _device_pool(kind)
    n = math.prod(sizes)
    if not 1 <= n <= len(pool):
        raise ValueError(
            f"lm_mesh: a {sizes} mesh needs {n} devices, have {len(pool)} "
            "(use force_logical_device_count() to arm logical devices)")
    devices = tuple(pool[:n])
    streams = tuple(torch.cuda.Stream(device=d) if d.type == "cuda"
                    else None for d in devices)
    return LMMesh(names, sizes, devices, streams, logical)


def _axes(entry) -> tuple:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


@dataclass(frozen=True)
class NamedSharding:
    """A layout of a tensor over an `LMMesh`: dim k is split over the
    axes of `spec[k]` (their product, row-major), the other axes hold
    copies."""
    mesh: LMMesh
    spec: P
    #: indices by shape (a layout is asked for its blocks at every step)
    _memo: dict = field(default_factory=dict, compare=False, repr=False)

    def _parts(self, shape) -> list[int]:
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        if len(spec) != len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {tuple(shape)} has dims")
        parts = []
        for dim, entry in zip(shape, spec):
            k = math.prod(self.mesh.shape[a] for a in _axes(entry))
            if dim % k:
                raise ValueError(
                    f"dim {dim} of shape {tuple(shape)} does not split "
                    f"evenly over {entry!r} ({k} parts) of spec "
                    f"{self.spec}")
            parts.append(k)
        return parts

    def shard_shape(self, shape) -> tuple:
        """The shape of one block; ValueError on an uneven split."""
        return tuple(d // k for d, k in zip(shape, self._parts(shape)))

    def indices(self, shape) -> list[tuple]:
        """Each mesh position's block, as a tuple of slices of `shape`
        (JAX's `devices_indices_map` in the mesh's row-major order)."""
        shape = tuple(shape)
        if shape not in self._memo:
            self._memo[shape] = self._indices(shape)
        return self._memo[shape]

    def distinct(self, shape) -> list[int]:
        """The first mesh position holding each distinct block."""
        key = ("distinct", tuple(shape))
        if key not in self._memo:
            seen, first = set(), []
            for i, sl in enumerate(self.indices(shape)):
                k = tuple(s.indices(d)[:2] for s, d in zip(sl, shape))
                if k not in seen:
                    seen.add(k)
                    first.append(i)
            self._memo[key] = first
        return self._memo[key]

    def _indices(self, shape) -> list[tuple]:
        block = self.shard_shape(shape)
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        out = []
        for i in range(self.mesh.size):
            c = self.mesh.coords(i)
            sl = []
            for size, entry in zip(block, spec):
                axes = _axes(entry)
                if not axes:
                    sl.append(slice(None))
                    continue
                k = 0
                for a in axes:
                    k = k * self.mesh.shape[a] + c[a]
                sl.append(slice(k * size, (k + 1) * size))
            out.append(tuple(sl))
        return out


@dataclass
class Runtime:
    """Mesh + axis roles threaded through the engine, the search server
    and the LM steps; `mesh=None` keeps every path single-device.
    `batch_axes` and `tp_axis` are read with an `LMMesh` only; serving
    takes `tp_axis` "model" only, the axis `_PARAM_RULES` cut by
    (`tensor_parallel.tp_layout` raises ValueError on another)."""
    mesh: TileMesh | LMMesh | None = None
    batch_axes: tuple = ("data",)            # ('pod','data') when multi-pod
    tp_axis: str = "model"

    @property
    def n_devices(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    @property
    def lm_mesh(self) -> LMMesh | None:
        """The mesh when it is an LM mesh, else None."""
        return self.mesh if isinstance(self.mesh, LMMesh) else None


def tile_runtime(n_devices: int | None = None, device=None) -> Runtime:
    """Runtime whose mesh is `tile_mesh(n_devices, device)`."""
    return Runtime(mesh=tile_mesh(n_devices, device))


def make_runtime(mesh: TileMesh | LMMesh | None, **kw) -> Runtime:
    """Runtime over `mesh` (None: single-device); a mesh with a "pod"
    axis takes its batch over ("pod", "data")."""
    if isinstance(mesh, LMMesh) and "pod" in mesh.axis_names:
        kw.setdefault("batch_axes", ("pod", "data"))
    return Runtime(mesh=mesh, **kw)


def param_shardings(rt: Runtime, params):
    """A tree like `params` of `NamedSharding`s by `param_spec` (None
    off-mesh). A leaf whose dims do not split evenly raises ValueError."""
    mesh = rt.lm_mesh

    def leaf(path, x):
        if mesh is None:
            return None
        s = NamedSharding(mesh, param_spec(path, x.ndim))
        s.shard_shape(tuple(x.shape))
        return s

    return map_with_path(leaf, params)


def resolve_spec(rt: Runtime, shape, *spec) -> P:
    """The spec the JAX `constrain` gives a tensor of `shape` on `rt`'s
    LM mesh: 'dp' expands to the batch axes, and an entry whose mesh size
    does not divide its dim (or exceeds it) is dropped, as the JAX guard
    drops it."""
    resolved = []
    for dim, s in zip(shape, spec):
        axes = rt.batch_axes if s == "dp" else s
        if axes is None:
            resolved.append(None)
            continue
        size = math.prod(rt.mesh.shape[a] for a in _axes(axes))
        resolved.append(axes if (dim % size == 0 and dim >= size) else None)
    return P(*resolved)


def replica_positions(mesh: LMMesh, batch_axes) -> list[int]:
    """The mesh position of each data-parallel replica: the first device
    of each coordinate of `batch_axes`, row-major (the order in which
    the batch dim is split over those axes)."""
    ranges = [range(mesh.shape[a]) for a in batch_axes]
    return [mesh.position(dict(zip(batch_axes, c)))
            for c in itertools.product(*ranges)]
