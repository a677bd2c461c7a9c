"""The tile mesh of device-sharded SimGNN serving — port of the tile part
of `repro.distributed.sharding` (DESIGN.md §16).

A `TileMesh` is an ordered list of devices over one axis, `TILE_AXIS`: the
leading [T, ...] axis of packed pair tiles and the prefilter's corpus
spans are split over it. Each member is a torch device with the CUDA
stream its shard launches on (None on the CPU). `tile_mesh(n)` takes the
first n devices of the engine's kind and raises, as the JAX helper does,
when there are fewer.

Logical devices. The JAX package runs the tile mesh on simulated host
devices (`--xla_force_host_platform_device_count`). The port's counterpart,
`force_logical_device_count(n, device)`, arms n logical devices over one
named physical device: `"cpu"` in the tests, `"cuda:0"` on a one-card
machine, where each logical device is its own CUDA stream on that card and
the sharded path runs real kernel launches. It is never armed implicitly;
`disarm_logical_devices()` undoes it, and `logical_devices(n, device)`
arms it for a `with` block only. With nothing armed a mesh holds
physical devices only: the CPU is one device, and a machine with N cards
has N.

`Runtime` carries the mesh into `ScoringEngine(runtime=...)` and the
search server. The LM mesh's rules (`_PARAM_RULES`, `param_spec`,
`param_shardings`, `constrain`, `batch_sharding`, `replicated`) and the
JAX `Runtime`'s LM fields are not ported yet.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device

#: the one axis of the tile mesh (DESIGN.md §16).
TILE_AXIS = "tile"

#: (physical device, count) of the armed logical devices, or None.
_LOGICAL: tuple[torch.device, int] | None = None


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


@dataclass
class Runtime:
    """The mesh threaded into `ScoringEngine(runtime=...)` and the search
    server; `mesh=None` keeps every path single-device."""
    mesh: TileMesh | None = None

    @property
    def n_devices(self) -> int:
        return self.mesh.size if self.mesh is not None else 1


def tile_runtime(n_devices: int | None = None, device=None) -> Runtime:
    """Runtime whose mesh is `tile_mesh(n_devices, device)`."""
    return Runtime(mesh=tile_mesh(n_devices, device))


def make_runtime(mesh: TileMesh | None) -> Runtime:
    """Runtime over `mesh` (None: single-device)."""
    return Runtime(mesh=mesh)
