"""Placement of tensors on an LM mesh — the port's counterpart of
`jax.device_put(x, NamedSharding)` and `jax.device_get`.

A `ShardedTensor` is a leaf stored as one block per mesh position, cut by
its `NamedSharding`: position i holds `whole[sharding.indices(shape)[i]]`
on `mesh.devices[i]`. Every block is a tensor of its own (never a view of
a whole tensor), and positions that the spec does not split hold copies,
as a replicated axis does in JAX. Trees (`repro_torch.params`) treat a
`ShardedTensor` as one leaf, so params, gradients and optimizer moments
keep their structure when sharded.

`shard` / `shard_tree` lay whole tensors out (a None sharding leaves the
leaf as it is); `gather` / `gather_tree` put a whole tensor together on
one device from one block of each distinct index (a replica's copies are
read once). `tree_shardings` is the sharding of each leaf (None for a
whole tensor), the layout a restore or a reshard lands on.

Both count their hand-offs in an open `sharding.handoffs()` block: a
gather for mesh position p (default 0) the distinct blocks it reads from
other positions (a gather onto a device named without a position, such
as the host, reads every one from elsewhere); a shard from position 0
every block it writes at another position.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import sharding as _sharding
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.params import tree_leaves, tree_map


class ShardedTensor:
    """A leaf stored as per-device blocks (see the module docstring).
    `shape` is the whole tensor's; `dtype` and `device` are its blocks'
    (the device of position 0)."""

    __slots__ = ("blocks", "sharding", "shape")

    def __init__(self, blocks, sharding: NamedSharding, shape):
        self.blocks = tuple(blocks)
        self.sharding = sharding
        self.shape = torch.Size(shape)
        if len(self.blocks) != sharding.mesh.size:
            raise ValueError(f"{len(self.blocks)} blocks for a mesh of "
                             f"{sharding.mesh.size} devices")

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def with_blocks(self, blocks) -> ShardedTensor:
        """The same layout over new blocks (e.g. an update's outputs)."""
        return ShardedTensor(blocks, self.sharding, self.shape)

    def gather(self, device=None, position: int | None = None
               ) -> torch.Tensor:
        """The whole tensor on `device` (default: that of mesh `position`,
        default 0); `position` names the mesh position it is for."""
        if device is None:
            position = 0 if position is None else position
            device = self.blocks[position].device
        device = torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        indices = self.sharding.indices(self.shape)
        distinct = self.sharding.distinct(self.shape)
        for i in distinct:
            out[indices[i]].copy_(self.blocks[i])
        if _sharding.handoffs_open():
            far = [i for i in distinct if i != position]
            _sharding.note_handoff("gather", sum(
                _sharding.tensor_bytes(self.blocks[i]) for i in far),
                len(far))
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype},"
                f" spec={self.sharding.spec}, mesh="
                f"{self.sharding.mesh.axis_sizes})")


def shard(x, sharding: NamedSharding | None, dtype=None, *,
          kind: str = "shard"):
    """`x` (a tensor, an array or a ShardedTensor) laid out on `sharding`:
    one block copy per mesh position, each on its device. A None
    sharding gives a whole tensor on `x`'s device. `dtype` casts. The
    blocks written at positions other than 0 count as hand-offs of
    `kind` (module docstring)."""
    if isinstance(x, ShardedTensor):
        x = x.gather()
    x = torch.as_tensor(x)
    if dtype is not None:
        x = x.to(dtype)
    if sharding is None:
        return x
    blocks = []
    for sl, dev in zip(sharding.indices(tuple(x.shape)),
                       sharding.mesh.devices):
        part = x[sl]
        blocks.append(torch.empty(part.shape, dtype=part.dtype,
                                  device=dev).copy_(part))
    if _sharding.handoffs_open():
        _sharding.note_handoff(kind, sum(_sharding.tensor_bytes(b)
                                         for b in blocks[1:]),
                               len(blocks) - 1)
    return ShardedTensor(blocks, sharding, x.shape)


def gather(x, device=None, position: int | None = None) -> torch.Tensor:
    """A whole tensor from a leaf: a ShardedTensor's blocks put together
    on `device` (default: that of mesh `position`, default 0), a tensor
    moved there."""
    if isinstance(x, ShardedTensor):
        return x.gather(device, position)
    return x if device is None else x.to(device)


def shard_tree(tree, shardings, *, kind: str = "shard"):
    """Every leaf of `tree` laid out on its entry of `shardings` (a tree
    of the same structure); None entries leave their leaf as it is.
    Hand-offs count as `kind`."""
    it = iter(tree_leaves(shardings))

    def leaf(x):
        s = next(it)
        return x if s is None else shard(x, s, kind=kind)

    return tree_map(leaf, tree)


def gather_tree(tree, device=None, position: int | None = None):
    """Every leaf as a whole tensor on `device` (default: that of mesh
    `position`, default 0, of each leaf)."""
    return tree_map(lambda x: gather(x, device, position), tree)


def tree_shardings(tree):
    """The sharding of each leaf (None for a whole tensor)."""
    return tree_map(lambda x: x.sharding if isinstance(x, ShardedTensor)
                    else None, tree)
