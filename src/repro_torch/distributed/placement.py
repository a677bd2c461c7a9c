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
"""

from __future__ import annotations

import torch

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

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (default: position 0's)."""
        device = self.device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        indices = self.sharding.indices(self.shape)
        for i in self.sharding.distinct(self.shape):
            out[indices[i]].copy_(self.blocks[i])
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype},"
                f" spec={self.sharding.spec}, mesh="
                f"{self.sharding.mesh.axis_sizes})")


def shard(x, sharding: NamedSharding | None, dtype=None):
    """`x` (a tensor, an array or a ShardedTensor) laid out on `sharding`:
    one block copy per mesh position, each on its device. A None
    sharding gives a whole tensor on `x`'s device. `dtype` casts."""
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
    return ShardedTensor(blocks, sharding, x.shape)


def gather(x, device=None) -> torch.Tensor:
    """A whole tensor from a leaf: a ShardedTensor's blocks put together
    on `device` (default: its position 0's), a tensor moved there."""
    if isinstance(x, ShardedTensor):
        return x.gather(device)
    return x if device is None else x.to(device)


def shard_tree(tree, shardings):
    """Every leaf of `tree` laid out on its entry of `shardings` (a tree
    of the same structure); None entries leave their leaf as it is."""
    it = iter(tree_leaves(shardings))

    def leaf(x):
        s = next(it)
        return x if s is None else shard(x, s)

    return tree_map(leaf, tree)


def gather_tree(tree, device=None):
    """Every leaf as a whole tensor on `device` (default: each leaf's
    own position-0 device)."""
    return tree_map(lambda x: gather(x, device), tree)


def tree_shardings(tree):
    """The sharding of each leaf (None for a whole tensor)."""
    return tree_map(lambda x: x.sharding if isinstance(x, ShardedTensor)
                    else None, tree)
