"""Elastic resharding: move a checkpoint or a live tree from mesh A to
mesh B — port of `repro.ckpt.reshard`.

Checkpoints store whole leaves (`ckpt/manager.py` gathers sharded ones),
so restoring onto another mesh is a restore with the target mesh's
`NamedSharding`s: the elastic-scaling path when the fleet grows or
shrinks between restarts (DESIGN.md §6). `reshard_live` re-lays-out an
in-memory tree without a round trip through disk (for in-job elasticity,
where the runtime re-forms the mesh after losing a slice).
`train_state_shardings` is the target layout of a training state.
"""

from __future__ import annotations

from repro_torch.ckpt import manager
from repro_torch.distributed.placement import shard_tree
from repro_torch.distributed.sharding import Runtime, param_shardings
from repro_torch.train.optimizer import AdamWState


def train_state_shardings(rt: Runtime, params):
    """The layout of a (params, AdamW state) tree on `rt`'s mesh: the
    param rules' shardings for the params and both moments, the step
    counter whole (every entry None off-mesh)."""
    ps = param_shardings(rt, params)
    return ps, AdamWState(step=None, m=ps, v=ps)


def reshard_live(tree, shardings):
    """Every leaf of `tree` gathered and laid out on its entry of
    `shardings` (a tree like `tree`); a None entry leaves its leaf as it
    is, as in the JAX function."""
    return shard_tree(tree, shardings)


def restore_on_mesh(directory: str, step: int, like, shardings):
    """Restore a checkpoint saved on any mesh onto `shardings` (the
    target mesh's; None entries come back whole on `like`'s devices)."""
    return manager.restore(directory, step, like, shardings=shardings)
