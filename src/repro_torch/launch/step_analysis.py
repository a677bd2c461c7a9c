"""What one step computes, holds and moves, read off a run on the meta
device — the port's counterpart of `repro.launch.hlo_analysis`.

The JAX package compiles a step and parses its HLO: loop-corrected dot
FLOPs, per-device memory from `memory_analysis()`, collective bytes. The
port has no HLO; its steps run eagerly, and on meta tensors (shapes and
dtypes, no data) they run at any size on the host. `analyze(fn, n)` runs
`fn()` under three listeners:

  * matmul FLOPs: every operation that reaches the dispatcher, counted by
    `torch.utils.flop_counter`'s formulas (`flop_registry`: mm, bmm,
    addmm, baddbmm, convolutions, fused attention), as `FlopCounterMode`
    counts them but without its decompositions, which multiply the
    operations run on meta; the forward, the remat recompute and the
    backward as they run;
  * live storage: a dispatch mode that sees every tensor an operation
    makes, books each new storage (one not among the operation's inputs'
    storages, and not booked yet) at its bytes until its last reference
    dies (a weak reference to the storage), and keeps the peak of the sum.
    A storage made inside `sharding.at_position(p)` (a replica's
    `StreamFan.member`, a member's `Row.map`) is booked at position p,
    any other at the mesh as a whole ("unattributed"); storages that
    existed before the step (params, optimizer state, inputs) are not
    booked;
  * hand-offs between mesh positions: `sharding.handoffs()`.

`placed_bytes` reads the resident bytes of each mesh position from placed
trees: a `placement.ShardedTensor`'s block i at position i, a
`tensor_parallel.TPLayout`'s member i at position i, a `TPCache`'s blocks
at their rows' positions, and a whole tensor at position 0, each storage
once a position.

Only public or long-standing APIs are used (`TorchDispatchMode`,
`flop_registry`, `untyped_storage`, `weakref`), so the same code runs on
the CPU build and on the card's CUDA build.
"""

from __future__ import annotations

import time
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.placement import ShardedTensor
from repro_torch.params import tree_leaves


def _tensors(tree, out: list) -> list:
    """The tensors of an operation's arguments or results."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


class LiveStorage(TorchDispatchMode):
    """The dispatch mode of `analyze`'s listeners (module docstring):
    `flops` the matmul FLOPs, `peak` the most bytes booked at once,
    `peak_by_position` each position's most (None: unattributed)."""

    def __init__(self):
        super().__init__()
        self._live: dict = {}
        self.flops = 0
        self.now = 0
        self.peak = 0
        self.now_by_position: dict = defaultdict(int)
        self.peak_by_position: dict = defaultdict(int)

    def _book(self, st) -> None:
        key = id(st)
        nbytes = st.nbytes()
        pos = sharding.current_position()
        self._live[key] = (weakref.ref(st, lambda _: self._free(key)),
                           nbytes, pos)
        self.now += nbytes
        self.peak = max(self.peak, self.now)
        self.now_by_position[pos] += nbytes
        self.peak_by_position[pos] = max(self.peak_by_position[pos],
                                         self.now_by_position[pos])

    def _free(self, key) -> None:
        _, nbytes, pos = self._live.pop(key)
        self.now -= nbytes
        self.now_by_position[pos] -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        count = flop_registry.get(func._overloadpacket)
        if count is None:
            # an op that autograd would have decomposed (it reaches here
            # whole under inference mode): its parts, as `FlopCounterMode`
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        made = _tensors(out, [])
        if made:
            ins = {id(t.untyped_storage())
                   for t in _tensors((args, kwargs), [])}
            for t in made:
                st = t.untyped_storage()
                if id(st) not in ins and id(st) not in self._live:
                    self._book(st)
        return out


def analyze(fn, n_positions: int) -> dict:
    """Run `fn()` (on meta tensors) under the listeners of the module
    docstring. Returns {"flops", "peak_bytes" (the most bytes live at
    once), "peak_bytes_by_position" (a list over the `n_positions`
    positions), "unattributed_peak_bytes", "handoffs" ({kind: {"bytes",
    "count"}}), "handoff_bytes", "seconds"}."""
    t0 = time.perf_counter()
    with sharding.track_positions(), sharding.handoffs() as moved, \
            LiveStorage() as live:
        fn()
    by_pos = live.peak_by_position
    return {"flops": int(live.flops), "peak_bytes": live.peak,
            "peak_bytes_by_position": [by_pos.get(p, 0)
                                       for p in range(n_positions)],
            "unattributed_peak_bytes": by_pos.get(None, 0),
            "handoffs": {k: dict(v) for k, v in sorted(moved.items())},
            "handoff_bytes": sum(v["bytes"] for v in moved.values()),
            "seconds": time.perf_counter() - t0}


def placed_bytes(tree, n_positions: int) -> list[int]:
    """The bytes of the distinct storages each of `n_positions` mesh
    positions holds of `tree` (module docstring)."""
    seen = [dict() for _ in range(n_positions)]

    def add(pos, x):
        for t in tree_leaves(x):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                seen[pos][id(st)] = st.nbytes()

    def walk(x):
        if isinstance(x, ShardedTensor):
            for i, b in enumerate(x.blocks):
                add(i, b)
        elif isinstance(x, tp.TPLayout):
            for i, member in enumerate(x.members):
                add(i, member)
        elif isinstance(x, tp.TPCache):
            for row, blocks in zip(x.rows, x.blocks):
                for pos, member in zip(row, blocks):
                    add(pos, member)
        elif isinstance(x, torch.Tensor):
            add(0, x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return [sum(s.values()) for s in seen]
