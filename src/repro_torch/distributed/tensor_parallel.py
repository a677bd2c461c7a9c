"""Tensor parallelism over an LM mesh's `model` axis, for serving and
training — the port's counterpart of the JAX package's serving and train
steps on a mesh, where XLA partitions every layer by the `model` entries
of `_PARAM_RULES` (DESIGN.md §6).

Layout. `tp_layout(params, cfg, rt)` cuts every leaf once into the slice
one member of a model row computes with. The role of a leaf comes from
the `model` entry of its rule (`sharding.param_spec`):
  column     — wq/wk/wv and their biases, `mlp/w_in`, `moe/w_in`,
               `mamba/in_proj`, `conv_w`, `conv_b`, `dt_proj`, `dt_bias`,
               `a_log`, `d`, `rwkv/(wr|wk|wv|wg)`, `w0`, `u`, `cmix/w_in`
               and `cmix/wr`: the member holds its heads, hidden units,
               channels or columns;
  row        — `wo`, `mlp/w_out`, `moe/w_out`, `mamba/out_proj`,
               `mamba/x_proj`, `rwkv/wo` and `cmix/w_out`: the member's
               product is a partial sum over the whole width;
  vocab      — `embed/table` rows and `lm_head/w` columns;
  replicated — everything else (router, norms, LoRAs, `mix_*`).
The rules' `data` entries are a storage (FSDP) layout: a serving member
holds its `model` slice whole along D. The fused weights `mlp/w_in` [D,
2F], `moe/w_in` [E, D, 2F] and `mamba/in_proj` [D, 2 Din] hold [gate | up]
and [x | z] side by side; member k gets the block [gate_k | up_k] (and
[x_k | z_k]), not the k-th contiguous block, so `chunk(2)` in
`swiglu_mlp` and `mamba_in` and the expert kernel's "gate = the first F
columns" hold unchanged on its slice. Splits are of whole heads and whole
GQA groups (member k's q heads read its own kv heads): `check_splits`
raises ValueError, naming the config and the dim, where a count does not
divide, as `param_shardings` raises on an uneven split; nothing is
replicated or padded to make one fit. Every slice is a contiguous tensor
of its own on its member's device (the kernel wrappers check exact
contiguous shapes); positions that hold the same member on one device
(logical devices) share one tree.

An enc-dec model (seamless) takes the same rules: the encoder's
`enc_groups` blocks are cut as a decoder's (q/k/v columns and `wo` rows
by heads, the FFN by hidden units), and so is the decoder's
cross-attention, `xattn/(wq|wk|wv)` by heads and `xattn/wo` by rows, so a
member's cross-attention gives a partial sum that is reduced like the
mixer's. `enc_out` is whole on every member: each computes
`enc_final_norm` over the row sum of the last encoder layer, and the
cross-attention's K and V come from that whole `enc_out` through the
member's columns.

Rows. A step splits its batch over the data-parallel replicas of
`rt.batch_axes` (`sharding.replica_positions`; one replica when they do
not divide the batch, as the JAX guard drops the axis); replica r's model
row is the members at its coordinates and every coordinate of `model`
(RULE_AXIS: the axis the rules cut by, which is also the one the rows
run along; a runtime whose `tp_axis` names another axis raises
ValueError). A `Row` runs each member's work on its member's stream
(`Row.map`). `row_sum` sums partials in float32, in member order, on the
row's first member, rounds once to the activation dtype and hands the
result to every member; a row of one member adds nothing and rounds
nothing, so a (1, 1) mesh is bit-equal to unsharded serving.
`row_gather` concatenates the members' parts. Every hand-off between
streams follows `distributed.pipeline`: the receiving stream waits for an
event recorded right after the producer's work, `record_stream` marks the
tensor as used there, and between separate cards the copy is `.to(device,
non_blocking=True)` on the receiving stream (written, not exercised: the
tests and the smoke run use the CPU and logical devices over one card).
The members' streams wait for the caller's when a step's rows are made,
and the caller's stream waits for every member's when they are closed.

Training. `member_params(..., grad=True)` cuts the same slices with
differentiable operations (`narrow`, the fused halves' `cat`,
`contiguous`, `.to(device)`; a replicated leaf is the leaf itself), so
autograd hands each whole leaf its gradient: a cut leaf's is its
members' parts in place, the fused halves too; a replicated leaf's
(norms, router, LoRAs, `mix_*`) is the sum over the members that read
it. The row hand-offs are autograd's as they stand: `put`, `spread` and
`take` hand the same tensor on (or `.to()` it, between cards), so the
backward of `row_sum` followed by `spread` sums the members' incoming
gradients and hands the sum to every partial, and that of `row_gather`
cuts its incoming gradient into the members' parts. Autograd runs each
backward op on the stream of its forward op and makes a consumer's
stream wait for the producer's where gradients cross streams;
`Row.enter` makes the members' streams wait for the current stream
before a layer group, which in the backward is the stream that asks for
the group's remat recompute, and `wait_for_mesh` hands the gradients of
every member's stream to the caller's. A training row takes whole heads,
groups and hidden units too; where `cfg` does not split over the
`model` axis (`unsplit_dim`), its rows are one member, as a batch that
the replicas cannot split runs as one replica (`train_row_size`). An
enc-dec model trains on the same rows (`encdec.encdec_loss`): the
encoder's and the cross-attention's leaves are cut as in serving, and
each member's `enc_out` is its own copy of the row sum's output, so the
backward of that row sum adds up the members' partial gradients of
`enc_out` before the encoder's layers.

Caches. A step's decode cache is a `TPCache`: each member's cache in
`lm.init_cache`'s layout with its heads' K/V, its channels' Mamba states
and its heads' wkv states; the `pos` planes and the shift states are
whole on every member. `gather_caches` assembles the unsharded layout.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch

from repro_torch.distributed import placement
from repro_torch.distributed.pipeline import _cross, _done
from repro_torch.distributed.sharding import (LMMesh, Runtime, _axes,
                                             at_position, handoffs_open,
                                             map_with_path, note_handoff,
                                             param_spec, replica_positions,
                                             tensor_bytes)
from repro_torch.params import tree_leaves, tree_map

#: the axis that the param rules name for tensor parallelism
RULE_AXIS = "model"
#: leaves that hold two halves side by side along their last dim
_FUSED = re.compile(r"(mlp/w_in|moe/w_in|mamba/in_proj)$")


def _split_dims(cfg) -> list[tuple[str, int]]:
    """(name, size) of every count a model row splits for `cfg`: the
    decoder's layers', and an enc-dec model's encoder blocks (attention
    and a dense FFN) and cross-attention (heads), each name once."""
    kinds, moes = cfg.layer_kinds(), cfg.layer_is_moe()
    dims = [("vocab_padded", cfg.vocab_padded)]
    if cfg.is_enc_dec or any(k in ("attn", "attn_local") for k in kinds):
        dims += [("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads)]
    if "mamba" in kinds:
        dims.append(("mamba_d_inner", cfg.mamba_d_inner))
    if "rwkv" in kinds:
        dims.append(("n_rwkv_heads", cfg.n_rwkv_heads))
    if cfg.is_enc_dec or any(k == "rwkv" or not moe
                             for k, moe in zip(kinds, moes)):
        dims.append(("d_ff", cfg.d_ff))
    if any(moes):
        dims.append(("d_ff_expert", cfg.d_ff_expert))
    return dims


def unsplit_dim(cfg, m: int) -> str | None:
    """"name=n" of the first count of `cfg` that a model row of `m`
    members cannot take whole (heads, GQA groups, hidden units), or
    None."""
    for name, n in _split_dims(cfg):
        if n % m:
            return f"{name}={n}"
    return None


def check_splits(cfg, m: int) -> None:
    """ValueError naming the config and the dim when a model row of `m`
    members cannot take whole heads, groups and hidden units of `cfg`."""
    bad = unsplit_dim(cfg, m)
    if bad is not None:
        raise ValueError(
            f"{cfg.name}: {bad} does not split evenly over {m} "
            f"members of a model row (tensor-parallel serving splits "
            f"whole heads, GQA groups and hidden units)")


def train_row_size(cfg, mesh: LMMesh) -> tuple[int, str | None]:
    """(the members of a training model row on `mesh`, why it is one
    member where the `model` axis has more): the axis' size where `cfg`
    splits over it; else 1, as a batch the replicas cannot split runs as
    one replica."""
    m = mesh.shape.get(RULE_AXIS, 1)
    if m == 1:
        return 1, None
    bad = unsplit_dim(cfg, m)
    if bad is not None:
        return 1, f"{bad} does not split over {m} members"
    return m, None


def member_params(tree, k: int, m: int, device, *, grad: bool = False):
    """Member k of m's slice of every leaf of `tree` (whole tensors; a
    subtree works too, since the rules match the paths' ends), each a
    contiguous tensor of its own on `device` (module docstring). With
    `grad` the slices are cut by differentiable operations and a slice
    that is the whole leaf (replicated, or m = 1) is the leaf itself on
    `device`, so gradients reach the leaves of `tree`."""

    def leaf(path, x):
        spec = param_spec(path, x.ndim)
        dims = [i for i, e in enumerate(spec) if RULE_AXIS in _axes(e)]
        part = x
        if dims and m > 1:
            dim = dims[0]
            if x.shape[dim] % (2 * m if _FUSED.search(path) else m):
                raise ValueError(f"{path}: dim {dim} of {tuple(x.shape)} "
                                 f"does not split over {m} members")
            if _FUSED.search(path):
                part = torch.cat([h.chunk(m, dim)[k]
                                  for h in x.chunk(2, dim)], dim)
            else:
                n = x.shape[dim] // m
                part = x.narrow(dim, k * n, n)
        if grad:
            return part.contiguous().to(device)
        return torch.empty(part.shape, dtype=part.dtype,
                           device=device).copy_(part)

    return map_with_path(leaf, tree)


@dataclass(frozen=True)
class TPLayout:
    """Each mesh position's param slices: `members[i]` is the tree of
    mesh position i (member `mesh.coords(i)[RULE_AXIS]` of its row) on
    that position's device. What `tp_layout` returns and the serving
    steps take in place of params."""
    cfg_name: str
    mesh: LMMesh
    batch_axes: tuple
    members: tuple

    @property
    def model_size(self) -> int:
        return self.mesh.shape.get(RULE_AXIS, 1)

    def rows(self, batch: int) -> tuple:
        """The mesh positions of each replica's model row for a batch of
        `batch` rows (`model_rows`)."""
        return model_rows(self.mesh, self.batch_axes, batch,
                          self.model_size)


def model_rows(mesh: LMMesh, batch_axes, batch: int, m: int) -> tuple:
    """The mesh positions of each replica's model row of `m` members
    (coordinates 0 .. m - 1 of `model`) for a batch of `batch` rows: one
    replica a coordinate of the batch axes, or one replica when they do
    not divide the batch."""
    first = replica_positions(mesh, [a for a in batch_axes
                                     if a in mesh.shape])
    n = len(first)
    if n == 1 or batch % n or batch < n:
        first = first[:1]
    return tuple(row_positions(mesh, p, m) for p in first)


def row_positions(mesh: LMMesh, position: int, m: int) -> tuple:
    """The mesh positions of the model row of `m` members through mesh
    `position` (its coordinates, `model` from 0 to m - 1)."""
    c = mesh.coords(position)
    return tuple(mesh.position({**c, RULE_AXIS: k}) for k in range(m))


def row_runtime(mesh: LMMesh, positions) -> Runtime:
    """A runtime whose mesh is the one model row at mesh `positions`
    (a `("model",)` mesh of those members, one replica, its `origin` the
    members' positions): what the train step hands each replica's
    loss."""
    pos = tuple(positions)
    return Runtime(mesh=LMMesh((RULE_AXIS,), (len(pos),),
                               tuple(mesh.devices[p] for p in pos),
                               tuple(mesh.streams[p] for p in pos),
                               mesh.logical,
                               tuple(mesh.root(p) for p in pos)),
                   batch_axes=())


def tp_layout(params, cfg, rt: Runtime) -> TPLayout:
    """The serving layout of `params` (whole tensors or
    `placement.ShardedTensor`s, gathered first) on `rt`'s LM mesh; built
    once and passed to the steps in place of params."""
    mesh = rt.lm_mesh
    if mesh is None:
        raise ValueError("tp_layout needs a runtime whose mesh is an LMMesh")
    if rt.tp_axis != RULE_AXIS:
        raise ValueError(f"tensor-parallel serving runs along the axis the "
                         f"param rules cut by, {RULE_AXIS!r}; the runtime "
                         f"names {rt.tp_axis!r}")
    m = mesh.shape.get(RULE_AXIS, 1)
    check_splits(cfg, m)
    whole = tree_map(placement.gather, params)
    made, members = {}, []
    for i, dev in enumerate(mesh.devices):
        k = mesh.coords(i).get(RULE_AXIS, 0)
        if (k, dev) not in made:
            made[(k, dev)] = member_params(whole, k, m, dev)
        members.append(made[(k, dev)])
        if i and handoffs_open():       # the whole params sit at position 0
            leaves = tree_leaves(members[-1])
            note_handoff("param_cut", sum(map(tensor_bytes, leaves)),
                         len(leaves))
    return TPLayout(cfg.name, mesh,
                    tuple(a for a in rt.batch_axes if a in mesh.shape),
                    tuple(members))


def serving_layout(params, cfg, rt: Runtime | None) -> TPLayout | None:
    """The layout a serving step runs on: None without an LM mesh (today's
    path), `params` itself when it is a layout of `rt`'s mesh, else
    `tp_layout(params, cfg, rt)`."""
    if rt is None or rt.lm_mesh is None:
        if isinstance(params, TPLayout):
            raise ValueError("a TPLayout needs the runtime of its mesh")
        return None
    if isinstance(params, TPLayout):
        if params.mesh != rt.lm_mesh or params.cfg_name != cfg.name:
            raise ValueError("the TPLayout was built for another mesh or "
                             "config")
        return params
    return tp_layout(params, cfg, rt)


class _OneRow:
    """A row of one member that runs on the caller's stream: what the
    single-device path runs its blocks on (`lm.apply_block`)."""
    size = 1

    def enter(self) -> None:
        pass

    def map(self, fn, *per_member) -> list:
        return [fn(0, *(a[0] for a in per_member))]


#: the single-device path's row
SOLO = _OneRow()


class Row:
    """The members of one model row, at mesh `positions`, for a caller on
    `caller_device`: `devices[k]`, `streams[k]` (None on the CPU). Made,
    every member's stream waits for the caller's."""

    def __init__(self, mesh: LMMesh, positions, caller_device):
        self.positions = tuple(positions)
        self.roots = tuple(mesh.root(p) for p in self.positions)
        self.devices = [mesh.devices[p] for p in self.positions]
        self.streams = [mesh.streams[p] for p in self.positions]
        self.device = torch.device(caller_device)
        self.caller = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)
        entry = _done(self.caller)
        for st in self.streams:
            if entry is not None and st is not None:
                st.wait_event(entry)

    @property
    def size(self) -> int:
        return len(self.positions)

    def enter(self) -> None:
        """Every member's stream waits for the current stream: the
        caller's in the forward, and in the backward the stream whose op
        asks for a layer group's remat recompute."""
        if self.caller is None:
            return
        now = torch.cuda.current_stream(self.device)
        for st in self.streams:
            if st is not None and st != now:
                st.wait_stream(now)

    def map(self, fn, *per_member) -> list:
        """[fn(k, a[k], b[k], ...) for every member k], each call on
        member k's stream and for its position (`sharding.at_position`,
        the position in the mesh a training row was cut from)."""
        out = []
        for k, st in enumerate(self.streams):
            with torch.cuda.stream(st), at_position(self.roots[k]):
                out.append(fn(k, *(a[k] for a in per_member)))
        return out

    def put(self, t: torch.Tensor) -> list:
        """A tensor of the caller's, for every member."""
        return [_cross(t, None, self.caller, st, dev)
                for st, dev in zip(self.streams, self.devices)]

    def spread(self, t: torch.Tensor) -> list:
        """Member 0's tensor, for every member."""
        done = _done(self.streams[0])
        return [t] + [_cross(t, done, self.streams[0], st, dev)
                      for st, dev in zip(self.streams[1:], self.devices[1:])]

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """Member 0's tensor, for the caller."""
        return _cross(t, _done(self.streams[0]), self.streams[0],
                      self.caller, self.device)

    def _to_first(self, parts) -> list:
        """Every member's part, readable on member 0's stream."""
        return [parts[0]] + [
            _cross(t, _done(st), st, self.streams[0], self.devices[0])
            for t, st in zip(parts[1:], self.streams[1:])]

    def close(self, keep=()) -> None:
        """The caller's stream waits for every member's; the tensors of
        `keep`, made on the members' streams, are marked as used by the
        caller's."""
        if self.caller is None:
            return
        for st in self.streams:
            if st is not None:
                self.caller.wait_stream(st)
        for t in keep:
            t.record_stream(self.caller)


def wait_for_mesh(mesh: LMMesh, tensors=()) -> None:
    """The current stream waits for every stream of `mesh` (after a
    backward through rows of it has been queued), and `tensors` are
    marked as used by it."""
    streams = [st for st in mesh.streams if st is not None]
    if not streams:
        return
    now = torch.cuda.current_stream(streams[0].device)
    for st in streams:
        now.wait_stream(st)
    for t in tensors:
        if t.is_cuda:
            t.record_stream(now)


def _count(kind: str, row: Row, ins, out, spread: bool) -> None:
    """Count a row hand-off of `kind` (`sharding.handoffs`): the parts
    `ins` of members 1.. to the first member, and with `spread` the
    result `out` to the others; the same bytes again, as
    "<kind>.backward", when autograd takes the gradient of `out` back
    through them."""
    nbytes = sum(map(tensor_bytes, ins[1:]))
    count = len(ins) - 1
    if spread:
        nbytes += (row.size - 1) * tensor_bytes(out)
        count += row.size - 1
    note_handoff(kind, nbytes, count)
    if out.requires_grad:
        out.register_hook(
            lambda g: note_handoff(kind + ".backward", nbytes, count))


def row_sum(row: Row, partials) -> list:
    """The members' partial sums reduced: summed in float32 (float64
    partials in float64) in member order on the row's first member,
    rounded once to their dtype, the result on every member. One member:
    its partial, untouched."""
    if row.size == 1:
        return list(partials)
    parts = row._to_first(partials)
    acc_dtype = torch.promote_types(partials[0].dtype, torch.float32)
    with torch.cuda.stream(row.streams[0]):
        acc = parts[0].to(acc_dtype)
        for t in parts[1:]:
            acc = acc + t.to(acc_dtype)
        out = acc.to(partials[0].dtype)
    if handoffs_open():
        _count("row_sum", row, partials, out, True)
    return row.spread(out)


def row_gather(row: Row, parts, dim: int, *, first_only: bool = False
               ) -> list:
    """The members' parts concatenated along `dim` in member order on the
    row's first member, for every member (only the first with
    `first_only`). One member: its part, untouched."""
    if row.size == 1:
        return list(parts)
    ins = parts
    parts = row._to_first(parts)
    with torch.cuda.stream(row.streams[0]):
        out = torch.cat(parts, dim)
    if handoffs_open():
        _count("row_gather", row, ins, out, not first_only)
    return [out] if first_only else row.spread(out)


def row_params(row: Row, whole, m: int) -> list:
    """Each member's slice of the `whole` params (on the row's first
    member), cut by differentiable operations on its stream
    (`member_params(..., grad=True)`). The slices of members 1.. count
    as "param_cut" hand-offs, and their gradients, when autograd takes
    them back, as "param_cut.backward"."""
    trees = row.map(lambda k, dev: member_params(whole, k, m, dev,
                                                 grad=True), row.devices)
    if handoffs_open():
        for tree in trees[1:]:
            leaves = tree_leaves(tree)
            note_handoff("param_cut", sum(map(tensor_bytes, leaves)),
                         len(leaves))
            for t in leaves:
                if t.requires_grad:
                    t.register_hook(lambda g: note_handoff(
                        "param_cut.backward", tensor_bytes(g)))
    return trees


@dataclass
class TPCache:
    """A decode cache of tensor-parallel serving: `blocks[r][k]` is the
    cache of replica r's member k (module docstring), `rows` the mesh
    positions of each replica's row."""
    blocks: list
    rows: tuple


#: the dim along which members hold a cache leaf (None: whole on each)
_CACHE_DIMS = {"k": 3, "v": 3, "k_scale": 3, "v_scale": 3, "pos": None,
               "conv": 3, "ssm": 2, "shift_t": None, "shift_c": None,
               "wkv": 2}


def _join(trees: list, key, how):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _join([t[k] for t in trees], k, how) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_join([t[i] for t in trees], key, how)
                           for i in range(len(first)))
    return how(trees, key)


def gather_caches(caches: TPCache, device=None) -> list:
    """The unsharded cache (`lm.init_cache`'s layout) of a `TPCache`, on
    `device` (default: the first member's): members joined along their
    heads or channels, replicas along the batch. Call it after the step
    that made the cache has returned (its rows are closed)."""
    device = torch.device(device) if device is not None else \
        tree_leaves(caches.blocks[0][0])[0].device

    def members(xs, key):
        dim = _CACHE_DIMS[key]
        xs = [x.to(device) for x in xs]
        return xs[0] if dim is None else torch.cat(xs, dim)

    def replicas(xs, key):
        return torch.cat(xs, 1)

    return _join([_join(list(blocks), None, members)
                  for blocks in caches.blocks], None, replicas)
