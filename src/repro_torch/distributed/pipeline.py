"""GPipe pipeline parallelism over one axis of an LM mesh — port of
`repro.distributed.pipeline` (DESIGN.md §6).

Stage s owns a contiguous slice of layers: leaf slice [s] of params
stacked on a leading [S, ...] axis (`stack_stage_params`), held on the
mesh member at coordinate s of the pipeline axis. `x` [B, ...] is cut
into m microbatches [m, B/m, ...]. At tick t, stage s applies its slice
to microbatch t - s, for every s with 0 <= t - s < m; the output of stage
s - 1 at tick t - 1 is the input of stage s at tick t, and stage S - 1's
output for microbatch t - (S - 1) goes into the result. After m + S - 1
ticks every microbatch has been through every stage (bubble fraction
(S - 1) / (m + S - 1)).

Streams. On the card each stage computes on its member's stream, so the
stages of one tick overlap on the device (logical devices over one card,
`distributed.sharding.force_logical_device_count`, or one card each).
Every tensor that crosses from one stream to another (the caller's input
and params to the stages, one stage's output to the next, the last
stage's outputs back to the caller) crosses after the receiving stream
has waited for an event recorded right after the producer's work: never
a whole-stream wait, which would also wait for the producer's next tick.
`record_stream` marks it as used by the receiving stream, so the caching
allocator does not hand its memory out while that stream may still read
it. Between separate cards the crossing is `.to(device,
non_blocking=True)` issued with the receiving stream current on its card
(and the producer's stream current on its own, since PyTorch runs a copy
between cards on the source card's current stream). That case is written
but not exercised: the tests and the smoke run use the CPU and logical
devices over one card. On the CPU (streams None) the same code runs the
stages in order. There is no fallback: a member on the card computes on
the card, or the call raises.

Backward. The backward pipeline is autograd through the unrolled
schedule: the slicing of the stacked params, the hand-offs between
streams and, between cards, the differentiable `.to()` (the counterpart
of JAX's transpose of `ppermute`). Autograd runs each backward op on its
forward op's stream and synchronises the streams where gradients cross,
so the backward overlaps as the forward does; there is no scheduling
code for it here.

Bubble ticks. The JAX schedule runs `stage_fn` at every (tick, stage),
also in the bubble: stage s > 0 at ticks t < s on its buffer's initial
zeros or on the bubble outputs of the stage before, stage 0 at ticks
t >= m on what stage S - 1 handed round the ring (`ppermute` is
cyclic; `jnp.where` picks the injected microbatch only while t < m), and
stage s at ticks t - s >= m on the bubble outputs of the stage before.
None of those results reaches the output: a stage's output goes only to
the next stage's buffer for the next tick, which is a bubble tick there
too (or, for stage S - 1, to stage 0 at a tick t >= m, where `jnp.where`
drops it), and stage S - 1 writes the result only at ticks t - (S - 1)
in [0, m), which are real ticks; the masked `psum` keeps stage S - 1's
result alone. A result that reaches no output gets a zero cotangent, so
it adds nothing to any gradient (given finite intermediates, which the
bubble's zeros and stale activations give). So the port runs only the
m x S real (tick, stage) pairs and skips the (S - 1) x S bubble ones:
every output and gradient is the JAX function's, and this is the one
place where the port deliberately runs less than the JAX package does.

Reference. `sequential` is the same apply with the stages run in order,
one microbatch after another, on each device's current stream: what
`gpipe` is held against, bit for bit, on the card and here.

Mesh axes. On a mesh with more axes than `axis` the JAX function repeats
the same pipeline, on replicated data, on every replica along the other
axes; the port runs it once, on the members at coordinate 0 of the other
axes.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.placement import ShardedTensor
from repro_torch.distributed.sharding import LMMesh
from repro_torch.params import tree_leaves, tree_map


def _done(stream):
    """An event recorded on `stream` after the work queued on it so far
    (None on the CPU)."""
    if stream is None:
        return None
    event = torch.cuda.Event()
    event.record(stream)
    return event


def _cross(t: torch.Tensor, done, src, dst, device) -> torch.Tensor:
    """`t`, made on stream `src` (before event `done`, where given), for
    reading on stream `dst` at `device`; streams are None on the CPU."""
    if done is not None and dst is not None:
        dst.wait_event(done)
    if t.device != device:
        # a copy to the CPU is blocking: the caller reads it at once
        with torch.cuda.stream(src), torch.cuda.stream(dst):
            return t.to(device, non_blocking=dst is not None)
    if dst is not None:
        t.record_stream(dst)
    return t


def _unflatten(tree, leaves: list):
    """`tree` with its leaves replaced, in order, by `leaves`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _stage_slices(p, mesh: LMMesh, axis: str, pos: list) -> list:
    """Every stage's slice of a stacked leaf: `p.unbind(0)` of a whole
    tensor (one backward node stacks the stages' gradients), or the blocks
    at mesh positions `pos` of a ShardedTensor laid out by
    `NamedSharding(mesh, P(axis))`."""
    if not isinstance(p, ShardedTensor):
        return list(p.unbind(0))
    spec = tuple(p.sharding.spec) + (None,) * (p.ndim - len(p.sharding.spec))
    if p.sharding.mesh != mesh or spec != (axis,) + (None,) * (p.ndim - 1):
        raise ValueError(f"a stacked stage param must be laid out by "
                         f"P({axis!r}) on the pipeline's mesh, got {p!r}")
    return [p.blocks[i].squeeze(0) for i in pos]


def _microbatches(x: torch.Tensor, m: int) -> torch.Tensor:
    """`x` [B, ...] as [m, B / m, ...]; raises AssertionError naming the
    shapes when m does not divide B, as the JAX function's assert does."""
    if x.shape[0] % m:
        raise AssertionError((tuple(x.shape), m))
    return x.reshape(m, x.shape[0] // m, *x.shape[1:])


def _members(mesh: LMMesh, axis: str) -> tuple[list, list, list]:
    """(mesh positions, devices, streams) of the members at coordinates
    0 .. S - 1 of `axis` (coordinate 0 of the other axes)."""
    pos = [mesh.position({axis: i}) for i in range(mesh.shape[axis])]
    return (pos, [mesh.devices[p] for p in pos],
            [mesh.streams[p] for p in pos])


def gpipe(stage_fn, mesh: LMMesh, *, axis: str = "stage",
          n_microbatches: int | None = None):
    """Build a pipelined apply: (params_stacked [S, ...], x [B, ...]) -> y.

    `stage_fn(stage_params, x_mb) -> y_mb` must preserve the activation
    shape (homogeneous d_model across stages, as in all our transformer
    stacks). S is `mesh.shape[axis]`; m is `n_microbatches or S`, and a
    batch that m does not divide raises AssertionError, as the JAX
    function's assert does. Leaves of `params_stacked` are whole tensors
    (sliced per stage; their gradients reach the whole tensor) or
    ShardedTensors laid out by `NamedSharding(mesh, P(axis))` (each
    stage reads its own block). `y` has `x`'s shape, on `x`'s device. On
    a mesh with more axes than `axis` the pipeline runs once, on the
    members at coordinate 0 of the other axes (see the module
    docstring)."""
    s = mesh.shape[axis]
    pos, devices, streams = _members(mesh, axis)

    def apply(params_stacked, x):
        m = n_microbatches or s
        micro = _microbatches(x, m)
        caller = torch.cuda.current_stream(x.device) if x.is_cuda else None
        entry = _done(caller)
        for st in streams:
            if entry is not None and st is not None:
                st.wait_event(entry)
        slices = [_stage_slices(p, mesh, axis, pos)
                  for p in tree_leaves(params_stacked)]
        params = [_unflatten(params_stacked, [
            _cross(sl[i], None, caller, streams[i], devices[i])
            for sl in slices]) for i in range(s)]
        #: per stage: (its output at the last tick it ran, an event after it)
        carry: list = [None] * s
        outs = []
        for t in range(m + s - 1):
            # the last stage first: stage i reads stage i - 1's output of
            # tick t - 1 before that stage runs tick t
            for i in reversed(range(max(0, t - m + 1), min(s, t + 1))):
                if i == 0:
                    inp = _cross(micro[t], None, caller, streams[0],
                                 devices[0])
                else:
                    inp = _cross(*carry[i - 1], streams[i - 1], streams[i],
                                 devices[i])
                with torch.cuda.stream(streams[i]):
                    y = stage_fn(params[i], inp)
                carry[i] = (y, _done(streams[i]))
                if i == s - 1:
                    outs.append(_cross(*carry[i], streams[i], caller,
                                       x.device))
        return torch.cat(outs).reshape(x.shape)

    return apply


def sequential(stage_fn, mesh: LMMesh, *, axis: str = "stage",
               n_microbatches: int | None = None):
    """`gpipe`'s reference: the same apply, with the stages applied in
    order, one microbatch after another, each on its member's device and
    that device's current stream (no stage streams, no overlap). On one
    card `gpipe`'s y equals it bit for bit, and so do the gradients."""
    pos, devices, _ = _members(mesh, axis)

    def apply(params_stacked, x):
        micro = _microbatches(x, n_microbatches or len(pos))
        slices = [_stage_slices(p, mesh, axis, pos)
                  for p in tree_leaves(params_stacked)]
        stages = [_unflatten(params_stacked, [sl[i].to(dev) for sl in slices])
                  for i, dev in enumerate(devices)]
        outs = []
        for mb in micro:
            for p, dev in zip(stages, devices):
                mb = stage_fn(p, mb.to(dev))
            outs.append(mb.to(x.device))
        return torch.cat(outs).reshape(x.shape)

    return apply


def stack_stage_params(per_stage_params: list):
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading S axis
    (`torch.stack`, so gradients reach every stage's tree)."""
    leaves = [tree_leaves(t) for t in per_stage_params]
    return _unflatten(per_stage_params[0],
                      [torch.stack(xs) for xs in zip(*leaves)])
