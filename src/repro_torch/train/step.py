"""Train-step builders — port of `repro.train.step`: value-and-grad ->
(optional int8 compression) -> clip -> cosine schedule -> AdamW, for the
LM substrate (`build_train_step`) and the paper's SimGNN model
(`build_simgnn_train_step`).

The LM step differentiates `lm.lm_loss` / `encdec.encdec_loss` with
autograd on detached copies of the params, with each layer group under
`torch.utils.checkpoint` (the losses' `remat=True`, as the JAX package's
`jax.checkpoint` over the scan). On the card the LM kernels run in the
forward pass; their backward is autograd of their plain versions
(`kernels.grad.kernel_with_plain_backward`). Gradient accumulation runs
`accum_steps` microbatches along the batch leaves' leading axis.

On an LM mesh (`build_train_step(cfg, rt)` with `rt.mesh` an
`LMMesh`) the step is data-parallel over `rt.batch_axes` and
tensor-parallel over `model`. Params and their AdamW moments are stored
as per-device blocks (`distributed.placement`, laid out by
`param_shardings`). One replica runs per coordinate of the batch axes,
on that row's first device and its stream (a `StreamFan`: the caller's
stream waits for the replicas once all are launched, so their work
overlaps on the device): it gathers whole params from the blocks, runs
the loss on its rows of the batch and gives whole gradients. Where the
mesh's `model` axis has m > 1 members and the config splits over them
(`tensor_parallel.train_row_size`), the replica's loss runs on its model
row (`lm.lm_loss` or `encdec.encdec_loss` with
`tensor_parallel.row_runtime`): each member computes its shard of every
layer (the encoder's too) on its own stream from slices cut from the
whole params by differentiable operations, the cross-entropy is
vocab-parallel, and the backward runs through the same row hand-offs
back to the whole params. A config that does not split over m (heads,
GQA groups or hidden units) trains with rows of one member: the
data-parallel step alone, whose bits a (d, 1) mesh gives too.
`step_fn.model_row` is the row's size and
`step_fn.model_row_note` says why it is one member where the axis has
more (None otherwise). The gradients
are summed over replicas in replica order on the mesh's first device,
then go through int8 compression (if asked), the global norm and
clipping whole, as in the JAX step, and are scattered into the params'
blocks (`constrain_grads`); AdamW updates each block on its device.
The MoE aux loss couples the whole batch, so for MoE models every
replica's routing statistics are collected (`moe.route_stats`; on a
model row member 0's only) and the aux term is formed once over all of
them before one backward through every replica's graph; other models
run each replica's backward as soon as its forward ends. A batch that
the replicas cannot split evenly (B % n_dp, or B < n_dp) runs as one
replica, as the JAX guard drops the axis.

No path selection happens in the SimGNN step: packing, bucketing and the
choice of executor live in the engine, for training as for serving
(DESIGN.md §11).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import placement
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.compression import int8_compress_tree
from repro_torch.distributed.sharding import (LMMesh, Runtime, StreamFan,
                                             handoffs_open, note_handoff,
                                             replica_positions, tensor_bytes)
from repro_torch.models import encdec, lm, moe
from repro_torch.models.config import ModelConfig
from repro_torch.params import tree_leaves, tree_map
from repro_torch.train import optimizer as opt


def loss_for(cfg: ModelConfig) -> Callable:
    if cfg.is_enc_dec:
        return encdec.encdec_loss
    return lm.lm_loss


def _on(batch, device):
    """Batch leaves (arrays or tensors) as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def value_and_grad(params, cfg: ModelConfig, batch, *,
                   allow_unused: bool = True, **loss_kw):
    """(loss, grads): `loss_for(cfg)` and its gradient for every leaf, as
    a tree like `params`, by autograd on detached copies of the leaves.
    `loss_kw` goes to the loss (e.g. `remat`). A leaf the loss does not
    reach gets zeros, as `jax.grad` gives it; with `allow_unused=False`
    autograd raises instead. With an `rt` on an LM mesh in `loss_kw` the
    current stream waits for the mesh's streams before the gradients are
    returned."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    it = iter(leaves)
    loss = loss_for(cfg)(tree_map(lambda _: next(it), params), cfg, batch,
                         **loss_kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=allow_unused)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    rt = loss_kw.get("rt")
    if rt is not None and rt.lm_mesh is not None:
        tp.wait_for_mesh(rt.lm_mesh, grads)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def build_train_step(cfg: ModelConfig, rt: Runtime | None = None, *,
                     peak_lr: float = 3e-4, max_grad_norm: float = 1.0,
                     accum_steps: int = 1, compress_grads: bool = False):
    """Returns step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "grad_norm", "lr", "step"}). Batch leaves (numpy
    arrays or tensors; moved to the params' device) carry a leading
    accumulation axis when accum_steps > 1; the microbatches' losses and
    float32 gradients are summed in order and divided by accum_steps.
    Nothing is updated in place. With `rt` on an `LMMesh` the step is the
    mesh step of the module docstring (`step_fn.model_row` members a
    model row); without one it is the single-device step, as the JAX
    package's with `rt.mesh is None`."""
    mesh = rt.lm_mesh if rt is not None else None
    m, why = (1, None) if mesh is None else tp.train_row_size(cfg, mesh)

    def grads_of(params, batch):
        if mesh is None:
            return value_and_grad(params, cfg, batch)
        return _mesh_value_and_grad(params, cfg, batch, mesh, rt.batch_axes,
                                    m)

    def step_fn(params, opt_state, batch):
        device = tree_leaves(params)[0].device
        batch = _on(batch, device)
        if accum_steps > 1:
            loss = torch.zeros((), dtype=torch.float32, device=device)
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=device), params)
            for i in range(accum_steps):
                mb_loss, mb_grads = grads_of(
                    params, {k: v[i] for k, v in batch.items()})
                loss = loss + mb_loss
                grads = _add_trees(grads, mb_grads)
            loss = loss / accum_steps
            grads = tree_map(lambda g: g / accum_steps, grads)
        else:
            loss, grads = grads_of(params, batch)

        with torch.no_grad():
            if compress_grads:
                grads = int8_compress_tree(grads)
            grads, grad_norm = opt.clip_by_global_norm(grads, max_grad_norm)
            if mesh is not None:
                grads = constrain_grads(grads, params)
            lr = opt.cosine_schedule(opt_state.step, peak_lr=peak_lr)
            params, opt_state = opt.adamw_update(grads, opt_state, params,
                                                 lr=lr)
        metrics = {"loss": loss.float(), "grad_norm": grad_norm, "lr": lr,
                   "step": opt_state.step}
        return params, opt_state, metrics

    step_fn.model_row, step_fn.model_row_note = m, why
    return step_fn


def constrain_grads(grads, params):
    """Whole gradients laid out as their params are (the JAX step's
    `constrain_grads`): a sharded param's gradient is cut into the same
    blocks, a whole param's stays whole (hand-offs of kind
    "constrain_grads", `sharding.handoffs`)."""
    return placement.shard_tree(grads, placement.tree_shardings(params),
                                kind="constrain_grads")


def _mesh_value_and_grad(params, cfg: ModelConfig, batch, mesh: LMMesh,
                         batch_axes, m: int = 1):
    """(loss, whole grads on the mesh's first device) of the batch split
    row-wise over the replicas of `batch_axes`, each replica's loss on its
    model row of `m` members (module docstring)."""
    first = mesh.devices[0]
    positions = replica_positions(mesh, batch_axes)
    n = len(positions)
    b = next(iter(batch.values())).shape[0]
    if n == 1 or b % n or b < n:
        positions, n = positions[:1], 1
    blocks = [blk for x in tree_leaves(params)
              if isinstance(x, placement.ShardedTensor) for blk in x.blocks]
    rows = b // n
    is_moe = n > 1 and any(cfg.layer_is_moe())
    losses, grads, graphs, stats = [], [], [], []
    fan = StreamFan()
    for r, pos in enumerate(positions):
        dev = mesh.devices[pos]
        part = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
        kw = {} if m == 1 else {
            "rt": tp.row_runtime(mesh, tp.row_positions(mesh, pos, m))}
        with fan.member(mesh.streams[pos], pos) as (reads, out):
            reads.extend(blocks + list(batch.values()))
            part = _on(part, dev)
            whole = placement.gather_tree(params, dev, pos)
            if not is_moe:
                loss, g = value_and_grad(whole, cfg, part, **kw)
                grads.append(tree_leaves(g))
                out.extend(grads[-1])
            else:
                leaves = [t.detach().requires_grad_(True)
                          for t in tree_leaves(whole)]
                it = iter(leaves)
                whole = tree_map(lambda _: next(it), whole)
                with moe.route_stats() as seen:
                    loss = loss_for(cfg)(whole, cfg, part, aux_weight=0.0,
                                         **kw)
                graphs.append(leaves)
                stats.append(seen)
                out.extend(t for pair in seen for t in pair)
            losses.append(loss)
            out.append(loss)
    fan.join()
    total = losses[0].to(first)
    for loss in losses[1:]:
        total = total + loss.to(first)
    if n > 1:
        total = total / n
    scale = n                  # each replica's grads are of its own mean
    if is_moe:
        aux = moe.aux_from_stats([[(f.to(first), p.to(first)) for f, p in s]
                                  for s in stats])
        total = total + moe.AUX_WEIGHT * aux
        flat = [t for leaves in graphs for t in leaves]
        g = torch.autograd.grad(total, flat, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x for p, x in zip(flat, g)]
        if m > 1:
            tp.wait_for_mesh(mesh, g)
        k = len(graphs[0])
        grads = [g[r * k:(r + 1) * k] for r in range(n)]
        total, scale = total.detach(), 1
    summed = [_mean_over_replicas([g[i] for g in grads], first, scale)
              for i in range(len(grads[0]))]
    it = iter(summed)
    return total, tree_map(lambda _: next(it), params)


def _mean_over_replicas(parts, device, scale: int) -> torch.Tensor:
    """The replicas' gradients of one leaf summed in replica order on
    `device` and divided by `scale`, in float32, back in the leaf's
    dtype; one replica's come back as they are. Every replica's but the
    first's is a hand-off of kind "grad_sum" (`sharding.handoffs`)."""
    if len(parts) == 1:
        return parts[0].to(device)
    if handoffs_open():
        note_handoff("grad_sum", sum(tensor_bytes(p) for p in parts[1:]),
                     len(parts) - 1)
    acc = parts[0].to(device, torch.float32, copy=True)
    for p in parts[1:]:
        acc += p.to(device, torch.float32)
    return (acc / scale).to(parts[0].dtype)


def _add_trees(a, b):
    """Leafwise a + b of two trees of one structure."""
    it = iter(tree_leaves(b))
    return tree_map(lambda x: x + next(it), a)


def build_simgnn_apply(*, peak_lr: float = 1e-3,
                       max_grad_norm: float = 1.0):
    """The SimGNN optimizer half-step (clip -> cosine schedule -> AdamW),
    shared by `build_simgnn_train_step` and any caller that pairs another
    loss with the same update: one source for the schedule constants.
    apply(params, opt_state, loss, grads) -> (params, opt_state, metrics);
    nothing is updated in place."""
    def apply(params, opt_state, loss, grads):
        grads, grad_norm = opt.clip_by_global_norm(grads, max_grad_norm)
        lr = opt.cosine_schedule(opt_state.step, peak_lr=peak_lr, warmup=50,
                                 total=2_000)
        params, opt_state = opt.adamw_update(grads, opt_state, params, lr=lr,
                                             weight_decay=1e-4)
        return params, opt_state, {"loss": loss, "grad_norm": grad_norm,
                                   "lr": lr, "step": opt_state.step}

    return apply


def build_simgnn_train_step(engine, *, peak_lr: float = 1e-3,
                            max_grad_norm: float = 1.0,
                            accum_steps: int = 1,
                            clock: Callable[[], float] | None = None):
    """Train step for the paper's model (MSE on exp(-nGED) targets), routed
    through a `core.engine.ScoringEngine`.

    batch: {"pairs": [(g1, g2), ...], "target": [B]} — raw graph-pair dicts
    (e.g. `data.graphs.pair_stream` batches). step_fn(params, opt_state,
    batch) -> (params, opt_state, metrics).

    Non-finite guard: if the loss or any gradient is NaN/Inf after the
    engine has exhausted its own degradation options, the update is
    skipped — params and optimizer state pass through unchanged, the skip
    is counted on `engine.counters["train_skipped_steps"]` and the metrics
    carry `skipped=1`.

    Tracing: each full step lands one `kind="train"` / `path="train_step"`
    record on `engine.recorder`, beside the engine's own `train:<path>`
    records. `clock` defaults to the engine's injectable clock.
    """
    from repro_torch.core.engine import tree_all_finite

    apply = build_simgnn_apply(peak_lr=peak_lr, max_grad_norm=max_grad_norm)
    clk = clock if clock is not None else engine._clock

    def _trace(n_pairs: int, wall_s: float) -> None:
        rec = getattr(engine, "recorder", None)
        if rec is None:
            return
        stats = getattr(engine.last_plan, "stats", None)
        rec.record(kind="train", path="train_step", n_pairs=n_pairs,
                   max_nodes=getattr(stats, "max_nodes", 0),
                   mean_nodes=getattr(stats, "mean_nodes", 0.0),
                   avg_degree=getattr(stats, "avg_degree", 0.0),
                   density=getattr(stats, "density", 0.0),
                   wall_s=wall_s)

    def step_fn(params, opt_state, batch):
        t0 = clk()
        loss, grads = engine.loss_and_grad(batch["pairs"], batch["target"],
                                           params=params,
                                           accum_steps=accum_steps)
        if not tree_all_finite(loss, grads):
            engine.counters["train_skipped_steps"] += 1
            zero = torch.zeros((), dtype=torch.float32, device=loss.device)
            metrics = {"loss": loss.float(), "grad_norm": zero, "lr": zero,
                       "step": opt_state.step,
                       "skipped": torch.ones((), dtype=torch.float32,
                                             device=loss.device)}
            _trace(len(batch["pairs"]), clk() - t0)
            return params, opt_state, metrics
        params, opt_state, metrics = apply(params, opt_state, loss, grads)
        if loss.is_cuda:
            torch.cuda.synchronize(loss.device)
        _trace(len(batch["pairs"]), clk() - t0)
        return params, opt_state, metrics

    return step_fn
