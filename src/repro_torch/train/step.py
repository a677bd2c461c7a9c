"""The SimGNN train step — port of the SimGNN half of `repro.train.step`:
clip -> cosine schedule -> AdamW around `ScoringEngine.loss_and_grad`
(DESIGN.md §11). The language-model step (`build_train_step`) is not
ported yet.

No path selection happens here: packing, bucketing and the choice of
executor live in the engine, for training as for serving.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.train import optimizer as opt


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
