"""Training launcher — port of `repro.launch.train`.

    python -m repro_torch.launch.train --model simgnn --steps 300 \\
        --ckpt-dir runs/simgnn
    python -m repro_torch.launch.train --model qwen1.5-4b --reduced \\
        --steps 30 --batch 8 --seq-len 128 --ckpt-dir runs/qwen

`--model simgnn` (the default) trains the paper's SimGNN at SimGNN-AIDS
width (`configs/simgnn_aids`: GCN 128/64/32, NTN K=16, FCN 16->8->4->1) on
the synthetic AIDS-like pair stream, in batches of `--batch` pairs, through
`train/loop.run`: checkpoints every `--ckpt-every` steps, verified resume
(`--resume auto`) with a deterministic replay of the batches by step,
straggler monitoring and retry after a failed step. `--simulate-failure N`
kills the process with exit code 42 once the update of step N is
computed, before the loop records it or writes any later checkpoint, to
exercise the restart path.

`--model <arch>` (any id of `repro_torch.configs`) trains that language
model (`--reduced`: its `reduced_config`) on `data/tokens.batch_for_step`
batches of `--batch` sequences of `--seq-len` tokens (enc-dec: frames of
`--seq-len` and decoder tokens; VLM: prepended patch embeddings) through
`train/step.build_train_step` (peak lr `--lr`, `--compress-grads`: int8
gradients) and the same loop, checkpoints and `--simulate-failure`.

It runs on `--device` (default: the card; without CUDA it raises unless
`--device cpu` is given). `--devices N` (SimGNN) shards each batch's
packed tiles over N devices (`ScoringEngine(runtime=tile_runtime(N))`,
DESIGN.md §16): with `--device cpu` N logical CPU devices, on the card
the first N cards, or N logical devices over the one card where the
machine has fewer (it prints which). Params stay whole on the first
device, so a run saved at N devices resumes at M.

`--mesh single|multi` (LM) trains on the production mesh (`launch/mesh`:
(16, 16) over ("data", "model"), or (2, 16, 16) with "pod" in front),
`--mesh DxM` on a (D, M) test mesh: params and AdamW state stored as
per-device blocks by the param rules, the step data-parallel over the
batch axes and tensor-parallel over `model` (`train/step.py`; it prints
the model row's members, and the dim that did not split where a config
does not split over M and its rows are one member). Where the machine
has fewer cards than the mesh has devices (256 for single, 512 for
multi) it uses that many logical devices over the one `--device` (it
prints which).
Checkpoints hold whole leaves, so a run saved on one mesh resumes on
another or on none.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device


@dataclass
class TrainRun:
    """What a finished run leaves: its final params and optimizer state,
    the loop's history records and the engine's counters (SimGNN; an LM
    run has no engine and leaves them empty)."""
    params: dict
    opt_state: object
    history: list
    counters: dict


def _failing_after(step_fn, args):
    """`step_fn` that kills the process with exit code 42 once the step
    `args.simulate_failure` has been computed (0: never), before the loop
    records it or writes a later checkpoint; and the batch function's
    record of the current step it reads."""
    current = {"step": None}

    def run_step(params, opt_state, batch):
        out = step_fn(params, opt_state, batch)
        if args.simulate_failure and current["step"] == args.simulate_failure:
            print(f"[train] simulated failure after step "
                  f"{args.simulate_failure}!", flush=True)
            os._exit(42)
        return out

    return run_step, current


def _tile_runtime(n: int, device: torch.device):
    """The tile runtime of `--devices n` (data-parallel packed training,
    DESIGN.md §16): the first n cards where the machine has them, else n
    logical devices over the one `device` (each its own CUDA stream on
    the card), armed only while the mesh is built."""
    from repro_torch.distributed import sharding

    if device.type == "cuda" and torch.cuda.device_count() >= n:
        print(f"[train] {n} devices: the first {n} cards")
        return sharding.tile_runtime(n, device)
    with sharding.logical_devices(n, device):
        runtime = sharding.tile_runtime(n, device)
    print(f"[train] {n} devices: {n} logical devices over "
          f"{runtime.mesh.devices[0]}")
    return runtime


def _mesh_arg(value: str) -> str:
    """`--mesh`: none, single, multi or DxM (two positive integers)."""
    if value in ("none", "single", "multi"):
        return value
    parts = value.split("x")
    if len(parts) == 2 and all(p.isdigit() and int(p) > 0 for p in parts):
        return value
    raise argparse.ArgumentTypeError(
        f"--mesh takes none, single, multi or DxM, not {value!r}")


def train_simgnn(args) -> TrainRun:
    from repro_torch.configs.simgnn_aids import CONFIG as scfg
    from repro_torch.core.engine import ScoringEngine
    from repro_torch.core.simgnn import init_simgnn_params
    from repro_torch.data.graphs import pair_stream
    from repro_torch.train import loop
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import build_simgnn_train_step

    device = resolve_device(args.device)
    runtime = _tile_runtime(args.devices, device) if args.devices > 1 \
        else None
    params = init_simgnn_params(torch.Generator().manual_seed(args.seed),
                                scfg, device=device)
    opt_state = adamw_init(params)
    # The engine dispatches the forward AND backward passes (DESIGN.md
    # §11): it measures each batch and picks the executor; the step itself
    # contains no path selection.
    engine = ScoringEngine(params, scfg, device=device, runtime=runtime)
    step_fn = build_simgnn_train_step(engine, peak_lr=args.lr)
    # The stream's padded tensors are not used (the engine packs the raw
    # pairs itself), so they stay on the host.
    stream = pair_stream(args.seed, args.batch, max_nodes=scfg.max_nodes,
                         device="cpu")
    batches = {}
    run_step, current = _failing_after(step_fn, args)

    def batch_fn(step):            # deterministic per step for restartability
        while step not in batches:
            batches[len(batches)] = next(stream)
        current["step"] = step
        return batches[step]

    def on_metrics(step, rec):
        print(f"step {step:5d} loss {rec['loss']:.5f} "
              f"gnorm {rec['grad_norm']:.3f} {rec['sec_per_step']*1e3:.0f}ms")

    def on_resume(step, skipped):
        # Land the verified-restore outcome on the engine's counters so
        # `engine.health()` reports the resume story next to the breakers:
        # how many corrupt checkpoints the walk-back skipped, and whether a
        # resume happened at all.
        if step is not None:
            engine.counters["ckpt_resumes"] += 1
        engine.counters["ckpt_walkback_skipped"] += len(skipped)

    params, opt_state, hist = loop.run(
        run_step, params, opt_state, batch_fn, n_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume, log_every=args.log_every, on_metrics=on_metrics,
        on_resume=on_resume)
    if engine.counters.get("train_skipped_steps"):
        print(f"[train] skipped {engine.counters['train_skipped_steps']} "
              "non-finite steps")
    if engine.counters.get("ckpt_walkback_skipped"):
        print(f"[train] resume walked back past "
              f"{engine.counters['ckpt_walkback_skipped']} corrupt "
              "checkpoint(s)")
    if hist:
        print(f"[train] final loss {hist[-1]['loss']:.5f}")
    return TrainRun(params, opt_state, hist, dict(engine.counters))


def train_lm(args) -> TrainRun:
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.distributed.placement import shard_tree
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.mesh import mesh_runtime
    from repro_torch.models.init import init_params
    from repro_torch.train import loop
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import build_train_step

    cfg = reduced_config(args.model) if args.reduced else get_config(
        args.model)
    device = resolve_device(args.device)
    rt = None
    if args.mesh != "none":
        rt, where = mesh_runtime(args.mesh, device)
        print(f"[train] {where}")
    params = init_params(torch.Generator().manual_seed(args.seed), cfg,
                         device=device)
    if rt is not None:
        params = shard_tree(params, param_shardings(rt, params))
    opt_state = adamw_init(params, cfg.opt_state_dtype)
    step_fn = build_train_step(cfg, rt, peak_lr=args.lr,
                               compress_grads=args.compress_grads)
    if rt is not None:
        m, why = step_fn.model_row, step_fn.model_row_note
        print(f"[train] model row: {m} member{'s' if m > 1 else ''}"
              + (f" ({why})" if why else ""))
    run_step, current = _failing_after(step_fn, args)

    def batch_fn(step):            # deterministic per step for restartability
        current["step"] = step
        b = batch_for_step(cfg, step, global_batch=args.batch,
                           seq_len=args.seq_len)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    def on_metrics(step, rec):
        print(f"step {step:5d} loss {rec['loss']:.4f} "
              f"gnorm {rec['grad_norm']:.2f} lr {rec['lr']:.2e} "
              f"{rec['sec_per_step']*1e3:.0f}ms")

    params, opt_state, hist = loop.run(
        run_step, params, opt_state, batch_fn, n_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume, log_every=args.log_every, on_metrics=on_metrics)
    if hist:
        print(f"[train] final loss {hist[-1]['loss']:.4f}")
    return TrainRun(params, opt_state, hist, {})


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train SimGNN-AIDS or an LM with checkpoints and "
                    "restart.")
    ap.add_argument("--model", default="simgnn",
                    help="simgnn (default) or an LM architecture id")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    # "auto" restores the latest valid checkpoint in --ckpt-dir and
    # replays the deterministic data stream from there; "none" always
    # starts from step 0 (fresh run into a reused directory).
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--reduced", action="store_true")
    # LM only: the production mesh (single, multi) or a DxM test mesh
    # (logical devices where the machine has fewer cards)
    ap.add_argument("--mesh", default="none", type=_mesh_arg)
    ap.add_argument("--compress-grads", action="store_true")
    # simgnn only: shard packed training over N devices (logical ones
    # where the machine has fewer)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--simulate-failure", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10,
                    help="record and print the metrics every N steps (and "
                         "at the last step)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.model == "simgnn":
        return train_simgnn(args)
    return train_lm(args)


if __name__ == "__main__":
    main()
