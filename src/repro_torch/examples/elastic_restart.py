"""Elastic restart demo: train, checkpoint, crash, resume — then restore the
same checkpoint under a different mesh layout (the fleet-resize path) —
port of `examples/elastic_restart.py`.

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart \\
        --ckpt-dir runs/elastic [--mesh 2x2 --restore-mesh 4x1] \\
        [--device cpu]

Reduced gemma2-9b trains 6 steps with a checkpoint every 3, resumes from
the checkpoint of step 6 and runs to step 10, and the last checkpoint is
restored again (`ckpt.reshard.restore_on_mesh`). `--mesh DxM` trains on a
(D, M) mesh over ("data", "model") and `--restore-mesh DxM` restores onto
another one (either "none", the default, is the JAX example's unsharded
run); a mesh takes logical devices over the one device where the machine
has fewer. `--ckpt-dir` (default: a temporary directory, removed at the
end) is emptied first.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

import torch

from repro_torch.ckpt import manager as ckpt
from repro_torch.ckpt.reshard import restore_on_mesh, train_state_shardings
from repro_torch.configs import reduced_config
from repro_torch.data.tokens import batch_for_step
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.placement import gather, shard_tree
from repro_torch.launch.mesh import mesh_runtime
from repro_torch.models.init import init_params
from repro_torch.params import tree_leaves
from repro_torch.train import loop
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import build_train_step


def run(ckpt_dir: str, mesh: str = "none", restore_mesh: str = "none",
        device=None):
    """The demo; returns (params and AdamW state after step 10, the same
    restored onto `restore_mesh`, the loop's history)."""
    device = resolve_device(device)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = reduced_config("gemma2-9b")
    rt, _ = mesh_runtime(mesh, device)
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         device=device)
    params = shard_tree(params, sharding.param_shardings(rt, params))
    opt = adamw_init(params)
    step = build_train_step(cfg, rt, peak_lr=3e-3)

    def batch_fn(s):
        b = batch_for_step(cfg, s, global_batch=8, seq_len=64)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    print("== phase 1: train 6 steps, checkpoint every 3")
    loop.run(step, params, opt, batch_fn, n_steps=6, ckpt_dir=ckpt_dir,
             ckpt_every=3, resume=None, log_every=2)

    print("== phase 2: 'crash' and resume (auto picks up step 6)")
    p2, o2, hist = loop.run(step, params, opt, batch_fn, n_steps=10,
                            ckpt_dir=ckpt_dir, ckpt_every=3, resume="auto",
                            log_every=2)
    print(f"resumed and reached step {int(o2.step)}")

    print("== phase 3: elastic restore (same ckpt, new device layout)")
    last = ckpt.latest_step(ckpt_dir)
    target, _ = mesh_runtime(restore_mesh, device)
    p3, o3 = restore_on_mesh(ckpt_dir, last, (p2, o2),
                             train_state_shardings(target, p2))
    diff = max(float((gather(a).float() - gather(b).float()).abs().max())
               for a, b in zip(tree_leaves(p2), tree_leaves(p3)))
    print(f"restored step {last}; max param diff after round trip: "
          f"{diff:.1e}")
    return (p2, o2), (p3, o3), hist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", default="none",
                    help='"DxM" (a (data, model) mesh) or "none"')
    ap.add_argument("--restore-mesh", default="none",
                    help='"DxM" or "none": the layout phase 3 restores onto')
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        return run(args.ckpt_dir or tmp, args.mesh, args.restore_mesh,
                   args.device)


if __name__ == "__main__":
    main()
