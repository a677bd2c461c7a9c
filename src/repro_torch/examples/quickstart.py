"""Quickstart: score graph pairs with SimGNN — port of
`examples/quickstart.py`.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Scores one `pair_stream(0, 8)` batch twice, through the plain PyTorch
pipeline (`core.simgnn.pair_score`) and through the two-kernel path
(`kernels.ops.simgnn_pair_score_kernel`: on the card the `fused_gcn` and
`simgnn_head` CUDA kernels, on the CPU their plain versions), prints them
side by side with the GED targets, and the untrained MSE loss.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.simgnn_aids import CONFIG as CFG
from repro_torch.core.simgnn import init_simgnn_params, pair_score, simgnn_loss
from repro_torch.data.graphs import pair_stream
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import simgnn_pair_score_kernel
from repro_torch.params import params_to

DENSE_KEYS = ("adj1", "feats1", "mask1", "adj2", "feats2", "mask2")


@torch.no_grad()
def main(argv=None, *, params=None) -> dict:
    """Runs the example; returns the plain and kernel scores [8] and the
    targets as CPU tensors, and the untrained loss. `params` replaces the
    seeded init (a SimGNN-AIDS tree, e.g. one converted from another
    package for a comparison)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if params is None:
        params = init_simgnn_params(torch.Generator().manual_seed(0), CFG)
    params = params_to(params, dev)
    batch = next(pair_stream(seed=0, batch=8, device=dev))
    inputs = [batch[k] for k in DENSE_KEYS]

    scores = pair_score(params, *inputs)
    print("similarity scores (plain path): ",
          [f"{s:.4f}" for s in scores.tolist()])
    scores_k = simgnn_pair_score_kernel(params, *inputs, device=dev)
    print("similarity scores (kernel path):",
          [f"{s:.4f}" for s in scores_k.tolist()])
    print("GED targets:                    ",
          [f"{t:.4f}" for t in batch["target"].tolist()])

    loss = simgnn_loss(params, batch)
    print(f"untrained MSE vs exp(-nGED) targets: {float(loss):.4f}")
    print("run `python -m repro_torch.launch.train --model simgnn` to train "
          "it.")
    return {"scores": scores.cpu(), "scores_kernel": scores_k.cpu(),
            "target": batch["target"], "loss": float(loss)}


if __name__ == "__main__":
    main()
