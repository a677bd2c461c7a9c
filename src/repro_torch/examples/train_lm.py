"""Train an LM architecture (reduced config) end to end: data pipeline ->
train step (AdamW, remat) -> checkpoint/restart loop — port of
`examples/train_lm.py`.

    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        --arch qwen1.5-4b --steps 30 [--device cpu]

Any id of `repro_torch.configs` works. It calls the launcher with
`--reduced --batch 8 --seq-len 128 --lr 3e-3`, checkpointing into
`--ckpt-dir` (default: a temporary directory, removed at the end).
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch import train


def main(argv=None):
    """Runs the example; returns the launcher's `TrainRun`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    extra = [] if args.device is None else ["--device", args.device]
    with tempfile.TemporaryDirectory() as tmp:
        return train.main(["--model", args.arch, "--reduced", "--steps",
                           str(args.steps), "--batch", "8", "--seq-len",
                           "128", "--lr", "3e-3", "--ckpt-dir",
                           args.ckpt_dir or tmp, *extra])


if __name__ == "__main__":
    main()
