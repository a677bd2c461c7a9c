"""The port's training launcher (`python -m repro_torch.launch.train`) on
the CPU, at 8-pair batches of SimGNN-AIDS width.

  * a run checkpoints, a second run resumes from its last checkpoint,
    counts `ckpt_resumes`, and ends bit-identical to an uninterrupted run;
  * `--simulate-failure N` kills the process with exit code 42 after step
    N, and the resumed run ends bit-identical to an uninterrupted one;
  * a corrupt newest checkpoint is walked past and counted
    (`ckpt_walkback_skipped`);
  * without CUDA the launcher raises unless `--device cpu` is given;
  * an LM on `--mesh single` and `--mesh multi` (the production meshes,
    256 and 512 logical CPU devices) trains, its losses, gradient norms
    and learning rates within 1e-5 of the unsharded launcher's
    (`--devices N` is held in tests/test_torch_sharded_train.py, the LM
    mesh's step and checkpoints in tests/test_torch_lm_mesh.py and
    tests/test_torch_reshard.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch.train import main
from repro_torch.params import tree_leaves
from repro_torch.testing import faults

ROOT = Path(__file__).resolve().parents[1]


def _args(ckpt_dir, steps, *extra):
    return ["--device", "cpu", "--steps", str(steps), "--batch", "8",
            "--ckpt-dir", str(ckpt_dir), *extra]


def _bit_equal(a, b) -> bool:
    la, lb = tree_leaves((a.params, a.opt_state)), \
        tree_leaves((b.params, b.opt_state))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_launcher_resumes_and_counts(tmp_path, capsys):
    first = main(_args(tmp_path / "run", 3))
    assert not first.counters.get("ckpt_resumes")
    assert [len(first.history), int(first.opt_state.step)] == [2, 3]
    assert sorted(os.listdir(tmp_path / "run")) == ["step_000000003"]
    capsys.readouterr()
    resumed = main(_args(tmp_path / "run", 5))
    out = capsys.readouterr().out
    assert "[loop] resumed from step 3" in out
    assert "[train] final loss" in out
    assert resumed.counters["ckpt_resumes"] == 1
    assert resumed.counters["ckpt_walkback_skipped"] == 0
    assert int(resumed.opt_state.step) == 5
    straight = main(_args(tmp_path / "straight", 5))
    assert _bit_equal(resumed, straight)
    assert resumed.history[-1] == {**straight.history[-1], "sec_per_step":
                                   resumed.history[-1]["sec_per_step"]}


def test_launcher_walks_back_past_a_corrupt_checkpoint(tmp_path, capsys):
    main(_args(tmp_path, 3, "--ckpt-every", "2"))
    assert sorted(os.listdir(tmp_path)) == ["step_000000002",
                                            "step_000000003"]
    faults.corrupt_file(str(tmp_path / "step_000000003" / "arrays.0.npz"),
                        "torn")
    capsys.readouterr()
    run = main(_args(tmp_path, 4, "--ckpt-every", "2"))
    out = capsys.readouterr().out
    assert "[loop] skipping corrupt checkpoint step 3" in out
    assert "[loop] resumed from step 2 (walked back past 1 corrupt)" in out
    assert "[train] resume walked back past 1 corrupt checkpoint(s)" in out
    assert run.counters["ckpt_resumes"] == 1
    assert run.counters["ckpt_walkback_skipped"] == 1
    assert int(run.opt_state.step) == 4


def test_simulated_failure_exits_42_and_resumes_bit_identical(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         *_args(tmp_path / "killed", 4, "--ckpt-every", "2",
                "--simulate-failure", "2", "--log-every", "1")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 42, proc.stdout + proc.stderr
    assert "[train] simulated failure after step 2!" in proc.stdout
    assert "step     1 loss" in proc.stdout
    # killed after step 2 ran: the last checkpoint is the one of step 2
    assert sorted(os.listdir(tmp_path / "killed")) == ["step_000000002"]
    resumed = main(_args(tmp_path / "killed", 4, "--ckpt-every", "2"))
    assert resumed.counters["ckpt_resumes"] == 1
    straight = main(_args(tmp_path / "straight", 4, "--ckpt-every", "2"))
    assert _bit_equal(resumed, straight)


def test_launcher_needs_the_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--steps", "1", "--batch", "2"])
    assert not tmp_path.joinpath("run").exists()


@pytest.mark.parametrize("mesh,batch", (("single", 16), ("multi", 32)))
def test_modes_not_ported_raise(mesh, batch, capsys):
    """Once raising NotImplementedError, `--mesh single|multi` now trains
    (every batch replica one sequence): on the CPU over as many logical
    devices as the production mesh has, which it prints, with the
    unsharded launcher's losses, gradient norms and learning rates."""
    argv = ["--model", "qwen1.5-4b", "--reduced", "--steps", "2", "--batch",
            str(batch), "--seq-len", "16", "--log-every", "1", "--lr",
            "1e-2", "--device", "cpu"]
    want = main(argv)
    got = main([*argv, "--mesh", mesh])
    n = 256 if mesh == "single" else 512
    assert f"{n} logical devices over cpu" in capsys.readouterr().out
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        for key in ("loss", "grad_norm", "lr"):
            assert abs(g[key] - w[key]) <= 1e-5, (key, g[key], w[key])
    leaf = got.params["embed"]["table"]
    assert leaf.sharding.mesh.size == n and len(leaf.blocks) == n
