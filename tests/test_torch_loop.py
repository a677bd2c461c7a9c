"""The port's training loop (`repro_torch.train.loop`) against
`repro.train.loop`, on the CPU.

  * `StragglerMonitor` flags the same steps and keeps the same EWMA as the
    JAX monitor on one sequence of step times;
  * the JAX loop tests (`tests/test_optim_ckpt.py`, `tests/test_store.py`)
    hold for the port: restart resumes bit for bit, a failed step is
    retried from the last valid checkpoint with the JAX loop's printed
    lines, resume walks back past a corrupt checkpoint (reported through
    `on_resume`), and a fully corrupt directory starts fresh;
  * three SimGNN train steps through the port's `run` against JAX's `run`
    on converted params and the same batches: params, AdamW state and the
    recorded metrics within 1e-5 (the bound of tests/test_torch_train.py),
    the same checkpoint steps on disk, and each package's final
    checkpoint restoring in the other;
  * a run killed mid-stream and resumed ends bit-identical to an
    uninterrupted one (the counterpart of
    tests/test_faults.py::test_midstream_kill_resumes_bit_identical).
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import manager as jckpt
from repro.core.engine import ScoringEngine as JaxEngine
from repro.core.simgnn import SimGNNConfig as JaxConfig
from repro.core.simgnn import init_simgnn_params
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train.step import build_simgnn_train_step as jax_train_step
from repro_torch.ckpt import manager as ckpt
from repro_torch.core.engine import ScoringEngine
from repro_torch.core.simgnn import SimGNNConfig
from repro_torch.data.graphs import pair_stream, random_graph
from repro_torch.params import (adamw_state_from_numpy, params_from_numpy,
                                tree_leaves)
from repro_torch.testing import faults
from repro_torch.train import loop
from repro_torch.train import optimizer as opt
from repro_torch.train.step import build_simgnn_train_step

#: float32 bound on params, moments and metrics after three train steps
#: (tests/test_torch_train.py).
STEP_ATOL = 1e-5

TIMES = (1.0, 1.05, 0.97, 1.1, 1.02, 5.0, 1.0, 0.9, 2.9, 3.5, 12.0, 1.0)


def test_straggler_monitor_matches_jax():
    jm, tm = jloop.StragglerMonitor(threshold=2.0), \
        loop.StragglerMonitor(threshold=2.0)
    flags = [(tm.observe(s, dt), jm.observe(s, dt))
             for s, dt in enumerate(TIMES)]
    assert [a for a, _ in flags] == [b for _, b in flags]
    assert sum(a for a, _ in flags) >= 2
    assert tm.flagged == jm.flagged and tm.ewma == jm.ewma


def test_straggler_monitor_flags_slow_steps():
    m = loop.StragglerMonitor(threshold=2.0)
    assert not m.observe(0, 1.0)
    for s in range(1, 5):
        assert not m.observe(s, 1.05)
    assert m.observe(5, 5.0)            # 5x slower -> straggler
    assert len(m.flagged) == 1
    assert not m.observe(6, 1.0)        # baseline not poisoned


def _quadratic_step(params, opt_state, batch):
    loss = torch.sum((params["w"] - batch) ** 2)
    g = {"w": 2 * (params["w"] - batch)}
    new_p, new_o = opt.adamw_update(g, opt_state, params, lr=0.05)
    return new_p, new_o, {"loss": loss}


def test_restart_resumes_bit_exact(tmp_path):
    """Train 6 steps straight vs 3 steps + simulated crash + resume: final
    params identical (deterministic data keyed by step)."""
    def batch_fn(step):
        return torch.full((3,), float(step))

    p0 = {"w": torch.zeros(3)}
    pa, oa, _ = loop.run(_quadratic_step, p0, opt.adamw_init(p0), batch_fn,
                         n_steps=6, ckpt_dir=str(tmp_path / "a"),
                         ckpt_every=2, resume=None, log_every=100)
    loop.run(_quadratic_step, p0, opt.adamw_init(p0), batch_fn, n_steps=3,
             ckpt_dir=str(tmp_path / "b"), ckpt_every=2, resume=None,
             log_every=100)
    pb, ob, _ = loop.run(_quadratic_step, p0, opt.adamw_init(p0), batch_fn,
                         n_steps=6, ckpt_dir=str(tmp_path / "b"),
                         ckpt_every=2, resume="auto", log_every=100)
    assert torch.equal(pa["w"], pb["w"])
    assert int(oa.step) == int(ob.step) == 6
    assert ob.step.dtype == torch.int32


def _failing(crashes, boom, lib):
    """test_optim_ckpt.py's step that throws once at optimizer step 4, for
    either package (`lib`: "jax" or "torch")."""
    def step_fn(params, opt_state, batch):
        if crashes and boom["armed"] and int(opt_state.step) == 4:
            boom["armed"] = False
            raise RuntimeError("injected failure")
        g = {"w": 2 * (params["w"] - batch)}
        if lib == "jax":
            new_p, new_o = jopt.adamw_update(g, opt_state, params, lr=0.05)
            return new_p, new_o, {"loss": jnp.sum(params["w"])}
        new_p, new_o = opt.adamw_update(g, opt_state, params, lr=0.05)
        return new_p, new_o, {"loss": torch.sum(params["w"])}
    return step_fn


def test_failure_recovery_in_loop_matches_jax(tmp_path, capsys):
    """A step_fn that throws once mid-run: the loop restores the last
    checkpoint and converges to the same final state as a clean run, with
    the JAX loop's printed lines and history."""
    def batch(lib):
        return ((lambda s: jnp.full((2,), float(s))) if lib == "jax"
                else (lambda s: torch.full((2,), float(s))))

    runs = {}
    for lib, mod, p0, init in (
            ("jax", jloop, {"w": jnp.zeros(2)}, jopt.adamw_init),
            ("torch", loop, {"w": torch.zeros(2)}, opt.adamw_init)):
        clean = mod.run(_failing(False, {}, lib), p0, init(p0), batch(lib),
                        n_steps=8, ckpt_dir=str(tmp_path / lib / "clean"),
                        ckpt_every=2, resume=None, log_every=3)
        capsys.readouterr()
        # no straggler lines: step times differ between runs
        crashy = mod.run(_failing(True, {"armed": True}, lib), p0, init(p0),
                         batch(lib), n_steps=8,
                         ckpt_dir=str(tmp_path / lib / "crashy"),
                         ckpt_every=2, resume=None, log_every=3,
                         monitor=mod.StragglerMonitor(threshold=float("inf")))
        runs[lib] = clean, crashy, capsys.readouterr().out
    (tc, tb, tout), (jc, jb, jout) = runs["torch"], runs["jax"]
    assert torch.equal(tc[0]["w"], tb[0]["w"])
    assert "[loop] step 4 failed; restoring step 4 (retry 1/2)" in tout
    assert tout == jout
    np.testing.assert_allclose(tb[0]["w"].numpy(), np.asarray(jb[0]["w"]),
                               rtol=0, atol=1e-6)
    assert [sorted(r) for r in tb[2]] == [sorted(r) for r in jb[2]]
    assert len(tb[2]) == len(jb[2]) == 4           # steps 0, 3, 6 and 7
    for a, b in zip(tb[2], jb[2]):
        assert abs(a["loss"] - b["loss"]) <= 1e-6


def test_retries_give_up_after_max_retries(tmp_path):
    calls = []

    def step_fn(params, opt_state, batch):
        calls.append(1)
        raise RuntimeError("always fails")

    p0 = {"w": torch.zeros(2)}
    with pytest.raises(RuntimeError, match="always fails"):
        loop.run(step_fn, p0, opt.adamw_init(p0), lambda s: None, n_steps=3,
                 ckpt_dir=str(tmp_path), ckpt_every=1, max_retries=2)
    assert len(calls) == 3
    with pytest.raises(RuntimeError):          # no checkpoints: no retry
        loop.run(step_fn, p0, opt.adamw_init(p0), lambda s: None, n_steps=3)
    assert len(calls) == 4


def _add_step(params, opt_state, batch):
    return {"x": params["x"] + batch}, opt_state, {"loss": torch.tensor(0.0)}


def test_loop_resumes_through_walkback(tmp_path):
    """resume="auto" restores the newest VALID checkpoint when the newest
    one is bit-flipped, reports the skip through on_resume, and continues
    training from there."""
    d = str(tmp_path / "run")
    p0 = {"x": torch.zeros(())}
    one = lambda s: torch.tensor(1.0)           # noqa: E731
    loop.run(_add_step, p0, {}, one, n_steps=6, ckpt_dir=d, ckpt_every=2,
             resume=None, log_every=100)
    faults.corrupt_file(os.path.join(d, "step_000000006", "arrays.0.npz"),
                        "bitflip")
    seen = {}

    def on_resume(step, skipped):
        seen["step"], seen["skipped"] = step, [s for s, _ in skipped]

    params, _, _ = loop.run(_add_step, p0, {}, one, n_steps=8, ckpt_dir=d,
                            ckpt_every=2, resume="auto", log_every=100,
                            on_resume=on_resume)
    assert seen == {"step": 4, "skipped": [6]}
    assert float(params["x"]) == 8.0            # resumed at 4, 4 more steps


def test_loop_fresh_start_when_everything_corrupt(tmp_path):
    d = str(tmp_path / "run")
    p0 = {"x": torch.zeros(())}
    one = lambda s: torch.tensor(1.0)           # noqa: E731
    loop.run(_add_step, p0, {}, one, n_steps=2, ckpt_dir=d, ckpt_every=2,
             resume=None, log_every=100)
    faults.corrupt_file(os.path.join(d, "step_000000002", "arrays.0.npz"),
                        "torn")
    params, _, _ = loop.run(_add_step, p0, {}, one, n_steps=3, ckpt_dir=d,
                            ckpt_every=50, resume="auto", log_every=100)
    assert float(params["x"]) == 3.0            # started from 0


def test_resume_none_ignores_checkpoints(tmp_path):
    d = str(tmp_path)
    p0 = {"x": torch.zeros(())}
    one = lambda s: torch.tensor(1.0)           # noqa: E731
    loop.run(_add_step, p0, {}, one, n_steps=4, ckpt_dir=d, ckpt_every=2)
    params, _, hist = loop.run(_add_step, p0, {}, one, n_steps=4,
                               ckpt_dir=d, resume=None, log_every=2)
    assert float(params["x"]) == 4.0
    assert [h["loss"] for h in hist] == [0.0, 0.0, 0.0]   # steps 0, 2, 3
    assert ckpt.latest_step(d) == 4


# ------------------------------------------------- SimGNN through the loop

@functools.lru_cache(maxsize=None)
def _jparams():
    return init_simgnn_params(jax.random.PRNGKey(0), JaxConfig())


def _tparams():
    return params_from_numpy(jax.tree.map(np.asarray, _jparams()), "cpu")


@functools.lru_cache(maxsize=None)
def _batches(seed=21, n=3, batch=8):
    stream = pair_stream(seed, batch, device="cpu")
    return tuple({"pairs": b["pairs"], "target": b["target"]}
                 for b in (next(stream) for _ in range(n)))


def test_three_loop_steps_match_jax(tmp_path):
    batches = _batches()
    jeng = JaxEngine(_jparams(), JaxConfig(), path="auto",
                     planner="threshold")
    teng = ScoringEngine(_tparams(), SimGNNConfig(), path="auto",
                         planner="threshold", device="cpu")
    js0 = jopt.adamw_init(_jparams())
    jp, js, jhist = jloop.run(
        jax_train_step(jeng, peak_lr=1e-2), _jparams(), js0,
        lambda s: batches[s], n_steps=3, ckpt_dir=str(tmp_path / "jax"),
        ckpt_every=2, log_every=1)
    tp, ts, thist = loop.run(
        build_simgnn_train_step(teng, peak_lr=1e-2), _tparams(),
        adamw_state_from_numpy(jax.tree.map(np.asarray, js0)),
        lambda s: batches[s], n_steps=3, ckpt_dir=str(tmp_path / "port"),
        ckpt_every=2, log_every=1)
    assert teng.last_plan.path == jeng.last_plan.path
    for a, b in zip(tree_leaves((tp, ts)), jax.tree.leaves((jp, js))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=STEP_ATOL)
    assert len(thist) == len(jhist) == 3
    for a, b in zip(thist, jhist):
        assert sorted(a) == sorted(b)
        for key in ("loss", "grad_norm", "lr", "step"):
            assert abs(a[key] - b[key]) <= STEP_ATOL, key
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax")) == ["step_000000002",
                                                 "step_000000003"]
    # each package's last checkpoint restores in the other
    from_jax = ckpt.restore(str(tmp_path / "jax"), 3, (tp, ts))
    from_port = jckpt.restore(str(tmp_path / "port"), 3, (jp, js))
    for a, b in zip(tree_leaves(from_jax), jax.tree.leaves((jp, js))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(jax.tree.leaves(from_port), tree_leaves((tp, ts))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("path", ("reference", "auto"))
def test_midstream_kill_resumes_bit_identical(tmp_path, path):
    """A run killed mid-stream and resumed from its checkpoint ends with
    BIT-IDENTICAL params and optimizer state against an uninterrupted run
    (atomic checkpoints + deterministic per-step batch replay)."""
    rngs = [np.random.default_rng(100 + s) for s in range(6)]
    batches = [{"pairs": [(random_graph(r, 8, avg_degree=2.0),
                           random_graph(r, 8, avg_degree=2.0))
                          for _ in range(4)],
                "target": r.uniform(0.2, 0.9, 4).astype(np.float32)}
               for r in rngs]

    def run(ckpt_dir, n_steps):
        params = _tparams()
        eng = ScoringEngine(params, SimGNNConfig(), path=path, device="cpu")
        step = build_simgnn_train_step(eng)
        return loop.run(step, params, opt.adamw_init(params),
                        lambda s: batches[s], n_steps=n_steps,
                        ckpt_dir=str(ckpt_dir), ckpt_every=2, log_every=100)

    p_full, o_full, _ = run(tmp_path / "full", 6)
    # "Killed" after 3 steps: drop the exit-time save so the only surviving
    # checkpoint is the mid-stream one at step 2 (ckpt_every=2), exactly
    # what a hard kill leaves behind.
    run(tmp_path / "killed", 3)
    shutil.rmtree(tmp_path / "killed" / "step_000000003")
    p_res, o_res, _ = run(tmp_path / "killed", 6)
    assert int(o_res.step) == 6
    for a, b in zip(tree_leaves((p_full, o_full)),
                    tree_leaves((p_res, o_res))):
        assert a.dtype == b.dtype and torch.equal(a, b)
