"""The port's LM training slice (`lm.lm_loss`, `encdec.encdec_loss`,
`train.step.build_train_step`, `distributed.compression`, the launcher's
LM mode, `examples/train_lm.py` and `kernels.grad.
kernel_with_plain_backward`) against the JAX package on the same numpy
inputs and params converted from the JAX tree, at reduced size in
float32.

Bounds: losses within 1e-6 relative and gradients within 1e-5 of
`jax.value_and_grad`; params after three train steps within 1e-5 of the
JAX step's (also with `accum_steps=2` and with `compress_grads`); the
launcher's losses within 1e-5 of the JAX launcher's; int8 compression bit
for bit; a killed launcher run resumed bit for bit; `remat` changes no bit.
Granite runs with `moe_use_kernel=False`: the JAX package's Pallas expert
kernel has no VJP rule.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.data.tokens import batch_for_step
from repro.distributed import compression as jcomp
from repro.distributed.sharding import Runtime
from repro.launch import train as jax_launch
from repro.models import encdec as jenc
from repro.models import lm as jlm
from repro.models.init import init_params as jax_init_params
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.step import build_train_step as jax_build_train_step
from repro_torch.configs import reduced_config as port_reduced_config
from repro_torch.distributed import compression as tcomp
from repro_torch.examples import train_lm as train_lm_example
from repro_torch.kernels.grad import kernel_with_plain_backward, needs_grad
from repro_torch.launch import train as port_launch
from repro_torch.params import (params_from_numpy, params_to_numpy,
                                tree_leaves)
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import build_train_step, value_and_grad

RT = Runtime(mesh=None)
ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-6
GRAD_ATOL = 1e-5
PARAM_ATOL = 1e-5
FAMILIES = ("qwen1.5-4b", "granite-moe-3b-a800m", "rwkv6-7b",
            "jamba-1.5-large-398b", "internvl2-2b", "seamless-m4t-large-v2")


def _configs(arch, **kw):
    cfg = reduced_config(arch).with_(**kw)
    tcfg = port_reduced_config(arch).with_(**kw)
    assert repr(cfg) == repr(tcfg)
    return cfg, tcfg


def _params(cfg, seed=0):
    jp = jax_init_params(jax.random.PRNGKey(seed), cfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _batch(cfg, step=0, global_batch=2, seq_len=32):
    b = batch_for_step(cfg, step, global_batch=global_batch, seq_len=seq_len)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _jax_loss(cfg):
    return jenc.encdec_loss if cfg.is_enc_dec else jlm.lm_loss


# ------------------------------------------------- the kernels' backward

def _stand_in(fn):
    """A "kernel" that computes `fn` outside autograd, as a launched CUDA
    kernel does (its output has no grad_fn)."""
    def kernel(*args):
        with torch.no_grad():
            return fn(*args)
    return kernel


def _scan(x, w, s0):
    """A two-output recurrence: (y, the final state), like wkv6_state."""
    s = torch.zeros_like(x[:, 0]) if s0 is None else s0
    ys = []
    for t in range(x.shape[1]):
        s = torch.tanh(s * w + x[:, t])
        ys.append(s * 2.0)
    return torch.stack(ys, 1), s


@pytest.mark.parametrize("case", ("one_output", "state_unused",
                                  "state_used", "no_initial_state"))
def test_kernel_with_plain_backward_gives_autograds_gradients(case):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 4, generator=g, requires_grad=True)
    w = torch.randn(4, generator=g, requires_grad=True)
    s0 = None if case == "no_initial_state" else torch.randn(
        3, 4, generator=g, requires_grad=True)
    if case == "one_output":
        def plain(x, w, s0):
            return _scan(x, w, s0)[0]
    else:
        plain = _scan
    out = kernel_with_plain_backward(_stand_in(plain), plain, x, w, s0)
    want = plain(x, w, s0)
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    for o, ww in zip(outs, wants):
        assert torch.equal(o, ww) and o.grad_fn is not None
    inputs = [t for t in (x, w, s0) if t is not None]
    # a loss that reads y only: the state's incoming gradient is None
    loss = (outs[0] ** 2).sum() + (
        outs[1].sum() if case == "state_used" else 0.0)
    got = torch.autograd.grad(loss, inputs)
    ref_loss = (wants[0] ** 2).sum() + (
        wants[1].sum() if case == "state_used" else 0.0)
    ref = torch.autograd.grad(ref_loss, inputs)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_with_plain_backward_zero_where_no_path():
    """An input the used outputs do not depend on gets zeros, not None."""
    a = torch.randn(4, requires_grad=True)
    b = torch.randn(4, requires_grad=True)

    def plain(a, b):
        return a * 3.0, b * 2.0
    y, _ = kernel_with_plain_backward(_stand_in(plain), plain, a, b)
    ga, gb = torch.autograd.grad(y.sum(), (a, b))
    assert torch.equal(ga, torch.full((4,), 3.0))
    assert torch.equal(gb, torch.zeros(4))


def test_needs_grad():
    x = torch.ones(2, requires_grad=True)
    assert needs_grad(None, x) and not needs_grad(torch.ones(2), None)
    with torch.no_grad():
        assert not needs_grad(x)


# --------------------------------------------------------- losses, grads

@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    cfg, tcfg = _configs(arch)
    jp, tp = _params(cfg)
    jb, tb = _batch(cfg)
    jloss, jg = jax.value_and_grad(
        lambda p: _jax_loss(cfg)(p, cfg, RT, jb))(jp)
    tloss, tg = value_and_grad(tp, tcfg, tb, allow_unused=False)
    tg = tree_leaves(tg)
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=LOSS_RTOL, atol=0)
    jgl = jax.tree.leaves(jg)
    assert len(jgl) == len(tg)
    for a, b in zip(jgl, tg):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=GRAD_ATOL)
    if cfg.frontend == "vision":          # the embeds offset p is used
        assert "embeds" in tb and tb["tokens"].shape[1] == 32 - 4


@pytest.mark.parametrize("arch", ("granite-moe-3b-a800m",
                                  "seamless-m4t-large-v2"))
def test_remat_changes_no_value(arch):
    """Each layer group under torch.utils.checkpoint: the same loss and
    gradients, bit for bit."""
    cfg, tcfg = _configs(arch)
    _, tp = _params(cfg, seed=1)
    _, tb = _batch(cfg, step=1)
    l1, g1 = value_and_grad(tp, tcfg, tb, allow_unused=False, remat=True)
    l0, g0 = value_and_grad(tp, tcfg, tb, allow_unused=False, remat=False)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(g0), tree_leaves(g1)))


# ------------------------------------------------------------ train steps

def _accum(batch, n):
    """Leaves [n * b, ...] -> [n, b, ...] (microbatches on a leading axis)."""
    return {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
            for k, v in batch.items()}


def _int8_codes(g):
    """float32 g / s with s = max(absmax(g), 1e-12) / 127: the value that
    `int8_roundtrip` rounds (the same float32 arithmetic)."""
    g = np.asarray(g, np.float32)
    s = np.float32(max(float(np.abs(g).max()), 1e-12)) / np.float32(127.0)
    return g / s


def _midpoints(jg, tg):
    """Per gradient leaf, the elements whose JAX int8 code lies within the
    observed JAX-port code distance of a rounding midpoint (k + 1/2):
    only there can the two sides round to neighbouring int8 steps. Asserts
    that every element the two rounded apart is among them."""
    masks = []
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
        xj, xt = _int8_codes(a), _int8_codes(b.numpy())
        dist = float(np.abs(xt - xj).max())
        near = np.abs(np.abs(xj - np.floor(xj)) - 0.5) <= dist
        assert not (np.round(xj) != np.round(xt))[~near].any()
        masks.append(near)
    return masks


@pytest.mark.parametrize("arch,kw", (
    ("qwen1.5-4b", {}),
    ("qwen1.5-4b", {"accum_steps": 2}),
    ("qwen1.5-4b", {"compress_grads": True}),
    ("internvl2-2b", {}),
    ("seamless-m4t-large-v2", {})),
    ids=("qwen", "qwen-accum2", "qwen-compress", "internvl2", "seamless"))
def test_three_train_steps_match_jax(arch, kw):
    cfg, tcfg = _configs(arch)
    jp, tp = _params(cfg, seed=2)
    jstep = jax.jit(jax_build_train_step(cfg, RT, peak_lr=1e-2, **kw))
    tstep = build_train_step(tcfg, peak_lr=1e-2, **kw)
    jo, to = jax_adamw_init(jp), adamw_init(tp)
    n = kw.get("accum_steps", 1)
    free = [np.zeros(np.shape(a), bool) for a in jax.tree.leaves(jp)]
    for step in range(3):
        jb, tb = _batch(cfg, step=step, global_batch=2 * n)
        if n > 1:
            jb, tb = _accum(jb, n), _accum(tb, n)
        if kw.get("compress_grads"):
            jg = jax.grad(lambda p: _jax_loss(cfg)(p, cfg, RT, jb))(jp)
            free = [f | m for f, m in zip(
                free, _midpoints(jg, value_and_grad(tp, tcfg, tb)[1]))]
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert float(tm["lr"]) == float(jm["lr"])
        assert int(tm["step"]) == int(jm["step"]) == step + 1
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=PARAM_ATOL)
    # Under compress_grads an element at an int8 midpoint may round to the
    # neighbouring step on one side (its moments then differ by a step);
    # every other element's moments are held. There each compressed
    # gradient is q * s with one scale s a leaf, so its float32 noise is
    # relative to the leaf's absmax, not to the element: the atol is 1e-4
    # of the leaf's largest moment.
    n_free = sum(int(f.sum()) for f in free)
    assert n_free <= 1e-3 * sum(f.size for f in free), n_free
    for a, b, f in zip(jax.tree.leaves((jo.m, jo.v)),
                       tree_leaves((to.m, to.v)), free + free):
        a = np.asarray(a)
        atol = (1e-4 * float(np.abs(a).max()) if kw.get("compress_grads")
                else 1e-9)
        np.testing.assert_allclose(b.numpy()[~f], a[~f], rtol=1e-4,
                                   atol=atol)


# ------------------------------------------------------------ compression

@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_int8_compression_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(3)
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    tree = {"w": (rng.standard_normal((33, 17)) * 0.05).astype(np_dtype),
            "b": (rng.standard_normal((17,)) * [1e-3] * 17).astype(np_dtype),
            "zero": np.zeros((5,), np_dtype),
            "step": np.asarray(7, np.int32),
            "ids": rng.integers(-9, 9, (6,)).astype(np.int32)}
    want = params_to_numpy(params_from_numpy(jax.tree.map(
        np.asarray, jcomp.int8_compress_tree(jax.tree.map(jnp.asarray,
                                                          tree)))))
    got = params_to_numpy(tcomp.int8_compress_tree(params_from_numpy(tree)))
    for key in tree:
        assert got[key].dtype == want[key].dtype
        assert got[key].tobytes() == want[key].tobytes(), key
    for key in ("w", "b"):
        g = params_from_numpy(tree[key])
        assert tcomp.compression_error_bound(g) == \
            jcomp.compression_error_bound(jnp.asarray(tree[key]))
        if dtype == "float32":       # bf16 adds the rounding of the cast
            err = (tcomp.int8_roundtrip(g) - g).abs().max()
            assert float(err) <= tcomp.compression_error_bound(g) * 1.01


# --------------------------------------------------------------- launcher

def _lm_args(ckpt_dir, steps, *extra):
    return ["--model", "qwen1.5-4b", "--reduced", "--steps", str(steps),
            "--batch", "2", "--seq-len", "32", "--ckpt-dir", str(ckpt_dir),
            *extra]


def test_lm_launcher_matches_the_jax_launcher(tmp_path, monkeypatch):
    """Both launchers from the same (converted) params: the same recorded
    losses, gradient norms and learning rates, steps 0 and 3."""
    import repro_torch.models.init as port_init

    cfg = reduced_config("qwen1.5-4b")
    jp = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0),
                                                  cfg))
    monkeypatch.setattr(port_init, "init_params",
                        lambda gen, cfg, device=None:
                        params_from_numpy(jp, device))
    want = jax_launch.main(_lm_args(tmp_path / "jax", 4, "--lr", "1e-2"))
    got = port_launch.main(_lm_args(tmp_path / "port", 4, "--lr", "1e-2",
                                    "--device", "cpu"))
    assert len(got.history) == len(want) == 2
    for g, w in zip(got.history, want):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, atol=0)
    assert int(got.opt_state.step) == 4


def _bit_equal(a, b) -> bool:
    la, lb = tree_leaves((a.params, a.opt_state)), \
        tree_leaves((b.params, b.opt_state))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_lm_launcher_killed_run_resumes_bit_for_bit(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         *_lm_args(tmp_path / "killed", 6, "--ckpt-every", "2",
                   "--simulate-failure", "4", "--log-every", "1",
                   "--device", "cpu")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 42, proc.stdout + proc.stderr
    assert "[train] simulated failure after step 4!" in proc.stdout
    assert sorted(os.listdir(tmp_path / "killed")) == ["step_000000002",
                                                       "step_000000004"]
    resumed = port_launch.main(_lm_args(tmp_path / "killed", 6,
                                        "--ckpt-every", "2", "--device",
                                        "cpu"))
    straight = port_launch.main(_lm_args(tmp_path / "straight", 6,
                                         "--ckpt-every", "2", "--device",
                                         "cpu"))
    assert int(resumed.opt_state.step) == 6
    assert _bit_equal(resumed, straight)


@pytest.mark.parametrize("arch", ("qwen1.5-4b", "seamless-m4t-large-v2"))
def test_lm_launcher_trains_each_kind_on_cpu(tmp_path, arch, capsys):
    run = port_launch.main(["--model", arch, "--reduced", "--steps", "2",
                            "--batch", "2", "--seq-len", "16",
                            "--compress-grads", "--log-every", "1",
                            "--device", "cpu", "--ckpt-dir",
                            str(tmp_path)])
    assert [r["loss"] > 0 for r in run.history] == [True, True]
    assert "[train] final loss" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["step_000000002"]


def test_train_lm_example_runs_on_cpu(tmp_path, capsys):
    run = train_lm_example.main(["--steps", "2", "--device", "cpu",
                                 "--ckpt-dir", str(tmp_path)])
    assert int(run.opt_state.step) == 2
    assert np.isfinite(run.history[-1]["loss"])
    assert "[train] final loss" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["step_000000002"]
