"""The port's GPipe pipeline (`repro_torch.distributed.pipeline`) against the
JAX package's `repro.distributed.pipeline.gpipe`, on the CPU.

The JAX gpipe is a `shard_map` over simulated host devices, which XLA
fixes when its backend starts, so a module fixture runs the JAX side once
in a subprocess under `XLA_FLAGS=--xla_force_host_platform_device_count=8`
(this file run as a script) and keeps each case's pipelined output and
the gradients of sum(y ** 2) with respect to the stacked params and to x
in a temporary npz. Its meshes are Auto-axes `jax.sharding.Mesh`es: under
`jax.make_mesh`'s Explicit axes the JAX gpipe raises (its own test in
tests/test_distributed.py fails so). The port runs the same calls on
logical CPU devices (`distributed.sharding.logical_devices`), in float32,
on the same numpy inputs; LM stage params are the JAX package's init,
carried over by `repro_torch.params`, and both sides stack the same
per-stage trees.

Cases: (a) the JAX test's stage function x + tanh(x @ w1) @ w2 (d 16,
hidden 32, 8 rows) on a ("stage",) mesh of 4 with 4, 2, 8 and the default
microbatches, and on meshes of 1 and 2 stages; (b) the same on a 2 x 2
("data", "model") mesh pipelined over "model"; (c) reduced float32 granite
(MoE and attention) and rwkv6, two stages of their layer groups, each
stage running its groups (JAX `lm._scan_groups` with `Runtime(mesh=None)`,
the port's `lm._run_groups`).

Bounds: y and each gradient leaf within 1e-6 of its largest absolute
value (JAX's own pipelined-to-sequential gap is about 1.2e-7 of it). y is
held relative too: the toy stage function's y reaches |10|, where one
float32 ulp is 9.5e-7, and each side alone is up to 2.7e-6 from a float64
run (the gradients up to 8.5e-7 of their largest value). Port-only: two
calls bit-equal; the pipelined y and gradients bit-equal to the stages
applied in order microbatch by microbatch (`pipeline.sequential`); a
batch the microbatch count does not divide raises AssertionError (both
functions); ShardedTensor params laid out by P("stage") give the whole
params' values and gradients; and a control: the port's result with its
last microbatch dropped breaks the bounds against JAX.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.distributed.sharding import Runtime as JaxRuntime
from repro.models import lm as jlm
from repro.models.init import init_params as jax_init_params
from repro_torch.configs import reduced_config
from repro_torch.distributed import placement, sharding
from repro_torch.distributed.pipeline import (gpipe, sequential,
                                              stack_stage_params)
from repro_torch.models import lm
from repro_torch.params import params_from_numpy, tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
BOUND = 1e-6
D, HIDDEN, ROWS = 16, 32, 8
LM_BATCH, LM_TOKENS = 4, 16
GRANITE, RWKV = "granite-moe-3b-a800m", "rwkv6-7b"
#: case -> (stage function: "toy" or an arch, mesh axis sizes, axis names,
#: pipeline axis, n_microbatches)
CASES = {
    "s4_m4": ("toy", (4,), ("stage",), "stage", 4),
    "s4_m2": ("toy", (4,), ("stage",), "stage", 2),
    "s4_m8": ("toy", (4,), ("stage",), "stage", 8),
    "s4_default": ("toy", (4,), ("stage",), "stage", None),
    "s1": ("toy", (1,), ("stage",), "stage", None),
    "s2": ("toy", (2,), ("stage",), "stage", None),
    "data_model": ("toy", (2, 2), ("data", "model"), "model", None),
    "granite": (GRANITE, (2,), ("stage",), "stage", None),
    "rwkv6": (RWKV, (2,), ("stage",), "stage", None),
}
JAX_TIMEOUT_S = 300


def _n_stages(case) -> int:
    _, sizes, names, axis, _ = CASES[case]
    return dict(zip(names, sizes))[axis]


def _inputs(case):
    """(per-stage numpy trees, x) of a case; the same on both sides."""
    family = CASES[case][0]
    s = _n_stages(case)
    rng = np.random.default_rng(sorted(CASES).index(case))
    if family == "toy":
        stages = [{"w1": (rng.standard_normal((D, HIDDEN)) * 0.3).astype(
                       np.float32),
                   "w2": (rng.standard_normal((HIDDEN, D)) * 0.3).astype(
                       np.float32)} for _ in range(s)]
        return stages, rng.standard_normal((ROWS, D)).astype(np.float32)
    cfg = jax_reduced_config(family)
    groups = jax.tree.map(np.asarray, jax_init_params(
        jax.random.PRNGKey(0), cfg)["groups"])
    k = cfg.n_groups // s
    stages = [jax.tree.map(lambda a, i=i: a[i * k:(i + 1) * k], groups)
              for i in range(s)]
    x = rng.standard_normal((LM_BATCH, LM_TOKENS, cfg.d_model))
    return stages, x.astype(np.float32)


# ----------------------------------------------------------- the JAX side

def _jax_stage_fn(family):
    if family == "toy":
        return lambda p, x: x + jnp.tanh(x @ p["w1"]) @ p["w2"]
    cfg = jax_reduced_config(family)

    def fn(p, x):
        b, t, _ = x.shape
        pos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (b, t))
        return jlm._scan_groups({"groups": p}, cfg, JaxRuntime(mesh=None),
                                x, positions=pos)[0]

    return fn


def _jax_main(out_path: str) -> None:
    from repro.distributed.pipeline import gpipe as jax_gpipe
    from repro.distributed.pipeline import stack_stage_params as jax_stack

    assert jax.local_device_count() == 8, jax.local_device_count()
    out = {}
    for case, (family, sizes, names, axis, m) in CASES.items():
        n = int(np.prod(sizes))
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:n]).reshape(sizes), names)
        stages, x = _inputs(case)
        stacked = jax_stack([jax.tree.map(jnp.asarray, t) for t in stages])
        piped = jax_gpipe(_jax_stage_fn(family), mesh, axis=axis,
                          n_microbatches=m)
        out[f"{case}/y"] = np.asarray(jax.jit(piped)(stacked, x))
        gp, gx = jax.jit(jax.grad(
            lambda ps, xx: jnp.sum(piped(ps, xx) ** 2), argnums=(0, 1)))(
            stacked, jnp.asarray(x))
        for i, g in enumerate(jax.tree.leaves(gp) + [gx]):
            out[f"{case}/g{i}"] = np.asarray(g)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_pipeline") / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True,
                          timeout=JAX_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


# ----------------------------------------------------------- the port side

def _stage_fn(family):
    if family == "toy":
        return lambda p, x: x + torch.tanh(x @ p["w1"]) @ p["w2"]
    cfg = reduced_config(family)
    return lambda p, x: lm._run_groups({"groups": p}, cfg, x,
                                       positions=lm._positions(x))[0]


def _mesh(case):
    _, sizes, names, _, _ = CASES[case]
    with sharding.logical_devices(8, "cpu"):
        return sharding.lm_mesh(sizes, names, "cpu")


def _stacked(case):
    """(the stacked tree of per-stage trees requiring grad, x)."""
    stages, x = _inputs(case)
    trees = [tree_map(lambda t: t.requires_grad_(), params_from_numpy(t))
             for t in stages]
    return stack_stage_params(trees), torch.from_numpy(x).requires_grad_()


def _run(case, stacked, x, drop=None, build=gpipe):
    """The port's pipelined y (`sequential`'s with `build=sequential`) and
    the gradients of sum(y ** 2) with respect to the stacked leaves and x.
    `drop`: a microbatch left out of y (its rows zero) and so of the
    loss."""
    family, _, _, axis, m = CASES[case]
    apply = build(_stage_fn(family), _mesh(case), axis=axis,
                  n_microbatches=m)
    y = apply(stacked, x)
    if drop is not None:
        rows = x.shape[0] // (m or _n_stages(case))
        keep = torch.ones(x.shape[0], dtype=torch.bool)
        keep[drop * rows:(drop + 1) * rows] = False
        y = y * keep.reshape(-1, *(1,) * (y.ndim - 1))
    grads = torch.autograd.grad(torch.sum(y ** 2),
                                tree_leaves(stacked) + [x])
    return y.detach(), [g.detach() for g in grads]


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    """max |got - want| over want's largest |value|."""
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _errors(case, y, grads, want) -> tuple[float, list]:
    """(y's error, each gradient leaf's error) against the JAX side's, each
    relative to the JAX tensor's largest |value|."""
    return _rel(y, want[f"{case}/y"]), [
        _rel(g, want[f"{case}/g{i}"]) for i, g in enumerate(grads)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_gpipe_matches_jax(jax_side, case):
    """y and every gradient leaf (stacked params, then x) within 1e-6 of
    the JAX gpipe's, relative to its largest |value|."""
    stacked, x = _stacked(case)
    y, grads = _run(case, stacked, x)
    assert y.shape == x.shape
    y_err, rel = _errors(case, y, grads, jax_side)
    assert y_err <= BOUND, y_err
    assert max(rel) <= BOUND, rel


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_dropped_microbatch_breaks_the_bounds(jax_side, case):
    """The last microbatch dropped from the port's y (and so from the
    loss): y and every gradient leaf fall outside the bounds of
    test_gpipe_matches_jax."""
    stacked, x = _stacked(case)
    m = CASES[case][4] or _n_stages(case)
    y, grads = _run(case, stacked, x, drop=m - 1)
    y_err, rel = _errors(case, y, grads, jax_side)
    assert y_err > BOUND
    assert all(r > BOUND for r in rel), rel


@pytest.mark.parametrize("case", sorted(CASES))
def test_gpipe_is_the_stages_in_order_bit_for_bit(case):
    """The pipelined y and its gradients equal the stages applied in
    order, microbatch by microbatch (`sequential`), bit for bit."""
    stacked, x = _stacked(case)
    y, grads = _run(case, stacked, x)
    want_y, want = _run(case, stacked, x, build=sequential)
    assert torch.equal(y, want_y)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


@pytest.mark.parametrize("case", ("s4_m4", "data_model", "granite"))
def test_gpipe_repeats_bit_for_bit(case):
    stacked, x = _stacked(case)
    y1, g1 = _run(case, stacked, x)
    y2, g2 = _run(case, stacked, x)
    assert torch.equal(y1, y2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("build", (gpipe, sequential))
@pytest.mark.parametrize("m", (3, 5, 16))
def test_batch_not_divisible_by_microbatches_raises(m, build):
    stacked, x = _stacked("s4_m4")
    apply = build(_stage_fn("toy"), _mesh("s4_m4"), n_microbatches=m)
    with pytest.raises(AssertionError, match=r"\(8, 16\)"):
        apply(stacked, x)


@pytest.mark.parametrize("case", ("s4_m4", "granite"))
def test_sharded_stage_params_equal_whole_params(case):
    """Stacked leaves laid out by NamedSharding(mesh, P("stage")) (one
    block a stage) give the whole params' y bit for bit, and each block's
    gradient is the whole leaf's gradient at its stage."""
    stacked, x = _stacked(case)
    y, grads = _run(case, stacked, x)
    mesh = _mesh(case)
    blocks = tree_map(lambda t: placement.shard(
        t.detach(), sharding.NamedSharding(mesh, sharding.P("stage"))),
        stacked)
    leaves = [b for st in tree_leaves(blocks) for b in st.blocks]
    for b in leaves:
        b.requires_grad_()
    family, _, _, axis, m = CASES[case]
    ys = gpipe(_stage_fn(family), mesh, axis=axis, n_microbatches=m)(
        blocks, x)
    assert torch.equal(ys.detach(), y)
    got = torch.autograd.grad(torch.sum(ys ** 2), leaves + [x])
    s = _n_stages(case)
    for i, whole in enumerate(grads[:-1]):
        for k in range(s):
            assert torch.equal(got[i * s + k][0], whole[k]), (i, k)
    assert torch.equal(got[-1], grads[-1])


def test_sharded_stage_params_on_another_layout_raise():
    stacked, x = _stacked("s4_m4")
    mesh = _mesh("s4_m4")
    wrong = tree_map(lambda t: placement.shard(
        t.detach(), sharding.NamedSharding(mesh, sharding.P(None))), stacked)
    with pytest.raises(ValueError, match="P\\('stage'\\)"):
        gpipe(_stage_fn("toy"), mesh)(wrong, x)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
