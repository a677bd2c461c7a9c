"""Checkpoints of sharded trees and elastic resharding (`ckpt/manager.py`
with `shardings=`, `ckpt/reshard.py`, the loop's resume onto its own
layout, the launcher's `--mesh DxM`) against the JAX package's on the CPU.

A module fixture writes a checkpoint of a port run on a (2, 2) mesh of
logical CPU devices, then runs the JAX side in a subprocess under
`XLA_FLAGS=--xla_force_host_platform_device_count=8` (this file run as a
script): the JAX manager restores the port's checkpoint onto an Auto-axes
(2, 2) `jax.sharding.Mesh` (params and AdamW moments on `param_shardings`)
and writes a checkpoint of its own mesh run, the leaves of both kept in a
temporary npz.

Bounds: every leaf bit-equal across packages, meshes and layouts; a
sharded save's manifest and arrays equal an unsharded save's; a killed
(2, 2) run resumed bit for bit on (2, 2), and on (2, 1) (the same batch
replicas, data-parallel where (2, 2) trains tensor-parallel over rows of
two) within RESUME_ATOL. Every run of the launcher computes at one CPU
thread, the killed subprocess too: a multithreaded CPU GEMM may split its
sums differently from one call to the next.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.data.tokens import batch_for_step
from repro.models.init import init_params as jax_init_params
from repro_torch.ckpt import manager as ckpt
from repro_torch.ckpt.reshard import (reshard_live, restore_on_mesh,
                                      train_state_shardings)
from repro_torch.configs import reduced_config as port_reduced_config
from repro_torch.distributed import placement, sharding
from repro_torch.launch.mesh import mesh_runtime
from repro_torch.launch.train import main as launch
from repro_torch.params import params_from_numpy, tree_leaves
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import build_train_step

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen1.5-4b"
JAX_TIMEOUT_S = 600
#: the (2, 1) resume against the straight (2, 2) run: data-parallel steps
#: 5 and 6 against tensor-parallel ones
RESUME_ATOL = 1e-5


def _jax_params():
    return jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0),
                                                    reduced_config(ARCH)))


def _batch(step):
    return batch_for_step(reduced_config(ARCH), step, global_batch=4,
                          seq_len=32)


# ---------------------------------------------------------- the JAX side

def _jax_main(port_dir: str, jax_dir: str, out: str) -> None:
    """Restore the port's checkpoint onto an Auto (2, 2) mesh, and write a
    checkpoint of one JAX mesh step."""
    from repro.ckpt import manager as jckpt
    from repro.distributed import sharding as js
    from repro.train.optimizer import adamw_init as jax_adamw_init
    from repro.train.step import build_train_step as jax_build_train_step

    assert jax.local_device_count() == 8, jax.local_device_count()
    cfg = reduced_config(ARCH)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    rt = js.make_runtime(mesh)
    params = jax.tree.map(jnp.asarray, _jax_params())
    ps = js.param_shardings(rt, params)
    like = (params, jax_adamw_init(params))
    shardings = (ps, type(like[1])(step=js.replicated(rt), m=ps, v=ps))
    restored = jckpt.restore(port_dir, 1, like, shardings=shardings)
    rec = {}
    for i, leaf in enumerate(jax.tree.leaves(restored)):
        rec[f"restored/{i}"] = np.asarray(leaf)
        rec[f"restored/{i}/shards"] = np.asarray(
            len(leaf.addressable_shards))
    for i, (leaf, s) in enumerate(zip(jax.tree.leaves(restored[0]),
                                      jax.tree.leaves(ps))):
        assert leaf.sharding.spec == s.spec, i
    placed = jax.tree.map(jax.device_put, params, ps)
    step = jax.jit(jax_build_train_step(cfg, rt, peak_lr=1e-2))
    p, o, _ = step(placed, jax_adamw_init(placed),
                   {k: jnp.asarray(v) for k, v in _batch(0).items()})
    jckpt.save(jax_dir, 1, (p, o))
    for i, leaf in enumerate(jax.tree.leaves((p, o))):
        rec[f"saved/{i}"] = np.asarray(leaf)
    np.savez(os.path.join(out, "jax.npz"), **rec)


# --------------------------------------------------------- the port side

def _runtime(shape):
    spec = "none" if shape is None else "x".join(map(str, shape))
    return mesh_runtime(spec, torch.device("cpu"))[0]


def _shardings(shape, tree):
    """The param rules' shardings of (params, AdamW state) on a mesh of
    `shape` (None entries off-mesh and for the step counter)."""
    return train_state_shardings(_runtime(shape), tree[0])


def _port_mesh_step():
    """(params, AdamW state) after one port step on (2, 2), sharded."""
    cfg = port_reduced_config(ARCH)
    rt = _runtime((2, 2))
    params = params_from_numpy(_jax_params())
    params = placement.shard_tree(params, sharding.param_shardings(rt,
                                                                   params))
    step = build_train_step(cfg, rt, peak_lr=1e-2)
    p, o, _ = step(params, adamw_init(params), _batch(0))
    return p, o


def _whole(tree) -> list:
    return [placement.gather(x) for x in tree_leaves(tree)]


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(port tree, port checkpoint dir, JAX checkpoint dir, JAX records)."""
    out = tmp_path_factory.mktemp("reshard")
    tree = _port_mesh_step()
    ckpt.save(str(out / "port"), 1, tree)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, __file__, str(out / "port"),
                           str(out / "jax"), str(out)], env=env,
                          capture_output=True, text=True,
                          timeout=JAX_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "jax.npz") as z:
        rec = dict(z)
    return tree, out / "port", out / "jax", rec


# ---------------------------------------------------------- checkpoints

def test_port_mesh_checkpoint_restores_in_jax_onto_a_mesh(sides):
    tree, _, _, rec = sides
    leaves = _whole(tree)
    for i, leaf in enumerate(leaves):
        want = rec[f"restored/{i}"]
        assert leaf.numpy().tobytes() == want.tobytes(), i
        assert leaf.numpy().dtype == want.dtype
    assert all(int(rec[f"restored/{i}/shards"]) == 4
               for i in range(len(leaves)))


def test_jax_mesh_checkpoint_restores_onto_the_port_mesh(sides):
    tree, _, jax_dir, rec = sides
    restored = ckpt.restore(str(jax_dir), 1, tree)
    for x, s in zip(tree_leaves(restored), tree_leaves(
            placement.tree_shardings(tree))):
        assert (s is None) == (not isinstance(x, placement.ShardedTensor))
        if s is not None:
            assert x.sharding.spec == s.spec
            assert x.sharding.mesh.axis_sizes == (2, 2)
    for i, leaf in enumerate(_whole(restored)):
        assert leaf.numpy().tobytes() == rec[f"saved/{i}"].tobytes(), i


def test_sharded_save_equals_an_unsharded_save(sides, tmp_path):
    """The manifest (keys, dtypes, shapes, step) and every npz entry of a
    save of the sharded tree equal a save of its gathered leaves; so do
    an async save's."""
    tree, port_dir, _, _ = sides
    whole = placement.gather_tree(tree)
    ckpt.save(str(tmp_path / "whole"), 1, whole)
    ckpt.save_async(str(tmp_path / "async"), 1, tree).join()

    def read(path):
        m = ckpt._read_manifest(str(path / "step_000000001"))
        with np.load(path / "step_000000001" / "arrays.0.npz") as z:
            arrays = {k: z[k] for k in z.files}
        return ({k: m[k] for k in ("keys", "dtypes", "shapes", "step")},
                arrays)

    want_m, want_a = read(tmp_path / "whole")
    for path in (port_dir, tmp_path / "async"):
        got_m, got_a = read(path)
        assert got_m == want_m
        assert sorted(got_a) == sorted(want_a)
        for k in want_a:
            assert got_a[k].tobytes() == want_a[k].tobytes(), k


@pytest.mark.parametrize("shape", ((4, 1), (1, 4), None),
                         ids=("4x1", "1x4", "none"))
def test_restore_on_mesh_lays_out_onto_other_meshes(sides, shape):
    tree, port_dir, _, _ = sides
    restored = restore_on_mesh(str(port_dir), 1, tree,
                               _shardings(shape, tree))
    assert _equal(_whole(restored), _whole(tree))
    for x in tree_leaves(restored[0]):
        if shape is None:
            assert isinstance(x, torch.Tensor)
        else:
            assert isinstance(x, placement.ShardedTensor)
            assert x.sharding.mesh.axis_sizes == shape


@pytest.mark.parametrize("shape", ((4, 1), (1, 4), None),
                         ids=("4x1", "1x4", "none"))
def test_reshard_live_lays_out_onto_other_meshes(sides, shape):
    """From (2, 2) onto another layout; a None sharding leaves its leaf as
    it is, as JAX's `reshard_live` does."""
    tree, _, _, _ = sides
    moved = reshard_live(tree, _shardings(shape, tree))
    assert _equal(_whole(moved), _whole(tree))
    for x, y in zip(tree_leaves(moved[0]), tree_leaves(tree[0])):
        if shape is None:
            assert x is y
        else:
            assert x.sharding.mesh.axis_sizes == shape
            assert all(a.untyped_storage().data_ptr()
                       != b.untyped_storage().data_ptr()
                       for a in x.blocks for b in y.blocks)


def test_restore_without_shardings_keeps_the_like_trees_layout(sides):
    tree, port_dir, _, _ = sides
    restored = ckpt.restore(str(port_dir), 1, tree)
    assert _equal(_whole(restored), _whole(tree))
    assert [x.sharding for x in tree_leaves(restored[0])] == \
        [x.sharding for x in tree_leaves(tree[0])]


# ------------------------------------------------- a killed mesh run

def _args(ckpt_dir, mesh, *extra):
    return ["--model", ARCH, "--reduced", "--steps", "6", "--batch", "4",
            "--seq-len", "32", "--ckpt-every", "2", "--mesh", mesh,
            "--device", "cpu", "--ckpt-dir", str(ckpt_dir), "--log-every",
            "1", *extra]


def _departure(run, ref, atol: float = 0.0) -> str | None:
    """Where `run` first departs from `ref` by more than `atol`: the
    first logged step whose loss or grad norm does, and the first leaf of
    the final (params, AdamW state) that does; None when nothing does."""
    logged = {h["step"]: h for h in ref.history}
    steps = [g["step"] for g in run.history
             if any(abs(logged[g["step"]][k] - g[k]) > atol
                    for k in ("loss", "grad_norm"))]
    paths = {}
    sharding.map_with_path(lambda path, x: paths.setdefault(len(paths), path),
                           (ref.params, ref.opt_state))
    leaves = [(paths[i], x, y) for i, (x, y) in enumerate(zip(
        _whole((run.params, run.opt_state)),
        _whole((ref.params, ref.opt_state))))]
    bad = [path for path, x, y in leaves
           if x.dtype != y.dtype or not (torch.equal(x, y) if atol == 0 else
                                         float((x - y).abs().max()) <= atol)]
    if not steps and not bad:
        return None
    return (f"first step departing: {steps[0] if steps else 'none logged'}; "
            f"first leaf departing: {bad[0] if bad else 'none'}")


def test_killed_mesh_run_resumes_bit_for_bit(tmp_path):
    """The launcher on (2, 2) killed after step 4 (exit 42), resumed on
    (2, 2) and, from a copy of its checkpoints, on (2, 1): the (2, 2)
    resume bit-equal to an uninterrupted (2, 2) run, the (2, 1) resume
    (data-parallel steps 5 and 6, tensor-parallel on (2, 2)) within
    RESUME_ATOL; their leaves on their own layout. The killed subprocess
    computes at one thread, as the runs in this process do."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         *_args(tmp_path / "killed", "2x2", "--simulate-failure", "4")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 42, proc.stdout + proc.stderr
    assert "4 logical devices over cpu" in proc.stdout
    assert "model row: 2 members" in proc.stdout
    shutil.copytree(tmp_path / "killed", tmp_path / "killed21")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = [launch(_args(tmp_path / name, mesh)) for name, mesh in (
            ("killed", "2x2"), ("killed21", "2x1"), ("straight", "2x2"))]
    finally:
        torch.set_num_threads(threads)
    for run, shape, atol in zip(runs[:2], ((2, 2), (2, 1)),
                                (0.0, RESUME_ATOL)):
        assert int(run.opt_state.step) == 6
        assert _departure(run, runs[2], atol) is None, (
            shape, _departure(run, runs[2], atol))
        assert {x.sharding.mesh.axis_sizes
                for x in tree_leaves((run.params, run.opt_state.m))} == \
            {shape}


if __name__ == "__main__":
    _jax_main(*sys.argv[1:4])
