"""The port's optimizer, gradient functions and SimGNN train step against
`repro.train`, on the CPU.

AdamW (float32 and bf16 moments), the cosine schedule and global-norm
clipping equal the JAX package's on the same numbers (float32: within
1e-6); `StandardGradient` / `ClippedGradient` give the JAX package's
values and grads (1e-6); three `build_simgnn_train_step` steps from
converted params and optimizer state stay within 1e-5 of JAX's (params,
moments, loss, grad norm, lr, step); the non-finite skip leaves params and
state bit-identical and counts it; each step lands one `"train_step"`
trace.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import ScoringEngine as JaxEngine
from repro.core.simgnn import SimGNNConfig as JaxConfig
from repro.core.simgnn import init_simgnn_params
from repro.train import optimizer as jopt
from repro.train import sgf as jsgf
from repro.train.step import build_simgnn_train_step as jax_train_step
from repro_torch.core.engine import ScoringEngine
from repro_torch.core.simgnn import SimGNNConfig
from repro_torch.data.graphs import pair_stream, random_graph
from repro_torch.params import (adamw_state_from_numpy, adamw_state_to_numpy,
                                params_from_numpy, tree_leaves)
from repro_torch.testing import faults
from repro_torch.train import optimizer as topt
from repro_torch.train import sgf as tsgf
from repro_torch.train.step import build_simgnn_apply, build_simgnn_train_step

CFG = SimGNNConfig()
JCFG = JaxConfig()
#: float32 bound on one optimizer op against the JAX package's.
OPT_ATOL = 1e-6
#: float32 bound on params, moments and metrics after three train steps.
STEP_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _jparams():
    return init_simgnn_params(jax.random.PRNGKey(0), JCFG)


def _tparams():
    return params_from_numpy(jax.tree.map(np.asarray, _jparams()), "cpu")


def _tree(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"w": (4, 3), "b": (3,), "k": (2, 2, 2)}


def _close(got, want, atol):
    g = tree_leaves(got) if not isinstance(got, np.ndarray) else [got]
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.detach().float().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a, np.float32)
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("state_dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("steps", (1, 3))
def test_adamw_matches_jax(steps, state_dtype):
    p, g = _tree(0, SHAPES), _tree(1, SHAPES, 0.1)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = params_from_numpy(p)
    js, ts = jopt.adamw_init(jp, state_dtype), topt.adamw_init(tp,
                                                                state_dtype)
    assert ts.m["w"].dtype == getattr(torch, state_dtype)
    for i in range(steps):
        gi = {k: v * (i + 1) for k, v in g.items()}
        jp, js = jopt.adamw_update({k: jnp.asarray(v) for k, v in gi.items()},
                                   js, jp, lr=0.01 * (i + 1))
        tp, ts = topt.adamw_update(params_from_numpy(gi), ts, tp,
                                   lr=0.01 * (i + 1))
    atol = OPT_ATOL if state_dtype == "float32" else 1e-3
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(ts.m[k].float().numpy(),
                                   np.asarray(js.m[k], np.float32), rtol=0,
                                   atol=atol)
    assert int(ts.step) == int(js.step) == steps


@pytest.mark.parametrize("step", (0, 9, 30, 99, 150))
def test_cosine_schedule_matches_jax(step):
    kw = dict(peak_lr=1.0, warmup=10, total=100, floor=0.1)
    got = topt.cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
    want = jopt.cosine_schedule(jnp.asarray(step, jnp.int32), **kw)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= OPT_ATOL


@pytest.mark.parametrize("max_norm", (0.5, 100.0))
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(2, SHAPES)
    tg, tn = topt.clip_by_global_norm(params_from_numpy(g), max_norm)
    jg, jn = jopt.clip_by_global_norm({k: jnp.asarray(v)
                                       for k, v in g.items()}, max_norm)
    assert abs(float(tn) - float(jn)) <= OPT_ATOL
    for k in g:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=0,
                                   atol=OPT_ATOL)


@pytest.mark.parametrize("kind", ("standard", "clipped"))
def test_gradient_functions_match_jax(kind):
    x = _tree(3, {"w": (5, 3)})
    y = np.random.default_rng(4).normal(size=(7, 3)).astype(np.float32)
    a = np.random.default_rng(5).normal(size=(7, 5)).astype(np.float32)

    def tloss(p, a, y):
        return torch.sum((a @ p["w"] - y) ** 2)

    def jloss(p, a, y):
        return jnp.sum((a @ p["w"] - y) ** 2)
    tfn = tsgf.StandardGradient() if kind == "standard" \
        else tsgf.ClippedGradient(0.5)
    jfn = jsgf.StandardGradient() if kind == "standard" \
        else jsgf.ClippedGradient(0.5)
    assert tfn.cache_key == jfn.cache_key
    tv, tg = tfn.value_and_grad(tloss)(params_from_numpy(x),
                                       torch.from_numpy(a),
                                       torch.from_numpy(y))
    jv, jg = jfn.value_and_grad(jloss)({"w": jnp.asarray(x["w"])},
                                       jnp.asarray(a), jnp.asarray(y))
    assert abs(float(tv) - float(jv)) <= OPT_ATOL * max(1.0, abs(float(jv)))
    np.testing.assert_allclose(tg["w"].numpy(), np.asarray(jg["w"]),
                               rtol=1e-6, atol=1e-5)
    assert not tg["w"].requires_grad
    if kind == "clipped":
        assert float(tsgf.global_norm(tg)) <= 0.5 + 1e-6


def test_adamw_state_round_trips_through_numpy():
    js = jopt.adamw_init(_jparams())
    js = js._replace(step=jnp.asarray(7, jnp.int32))
    ts = adamw_state_from_numpy(jax.tree.map(np.asarray, js))
    assert int(ts.step) == 7 and ts.step.dtype == torch.int32
    step, m, v = adamw_state_to_numpy(ts)
    assert int(step) == 7
    assert jax.tree.structure(jax.tree.map(np.asarray, js.m)) == \
        jax.tree.structure(m)


def _batches(seed=21, n=3, batch=8):
    stream = pair_stream(seed, batch, device="cpu")
    return [next(stream) for _ in range(n)]


@pytest.mark.parametrize("path", ("auto", "packed_dense", "reference"))
def test_three_train_steps_match_jax(path):
    batches = _batches()
    jeng = JaxEngine(_jparams(), JCFG, path=path, planner="threshold")
    teng = ScoringEngine(_tparams(), CFG, path=path, device="cpu")
    jstep = jax_train_step(jeng, peak_lr=1e-2)
    tstep = build_simgnn_train_step(teng, peak_lr=1e-2)
    jp, js = _jparams(), jopt.adamw_init(_jparams())
    tp = _tparams()
    ts = adamw_state_from_numpy(jax.tree.map(np.asarray, js))
    for b in batches:
        batch = {"pairs": b["pairs"], "target": b["target"]}
        jp, js, jm = jstep(jp, js, batch)
        tp, ts, tm = tstep(tp, ts, batch)
        assert teng.last_plan.path == jeng.last_plan.path
        for key in ("loss", "grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= STEP_ATOL, key
        assert int(tm["step"]) == int(jm["step"])
    _close(tp, jp, STEP_ATOL)
    _close(ts.m, js.m, STEP_ATOL)
    _close(ts.v, js.v, STEP_ATOL)
    moved = max(float(np.abs(a.numpy() - b).max()) for a, b in zip(
        tree_leaves(tp), jax.tree.leaves(jax.tree.map(np.asarray,
                                                      _jparams()))))
    assert moved > 1e-3


def test_nonfinite_step_is_skipped_bit_identical():
    rng = np.random.default_rng(12)
    pairs = [(random_graph(rng, 10), random_graph(rng, 12)) for _ in range(6)]
    batch = {"pairs": pairs,
             "target": np.linspace(0.2, 0.8, 6).astype(np.float32)}
    eng = ScoringEngine(_tparams(), CFG, path="reference", device="cpu")
    step = build_simgnn_train_step(eng)
    params = _tparams()
    opt_state = topt.adamw_init(params)
    with faults.inject("train:reference", mode="nan"):
        p1, o1, metrics = step(params, opt_state, batch)
    assert float(metrics["skipped"]) == 1.0
    assert eng.counters["train_skipped_steps"] == 1
    for a, b in zip(tree_leaves((params, opt_state)),
                    tree_leaves((p1, o1))):
        assert torch.equal(a, b)
    p2, o2, metrics2 = step(p1, o1, batch)
    assert "skipped" not in metrics2
    assert int(metrics2["step"]) == int(o1.step) + 1
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(p1),
                                                     tree_leaves(p2)))


def test_nan_target_dropped_and_counted():
    rng = np.random.default_rng(10)
    pairs = [(random_graph(rng, 9), random_graph(rng, 11)) for _ in range(8)]
    tgt = np.linspace(0.1, 0.9, 8).astype(np.float32)
    poisoned = tgt.copy()
    poisoned[3] = np.nan
    eng = ScoringEngine(_tparams(), CFG, path="packed_sparse", device="cpu")
    keep = [i for i in range(8) if i != 3]
    l_clean, g_clean = eng.loss_and_grad([pairs[i] for i in keep], tgt[keep])
    l_pois, g_pois = eng.loss_and_grad(pairs, poisoned)
    assert eng.counters["nonfinite_targets"] == 1
    assert abs(float(l_clean) - float(l_pois)) <= 1e-6
    for a, b in zip(tree_leaves(g_clean), tree_leaves(g_pois)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_train_step_records_train_step_trace():
    batch = _batches(n=1)[0]
    eng = ScoringEngine(_tparams(), CFG, device="cpu")
    step = build_simgnn_train_step(eng)
    params = _tparams()
    step(params, topt.adamw_init(params), {"pairs": batch["pairs"],
                                           "target": batch["target"]})
    recs = [(r.kind, r.path) for r in eng.recorder.records()]
    assert recs == [("train", f"train:{eng.last_plan.path}"),
                    ("train", "train_step")]
    last = eng.recorder.records()[-1]
    assert last.n_pairs == len(batch["pairs"]) and last.wall_s > 0


def test_apply_matches_jax_apply():
    from repro.train.step import build_simgnn_apply as jax_apply

    rng = np.random.default_rng(13)
    g = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 0.01).astype(
        np.float32), _jparams())
    tp = _tparams()
    tp2, ts2, tm = build_simgnn_apply()(tp, topt.adamw_init(tp),
                                        torch.tensor(0.5),
                                        params_from_numpy(g))
    jp2, js2, jm = jax_apply()(_jparams(), jopt.adamw_init(_jparams()),
                               jnp.asarray(0.5),
                               jax.tree.map(jnp.asarray, g))
    _close(tp2, jp2, OPT_ATOL)
    norm64 = np.sqrt(sum(float(np.sum(np.square(x.astype(np.float64))))
                         for x in jax.tree.leaves(g)))
    assert abs(float(tm["grad_norm"]) - norm64) <= OPT_ATOL * norm64
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        OPT_ATOL * norm64
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-9


def test_train_step_names_no_path():
    """train/step.py names no scoring path, packing or kernel: path choice
    lives only in the engine."""
    import ast
    import inspect

    import repro_torch.train.step as ts

    tree = ast.parse(inspect.getsource(ts))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.Module)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant):
            node.body = node.body[1:]
    src = ast.unparse(tree)
    for needle in ("pack_pairs", "bucket_pairs", "packed_sparse",
                   "packed_dense", "oversize", "kernels"):
        assert needle not in src, needle
