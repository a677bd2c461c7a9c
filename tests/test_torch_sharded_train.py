"""The port's device-sharded SimGNN training (DESIGN.md §16) against the JAX
package's, on the CPU.

The JAX package runs its tile mesh on simulated host devices, which XLA
fixes when its backend starts, so one module fixture runs the JAX side
once in a subprocess under
`XLA_FLAGS=--xla_force_host_platform_device_count=8` (this file run as a
script) and records losses, gradients, plans, `last_pack_stats`, trace
records, fault ladders and the scores of a sharded engine whose params
are replaced, in a temporary npz and json. The port runs the same calls
on 8 logical CPU devices (`distributed.sharding.force_logical_device_count`).

Bounds: loss and every gradient leaf within 1e-6 of the JAX engine's at
the same device count and of the port's own one-device call (the
cross-device sum re-associates the chunk sums), two identical calls
bit-equal, a collapsed call bit-equal to the one-device call; plans, pack
stats, rung names, counters, breakers and trace records equal to the JAX
package's. The pure-Python parts (the train ladder, the measured
planner's train keys, the span executor) are held against the JAX
functions in this process, and the launcher's `--devices N` runs here on
logical CPU devices.
"""

import functools
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.engine import ScoringEngine as JaxEngine
from repro.core.engine import TRAIN_DEGRADE_LADDER as JAX_TRAIN_LADDER
from repro.core.profile import TraceRecorder as JaxRecorder
from repro.core.simgnn import SimGNNConfig as JaxConfig
from repro.core.simgnn import init_simgnn_params
from repro.train import sgf as jsgf
from repro_torch.core import engine as engine_mod
from repro_torch.core.engine import ScoringEngine
from repro_torch.core.profile import TraceRecorder, cost_key
from repro_torch.core.simgnn import SimGNNConfig
from repro_torch.data.graphs import random_graph
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.launch.train import main
from repro_torch.params import params_from_numpy, tree_leaves
from repro_torch.testing import faults
from repro_torch.train import sgf as tsgf

ROOT = Path(__file__).resolve().parents[1]
CFG = SimGNNConfig()
JCFG = JaxConfig()
PACKED = ("packed_dense", "packed_sparse")
DEVICE_COUNTS = (1, 2, 8)
ACCUM = (1, 4)
#: pair sets (seed, pairs): tests/test_sharded.py's 48 mixed pairs pack 16
#: tiles; the 46 ragged pairs pack 17, so that at 8 devices and accum 4
#: (4-tile chunks, 32 tiles padded) a span holds 1 live tile and 3 pad
#: tiles and three spans hold pad tiles only.
SETS = {"mixed": (0, 48), "ragged": (5, 46)}
MODES = ("raise", "oom", "nan")
STALE_DEVICES = (2, 8)
CLIP = 0.05
ATOL = 1e-6
JAX_TIMEOUT_S = 600


def _pairs(name):
    seed, n = SETS[name]
    rng = np.random.default_rng(seed)
    pairs = [(random_graph(rng, int(rng.integers(5, 33)), avg_degree=4),
              random_graph(rng, int(rng.integers(5, 33)), avg_degree=4))
             for _ in range(n)]
    return pairs, np.linspace(0.0, 1.0, n).astype(np.float32)


def _plan_record(plan) -> dict:
    return {"path": plan.path, "fallback": plan.fallback,
            "reason": plan.reason, "devices": int(plan.devices),
            "fit_idx": [int(i) for i in plan.fit_idx],
            "over_idx": [int(i) for i in plan.over_idx],
            "degraded_from": list(plan.degraded_from),
            "attempts": int(plan.attempts)}


def _jsonable(x):
    """Pack stats and counters as plain JSON values."""
    return json.loads(json.dumps(x, default=lambda v: v.item()
                                 if hasattr(v, "item") else list(v)))


def _trace_rows(records) -> list:
    return [[r.kind, r.path, int(r.n_pairs), int(r.n_devices),
             list(r.degraded_from), int(r.attempts),
             cost_key(r.path, r.n_devices)] for r in records]


class _Run:
    """One package's side of the matrix, the same code for the JAX package
    (in the subprocess) and the port: engines with a runtime of `nd`
    devices, and the numbers both sides compare."""

    def __init__(self, jax_side: bool, params, params1, runtime):
        self.jax_side = jax_side
        self.params = params
        self.params1 = params1
        self.runtime = runtime
        self.arrays: dict = {}
        self.record: dict = {}

    def engine(self, path, nd, **kw):
        rt = self.runtime(nd)
        if self.jax_side:
            return JaxEngine(self.params, JCFG, path=path, runtime=rt, **kw)
        return ScoringEngine(self.params, CFG, path=path, device="cpu",
                             runtime=rt, **kw)

    def recorder(self):
        return JaxRecorder(capacity=64) if self.jax_side else TraceRecorder(
            capacity=64)

    def keep(self, key, loss, grads):
        self.arrays[f"{key}/loss"] = np.asarray(loss)
        leaves = jax.tree.leaves(grads) if self.jax_side else \
            tree_leaves(grads)
        for i, g in enumerate(leaves):
            self.arrays[f"{key}/g{i}"] = np.asarray(g)

    def train(self, path, nd, accum, name="mixed", clip=False):
        rec = self.recorder()
        kw = {}
        if clip:
            kw["grad_fn"] = (jsgf.ClippedGradient(CLIP) if self.jax_side
                             else tsgf.ClippedGradient(CLIP))
        eng = self.engine(path, nd, recorder=rec, **kw)
        pairs, target = _pairs(name)
        key = f"{'clip/' if clip else ''}{path}/{nd}/{accum}/{name}"
        self.keep(key, *eng.loss_and_grad(pairs, target, accum_steps=accum))
        self.record[key] = {"plan": _plan_record(eng.last_plan),
                            "pack_stats": _jsonable(eng.last_pack_stats),
                            "trace": _trace_rows(rec.records())}
        if not self.jax_side:
            self.keep(key + "/again",
                      *eng.loss_and_grad(pairs, target, accum_steps=accum))

    def fault(self, path, mode, inject):
        rec = self.recorder()
        eng = self.engine(path, 2, recorder=rec)
        pairs, target = _pairs("mixed")
        key = f"fault/{path}/{mode}"
        with inject(f"sharded:train:{path}", mode, times=1):
            self.keep(key, *eng.loss_and_grad(pairs, target))
        faulted = _plan_record(eng.last_plan)
        self.keep(key + "/after", *eng.loss_and_grad(pairs, target))
        h = eng.health()
        self.record[key] = {"plan": faulted,
                            "after": _plan_record(eng.last_plan),
                            "pack_stats": _jsonable(eng.last_pack_stats),
                            "counters": _jsonable(h["counters"]),
                            "breakers": _jsonable(h["breakers"]),
                            "trace": _trace_rows(rec.records())}

    def stale(self, nd):
        """Score, replace the engine's params, score again."""
        eng = self.engine("packed_sparse", nd)
        pairs, _ = _pairs("mixed")
        self.arrays[f"stale/{nd}/before"] = np.asarray(eng.score(pairs))
        eng.params = self.params1
        self.arrays[f"stale/{nd}/after"] = np.asarray(eng.score(pairs))
        self.record[f"stale/{nd}"] = _plan_record(eng.last_plan)

    def run(self, inject):
        for path in PACKED:
            for nd in DEVICE_COUNTS:
                for accum in ACCUM:
                    self.train(path, nd, accum)
            self.train(path, 8, 4, "ragged")
            for mode in MODES:
                self.fault(path, mode, inject)
        self.train("packed_sparse", 2, 4, clip=True)
        for nd in STALE_DEVICES:
            self.stale(nd)


@functools.lru_cache(maxsize=None)
def _jax_params(seed=0):
    return init_simgnn_params(jax.random.PRNGKey(seed), JCFG)


def port_params(seed=0):
    return params_from_numpy(jax.tree.map(np.asarray, _jax_params(seed)),
                             "cpu")


def _jax_main(out_dir: str) -> None:
    """The JAX side, under 8 simulated host devices."""
    from repro.distributed.sharding import tile_runtime
    from repro.testing import faults as jfaults

    assert jax.local_device_count() == 8, jax.local_device_count()
    run = _Run(True, _jax_params(), _jax_params(1), tile_runtime)
    run.run(jfaults.inject)
    np.savez(os.path.join(out_dir, "jax.npz"), **run.arrays)
    with open(os.path.join(out_dir, "jax.json"), "w") as f:
        json.dump(run.record, f)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_sharded_train")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True,
                          timeout=JAX_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "jax.npz") as z:
        arrays = dict(z)
    return arrays, json.loads((out / "jax.json").read_text())


@pytest.fixture(scope="module")
def port_side():
    with sharding.logical_devices(8, "cpu"):
        run = _Run(False, port_params(), port_params(1),
                   lambda nd: sharding.tile_runtime(nd, "cpu"))
        run.run(faults.inject)
    return run.arrays, run.record


@pytest.fixture
def cpu_devices():
    """8 logical CPU devices for the test, disarmed after it."""
    with sharding.logical_devices(8, "cpu"):
        yield


def _parts() -> tuple:
    """The loss and each gradient leaf of a kept result, by key suffix."""
    n = len(tree_leaves(port_params()))
    return ("/loss",) + tuple(f"/g{i}" for i in range(n))


def _err(a: dict, b: dict, key_a: str, key_b: str) -> float:
    """Largest |a - b| over the loss and every gradient leaf of two kept
    results."""
    return max(float(np.abs(a[key_a + n] - b[key_b + n]).max())
               for n in _parts())


def _bits(a: dict, b: dict, key_a: str, key_b: str) -> bool:
    return all(a[key_a + n].tobytes() == b[key_b + n].tobytes()
               for n in _parts())


def _own(loss, grads) -> dict:
    """A port call's result kept under the key "one"."""
    out = {"one/loss": np.asarray(loss)}
    for i, g in enumerate(tree_leaves(grads)):
        out[f"one/g{i}"] = np.asarray(g)
    return out


# ------------------------------------------------- against the JAX side

@pytest.mark.parametrize("accum", ACCUM)
@pytest.mark.parametrize("nd", DEVICE_COUNTS)
@pytest.mark.parametrize("path", PACKED)
def test_sharded_loss_and_grad_match_jax(jax_side, port_side, path, nd,
                                         accum):
    (ja, jr), (ta, tr) = jax_side, port_side
    key = f"{path}/{nd}/{accum}/mixed"
    assert _err(ta, ja, key, key) <= ATOL
    assert _err(ta, ta, key, f"{path}/1/{accum}/mixed") <= ATOL
    assert _bits(ta, ta, key, key + "/again")
    assert tr[key]["plan"] == jr[key]["plan"]
    assert tr[key]["plan"]["devices"] == nd
    assert tr[key]["plan"]["degraded_from"] == []
    assert tr[key]["pack_stats"] == jr[key]["pack_stats"]
    assert tr[key]["trace"] == jr[key]["trace"]
    rung = path if nd == 1 else f"{path}@{nd}d"
    assert [row[6] for row in tr[key]["trace"]] == [f"train:{rung}"]
    if nd > 1:
        ps = tr[key]["pack_stats"]
        assert ps["devices"] == nd and ps["tiles"] == 16
        assert ps["tiles_padded"] % nd == 0 and ps["tiles_padded"] >= 16


@pytest.mark.parametrize("path", PACKED)
def test_pad_only_and_part_padded_spans_match_jax(jax_side, port_side,
                                                  path):
    """17 tiles at 8 devices in 4-tile chunks: 32 tiles padded, spans of
    4, 4, 4, 4, 1 live tiles and three of pad tiles only."""
    (ja, jr), (ta, tr) = jax_side, port_side
    key = f"{path}/8/4/ragged"
    one = ScoringEngine(port_params(), CFG, path=path, device="cpu")
    pairs, target = _pairs("ragged")
    own = _own(*one.loss_and_grad(pairs, target, accum_steps=4))
    assert _err(ta, ja, key, key) <= ATOL
    assert _err(ta, own, key, "one") <= ATOL
    assert _bits(ta, ta, key, key + "/again")
    assert tr[key]["pack_stats"] == jr[key]["pack_stats"]
    assert tr[key]["plan"] == jr[key]["plan"]
    ps = tr[key]["pack_stats"]
    assert (ps["devices"], ps["tiles"], ps["tiles_padded"]) == (8, 17, 32)


def test_clipped_gradient_clips_each_chunk_before_the_sum(jax_side,
                                                          port_side):
    """`ClippedGradient` on 2 devices in 4-tile chunks: JAX's numbers, and
    the one-device clipped call's (clipping acts per chunk, and the chunks
    are the same), and not the unclipped grads."""
    (ja, jr), (ta, tr) = jax_side, port_side
    key = "clip/packed_sparse/2/4/mixed"
    assert _err(ta, ja, key, key) <= ATOL
    assert _bits(ta, ta, key, key + "/again")
    assert tr[key]["plan"] == jr[key]["plan"]
    one = ScoringEngine(port_params(), CFG, path="packed_sparse",
                        device="cpu", grad_fn=tsgf.ClippedGradient(CLIP))
    pairs, target = _pairs("mixed")
    own = _own(*one.loss_and_grad(pairs, target, accum_steps=4))
    assert _err(ta, own, key, "one") <= ATOL
    assert _err(ta, ta, key, "packed_sparse/2/4/mixed") > 1e-3


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("path", PACKED)
def test_dead_shard_in_training_collapses_like_jax(jax_side, port_side,
                                                   path, mode):
    """A fault at `sharded:train:<path>` serves the call on one device,
    bit-equal to the port's one-device call, with the JAX engine's rung
    names, counters, breakers and trace records; the next call is sharded
    again."""
    (ja, jr), (ta, tr) = jax_side, port_side
    key = f"fault/{path}/{mode}"
    assert _bits(ta, ta, key, f"{path}/1/1/mixed")
    assert _err(ta, ja, key, key) <= ATOL
    assert _err(ta, ta, key + "/after", f"{path}/2/1/mixed") == 0.0
    for field in ("plan", "after", "pack_stats", "counters", "breakers",
                  "trace"):
        assert tr[key][field] == jr[key][field], field
    assert tr[key]["plan"]["degraded_from"] == [f"{path}@2d"]
    assert tr[key]["plan"]["attempts"] == 2
    assert tr[key]["counters"] == {f"errors:train:{path}@2d": 1}
    assert any(k.startswith(f"train:{path}@2d[")
               for k in tr[key]["breakers"])
    assert tr[key]["after"]["degraded_from"] == []
    assert [row[6] for row in tr[key]["trace"]] == [
        f"train:{path}", f"train:{path}@2d"]


@pytest.mark.parametrize("nd", STALE_DEVICES)
def test_replaced_params_are_served_by_a_sharded_engine(jax_side, nd):
    """Score on `nd` devices, replace `engine.params`, score again: both
    calls within 1e-6 of the JAX engine's, the second bit-equal to a
    one-device engine of the new params (the float32 copies a sharded call
    reads are rebuilt from the params it is given)."""
    ja, jr = jax_side
    pairs, _ = _pairs("mixed")
    with sharding.logical_devices(8, "cpu"):
        eng = ScoringEngine(port_params(), CFG, path="packed_sparse",
                            device="cpu",
                            runtime=sharding.tile_runtime(nd, "cpu"))
        before = eng.score(pairs)
        eng.params = port_params(1)
        after = eng.score(pairs)
    assert eng.last_plan.devices == nd
    want = ScoringEngine(port_params(1), CFG, path="packed_sparse",
                         device="cpu").score(pairs)
    assert float(np.abs(before - ja[f"stale/{nd}/before"]).max()) <= ATOL
    assert float(np.abs(after - ja[f"stale/{nd}/after"]).max()) <= ATOL
    assert after.tobytes() == want.tobytes()
    assert float(np.abs(after - before).max()) > 1e-3


# ------------------------------------------------------ in this process

@pytest.mark.parametrize("degrade", (True, False))
@pytest.mark.parametrize("devices", (1, 2, 8))
@pytest.mark.parametrize("start", ("packed_sparse", "packed_dense",
                                   "reference"))
def test_train_rungs_equal_jax(start, devices, degrade):
    """The train ladder: `path@Nd`, its one-device twin, then
    `TRAIN_DEGRADE_LADDER` with the reference kept (no train rung
    launches a kernel), as the JAX engine's `_ladder_rungs`."""
    jeng = JaxEngine(_jax_params(), JCFG, degrade=degrade)
    want = jeng._ladder_rungs(start, devices, JAX_TRAIN_LADDER)
    got = engine_mod.degrade_rungs(start, on_card=False, degrade=degrade,
                                   devices=devices,
                                   ladder=engine_mod.TRAIN_DEGRADE_LADDER)
    assert tuple(engine_mod._rung_of(n) for n in got) == want
    assert engine_mod.TRAIN_DEGRADE_LADDER == JAX_TRAIN_LADDER


def _fill(rec, sharded: bool):
    """Eight train records a path; the packed ones on 8 devices when
    `sharded`."""
    for i in range(8):
        for path, wall in (("reference", 0.004), ("packed_dense", 0.002),
                           ("packed_sparse", 0.003)):
            nd = 8 if sharded and path != "reference" else 1
            rec.record(kind="train", path=f"train:{path}",
                       n_pairs=16 * (i + 1), max_nodes=32,
                       mean_nodes=18.0 + i, avg_degree=3.0, density=0.1,
                       occupancy=0.5, to_embed=0, degraded_from=[],
                       attempts=1, wall_s=wall * (1 + i / 8), n_devices=nd)
    return rec


@pytest.mark.parametrize("sharded", (True, False))
def test_measured_planner_train_keys_carry_the_device_count(cpu_devices,
                                                            sharded):
    """With `train:packed_*@8d` walls both engines on 8 devices pick and
    estimate the same; with single-device walls only neither model
    steers a training call."""
    pairs, _ = _pairs("mixed")
    jeng = JaxEngine(_jax_params(), JCFG, recorder=_fill(JaxRecorder(),
                                                         sharded),
                     runtime=types.SimpleNamespace(n_devices=8))
    teng = ScoringEngine(port_params(), CFG, device="cpu",
                         recorder=_fill(TraceRecorder(), sharded),
                         runtime=sharding.tile_runtime(8, "cpu"))
    jp, tp = jeng.plan(pairs, train=True), teng.plan(pairs, train=True)
    assert (tp.path, tp.reason, tp.devices) == (jp.path, jp.reason,
                                                jp.devices)
    assert tp.cost_estimates == jp.cost_estimates
    assert bool(tp.cost_estimates) == sharded
    assert tp.devices == 8


def _fake_span_fn(seen):
    """A per-device executor that records each span's first target and
    returns loss = sum of targets and grads = loss in every leaf."""
    def fn(params, tgt, *arrays):
        seen.append(float(tgt[0, 0]))
        s = tgt.sum()
        return s, {k: torch.full_like(v, float(s)) for k, v in
                   params.items()}
    return fn


@pytest.mark.parametrize("live,nd", ((16, 2), (16, 8), (17, 8), (32, 4),
                                     (1, 4)))
def test_grad_tiles_sharded_spans_and_sum_order(cpu_devices, live, nd):
    """Device d runs tiles [d·span, (d+1)·span) of the padded axis, a span
    without a pair runs nothing, and the devices' results are summed in
    device order on the first device."""
    t = -(-live // nd) * nd
    span = t // nd
    tgt = torch.zeros((t, 2))
    tgt[:live, 0] = torch.arange(1, live + 1, dtype=torch.float32)
    pair_mask = torch.zeros((t, 2))
    pair_mask[:live, 0] = 1.0
    params = {"w": torch.zeros(3), "b": torch.zeros(())}
    seen = []
    s, g = ops.grad_tiles_sharded(_fake_span_fn(seen), params, tgt,
                                  (pair_mask,), sharding.tile_mesh(nd, "cpu"))
    live_spans = [d for d in range(nd) if d * span < live]
    assert seen == [float(d * span + 1) for d in live_spans]
    want = torch.zeros(())
    for d in live_spans:
        want = want + tgt[d * span:(d + 1) * span].sum()
    assert torch.equal(s, want)
    assert torch.equal(g["w"], torch.full((3,), float(want)))


def test_grad_tiles_sharded_of_pad_tiles_only_is_zero(cpu_devices):
    params = {"w": torch.ones(3)}
    s, g = ops.grad_tiles_sharded(_fake_span_fn([]), params,
                                  torch.zeros((8, 2)), (torch.zeros((8, 2)),),
                                  sharding.tile_mesh(4, "cpu"))
    assert float(s) == 0.0 and torch.equal(g["w"], torch.zeros(3))


def test_train_executors_are_cached_by_device_count(cpu_devices):
    """One executor per (path, chunk tiles, devices, gradient kind): a
    sharded call and its collapse rung keep two."""
    pairs, target = _pairs("mixed")
    eng = ScoringEngine(port_params(), CFG, path="packed_sparse",
                        device="cpu", runtime=sharding.tile_runtime(2, "cpu"))
    eng.loss_and_grad(pairs, target)
    with faults.inject("sharded:train:packed_sparse", "raise", times=1):
        eng.loss_and_grad(pairs, target)
    assert sorted(eng._train_fns) == [("packed_sparse", 16, 1, "standard"),
                                      ("packed_sparse", 16, 2, "standard")]


def test_in_place_param_updates_reach_the_sharded_scores(cpu_devices):
    pairs, _ = _pairs("mixed")
    params = port_params()
    eng = ScoringEngine(params, CFG, path="packed_sparse", device="cpu",
                        runtime=sharding.tile_runtime(2, "cpu"))
    before = eng.score(pairs)
    with torch.no_grad():
        eng.params["ntn"]["b"].add_(0.5)
    after = eng.score(pairs)
    want = ScoringEngine(eng.params, CFG, path="packed_sparse",
                         device="cpu").score(pairs)
    assert after.tobytes() == want.tobytes() != before.tobytes()


def test_logical_devices_block_restores_the_arming():
    sharding.disarm_logical_devices()
    with sharding.logical_devices(4, "cpu"):
        assert sharding.tile_mesh(4, "cpu").logical
        with sharding.logical_devices(2, "cpu"):
            assert sharding.tile_mesh(None, "cpu").size == 2
        assert sharding.tile_mesh(None, "cpu").size == 4
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        sharding.tile_mesh(2, "cpu")


# --------------------------------------------------------- the launcher

def _args(ckpt_dir, steps, devices, *extra):
    return ["--device", "cpu", "--steps", str(steps), "--batch", "16",
            "--ckpt-dir", str(ckpt_dir), "--devices", str(devices), *extra]


def _leaves(run):
    return tree_leaves((run.params, run.opt_state))


def _bit_equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _max_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)))


def test_launcher_devices_2_matches_one_device(tmp_path, capsys):
    one = main(_args(tmp_path / "one", 3, 1))
    capsys.readouterr()
    two = main(_args(tmp_path / "two", 3, 2))
    out = capsys.readouterr().out
    assert "[train] 2 devices: 2 logical devices over cpu" in out
    assert _max_diff(one, two) <= 1e-5
    assert [r["step"] for r in two.history] == [r["step"] for r in
                                                one.history]
    assert not two.counters.get("train_skipped_steps")
    # the logical devices were armed only while the mesh was built
    with pytest.raises(ValueError, match="have 1"):
        sharding.tile_mesh(2, "cpu")


def test_launcher_killed_at_2_devices_resumes_bit_identical(tmp_path):
    """Killed after step 2 (exit 42) and resumed at 2 devices: bit-equal
    to an uninterrupted 2-device run; resumed at 4 devices from the same
    checkpoint: within 1e-5 of it (params stay whole, so a checkpoint
    does not depend on the device count)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         *_args(tmp_path / "killed", 4, 2, "--ckpt-every", "2",
                "--simulate-failure", "2", "--log-every", "1")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 42, proc.stdout + proc.stderr
    assert "[train] 2 devices: 2 logical devices over cpu" in proc.stdout
    assert sorted(os.listdir(tmp_path / "killed")) == ["step_000000002"]
    shutil.copytree(tmp_path / "killed", tmp_path / "killed4")
    resumed = main(_args(tmp_path / "killed", 4, 2, "--ckpt-every", "2"))
    assert resumed.counters["ckpt_resumes"] == 1
    straight = main(_args(tmp_path / "straight", 4, 2, "--ckpt-every", "2"))
    assert _bit_equal(resumed, straight)
    at4 = main(_args(tmp_path / "killed4", 4, 4, "--ckpt-every", "2"))
    assert at4.counters["ckpt_resumes"] == 1
    assert _max_diff(at4, straight) <= 1e-5


if __name__ == "__main__":
    _jax_main(sys.argv[1])
