"""The port's device-sharded SimGNN serving (DESIGN.md §16) against the JAX
package's, on the CPU.

The JAX package runs its tile mesh on simulated host devices, which XLA
fixes when its backend starts, so one module fixture runs the JAX side
once in a subprocess under
`XLA_FLAGS=--xla_force_host_platform_device_count=8` (this file run as a
script) and records scores, plans, `last_pack_stats`, fault ladders,
two-stage search results, counters and trace records in a temporary npz
and json. The port runs the same calls on 8 logical CPU devices
(`distributed.sharding.force_logical_device_count`), where each shard runs
the kernel wrappers' plain versions. It must give scores bitwise equal to
its own one-device scores and within the parity bound (1e-6) of the JAX
engine's, and plans, pack stats, rung names, counters, breakers, trace
records and search results equal to the JAX package's (search scores
within the head's 1e-6). The pure-Python parts (the tile plan, the spans,
the measured planner's keys) are held against the JAX functions in this
process.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core.engine import ScoringEngine as JaxEngine
from repro.core.profile import TraceRecorder as JaxRecorder
from repro.core.simgnn import SimGNNConfig as JaxConfig
from repro.core.simgnn import init_simgnn_params
from repro.kernels import ops as jops
from repro.serve.search import SimilaritySearchServer as JaxServer
from repro_torch.core import engine as engine_mod
from repro_torch.core.batching import pack_pairs
from repro_torch.core.engine import ScoringEngine
from repro_torch.core.profile import TraceRecorder, cost_key
from repro_torch.core.simgnn import SimGNNConfig
from repro_torch.data.graphs import random_graph
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.params import params_from_numpy
from repro_torch.serve.batching import simgnn_query_server
from repro_torch.serve.search import SimilaritySearchServer
from repro_torch.testing import faults

ROOT = Path(__file__).resolve().parents[1]
CFG = SimGNNConfig()
JCFG = JaxConfig()
PACKED = ("packed_dense", "packed_sparse")
DEVICE_COUNTS = (1, 2, 8)
#: pair sets: 50 mixed pairs pack 17 tiles (at 8 devices spans of 4
#: tiles: 4, 4, 4, 4, 1 and three of pad tiles only; at 2 devices 16 and
#: 1); 12 pairs plan 2 devices; 3 pairs plan 1.
SETS = {"mixed": (0, 50), "twelve": (1, 12), "three": (2, 3)}
MODES = ("raise", "oom", "nan")
SEARCH_DEVICES = (2, 8)
PROXIES = ("linear", "ntn_exact")
ATOL = 1e-6
JAX_TIMEOUT_S = 900


def _pairs(name):
    seed, n = SETS[name]
    rng = np.random.default_rng(seed)
    return [(random_graph(rng, int(rng.integers(5, 33)), avg_degree=4),
             random_graph(rng, int(rng.integers(5, 33)), avg_degree=4))
            for _ in range(n)]


def _search_inputs():
    rng = np.random.default_rng(7)
    corpus = [random_graph(rng, int(rng.integers(6, 24)), avg_degree=4)
              for _ in range(64)]
    queries = [random_graph(rng, int(rng.integers(6, 24)), avg_degree=4)
               for _ in range(4)]
    return corpus, queries


def _plan_record(plan) -> dict:
    return {"path": plan.path, "fallback": plan.fallback,
            "reason": plan.reason, "devices": int(plan.devices),
            "fit_idx": [int(i) for i in plan.fit_idx],
            "over_idx": [int(i) for i in plan.over_idx],
            "degraded_from": list(plan.degraded_from),
            "attempts": int(plan.attempts),
            "prefilter_m": int(plan.prefilter_m)}


def _jsonable(x):
    """Pack stats and counters as plain JSON values (numpy scalars and
    tuples as Python numbers and lists)."""
    return json.loads(json.dumps(x, default=lambda v: v.item()
                                 if hasattr(v, "item") else list(v)))


def _trace_rows(records) -> list:
    return [[r.kind, r.path, int(r.n_pairs), int(r.n_devices),
             list(r.degraded_from), int(r.attempts),
             cost_key(r.path, r.n_devices)] for r in records]


class _Run:
    """One package's side of the matrix: builds engines and servers with a
    runtime of `nd` devices and records what both sides compare. The
    same code drives the JAX package (in the subprocess) and the port."""

    def __init__(self, jax_side: bool, params, runtime):
        self.jax_side = jax_side
        self.params = params
        self.runtime = runtime
        self.arrays: dict = {}
        self.record: dict = {}

    def engine(self, path, nd, **kw):
        if self.jax_side:
            return JaxEngine(self.params, JCFG, path=path,
                             runtime=self.runtime(nd), **kw)
        return ScoringEngine(self.params, CFG, path=path, device="cpu",
                             runtime=self.runtime(nd), **kw)

    def server(self, nd):
        if self.jax_side:
            return JaxServer(self.params, JCFG, shard_rows=8,
                             runtime=self.runtime(nd))
        return SimilaritySearchServer(self.params, CFG, shard_rows=8,
                                      runtime=self.runtime(nd), device="cpu")

    def scores(self, path, nd, name):
        rec = JaxRecorder(capacity=64) if self.jax_side else TraceRecorder(
            capacity=64)
        eng = self.engine(path, nd, recorder=rec)
        pairs = _pairs(name)
        key = f"{path}/{nd}/{name}"
        self.arrays[key] = np.asarray(eng.score(pairs))
        self.record[key] = {"plan": _plan_record(eng.last_plan),
                            "pack_stats": _jsonable(eng.last_pack_stats),
                            "trace": _trace_rows(rec.records())}

    def fault(self, path, mode, inject):
        rec = JaxRecorder(capacity=64) if self.jax_side else TraceRecorder(
            capacity=64)
        eng = self.engine(path, 2, recorder=rec)
        pairs = _pairs("mixed")
        key = f"fault/{path}/{mode}"
        with inject(f"sharded:{path}", mode, times=1):
            self.arrays[key] = np.asarray(eng.score(pairs))
        faulted = _plan_record(eng.last_plan)
        self.arrays[key + "/after"] = np.asarray(eng.score(pairs))
        h = eng.health()
        self.record[key] = {"plan": faulted,
                            "after": _plan_record(eng.last_plan),
                            "pack_stats": _jsonable(eng.last_pack_stats),
                            "counters": _jsonable(h["counters"]),
                            "breakers": _jsonable(h["breakers"]),
                            "trace": _trace_rows(rec.records())}

    def search(self, nd, inject):
        corpus, queries = _search_inputs()
        srv = self.server(nd)
        srv.index(corpus)
        calib = srv._calibration()
        for proxy in PROXIES:
            srv._calib = dict(calib, proxy=proxy)
            got = srv.search(queries, k=10, mode="two_stage",
                             prefilter_m=16)
            key = f"search/{nd}/{proxy}"
            for q, (idx, sc) in enumerate(got):
                self.arrays[f"{key}/{q}/idx"] = np.asarray(idx)
                self.arrays[f"{key}/{q}/scores"] = np.asarray(sc)
            self.record[key] = {
                "plan": _plan_record(srv.engine.last_plan),
                "counters": _jsonable(dict(srv.engine.counters)),
                "spans": srv.health()["prefilter"]["spans"]}
        with inject("prefilter", "raise", times=1):
            got = srv.search(queries, k=10, mode="two_stage",
                             prefilter_m=16)
        for q, (idx, sc) in enumerate(got):
            self.arrays[f"search/{nd}/dead/{q}/idx"] = np.asarray(idx)
        self.record[f"search/{nd}/dead"] = {
            "degraded": int(srv.stats.prefilter_degraded),
            "counters": _jsonable(dict(srv.engine.counters))}

    def run(self, inject):
        for path in PACKED:
            for nd in DEVICE_COUNTS:
                self.scores(path, nd, "mixed")
            for mode in MODES:
                self.fault(path, mode, inject)
        for name in ("twelve", "three"):
            self.scores("packed_sparse", 8, name)
        for nd in SEARCH_DEVICES:
            self.search(nd, inject)


def _jax_params():
    return init_simgnn_params(jax.random.PRNGKey(0), JCFG)


def _jax_main(out_dir: str) -> None:
    """The JAX side, under 8 simulated host devices."""
    from repro.distributed.sharding import tile_runtime
    from repro.testing import faults as jfaults

    assert jax.local_device_count() == 8, jax.local_device_count()
    run = _Run(True, _jax_params(), tile_runtime)
    run.run(jfaults.inject)
    np.savez(os.path.join(out_dir, "jax.npz"), **run.arrays)
    with open(os.path.join(out_dir, "jax.json"), "w") as f:
        json.dump(run.record, f)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_sharded")
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


@pytest.fixture
def cpu_devices():
    """8 logical CPU devices for the test, disarmed after it."""
    sharding.force_logical_device_count(8, "cpu")
    try:
        yield
    finally:
        sharding.disarm_logical_devices()


@pytest.fixture(scope="module")
def port_side():
    sharding.force_logical_device_count(8, "cpu")
    try:
        run = _Run(False, params_from_numpy(
            jax.tree.map(np.asarray, _jax_params()), "cpu"),
            lambda nd: sharding.tile_runtime(nd, "cpu"))
        run.run(faults.inject)
    finally:
        sharding.disarm_logical_devices()
    return run.arrays, run.record


# ------------------------------------------------- against the JAX side

@pytest.mark.parametrize("nd", DEVICE_COUNTS)
@pytest.mark.parametrize("path", PACKED)
def test_sharded_scores_plans_and_stats_match_jax(jax_side, port_side,
                                                  path, nd):
    (ja, jr), (ta, tr) = jax_side, port_side
    key = f"{path}/{nd}/mixed"
    one = ta[f"{path}/1/mixed"]
    assert ta[key].tobytes() == one.tobytes()
    assert float(np.abs(ta[key] - ja[key]).max()) <= ATOL
    assert tr[key]["plan"] == jr[key]["plan"]
    assert tr[key]["plan"]["devices"] == nd
    assert tr[key]["pack_stats"] == jr[key]["pack_stats"]
    assert tr[key]["trace"] == jr[key]["trace"]


@pytest.mark.parametrize("name,devices", (("twelve", 2), ("three", 1)))
def test_small_calls_plan_fewer_devices_like_jax(jax_side, port_side, name,
                                                 devices):
    (ja, jr), (ta, tr) = jax_side, port_side
    key = f"packed_sparse/8/{name}"
    assert tr[key]["plan"] == jr[key]["plan"]
    assert tr[key]["plan"]["devices"] == devices
    assert tr[key]["pack_stats"] == jr[key]["pack_stats"]
    assert tr[key]["trace"] == jr[key]["trace"]
    assert float(np.abs(ta[key] - ja[key]).max()) <= ATOL


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("path", PACKED)
def test_dead_shard_collapses_like_jax(jax_side, port_side, path, mode):
    """A fault at `sharded:<path>` serves the call on one device, bitwise
    equal to the port's unsharded scores, with the JAX engine's rung
    names, counters, breakers and trace records; the next call is
    sharded again."""
    (ja, jr), (ta, tr) = jax_side, port_side
    key = f"fault/{path}/{mode}"
    one = ta[f"{path}/1/mixed"]
    assert ta[key].tobytes() == one.tobytes()
    assert ta[key + "/after"].tobytes() == one.tobytes()
    assert float(np.abs(ta[key] - ja[key]).max()) <= ATOL
    for field in ("plan", "after", "pack_stats", "counters", "breakers",
                  "trace"):
        assert tr[key][field] == jr[key][field], field
    assert tr[key]["plan"]["degraded_from"] == [f"{path}@2d"]
    assert tr[key]["counters"] == {f"errors:{path}@2d": 1}
    assert tr[key]["after"]["degraded_from"] == []


@pytest.mark.parametrize("proxy", PROXIES)
@pytest.mark.parametrize("nd", SEARCH_DEVICES)
def test_span_search_matches_jax(jax_side, port_side, nd, proxy):
    """Per-span prefilter scans merged on the host: the JAX package's
    indices, scores within the head's bound, plan, counters and span
    count; and the port's results bitwise equal to its one-span server."""
    (ja, jr), (ta, tr) = jax_side, port_side
    key = f"search/{nd}/{proxy}"
    for q in range(4):
        np.testing.assert_array_equal(ta[f"{key}/{q}/idx"],
                                      ja[f"{key}/{q}/idx"])
        np.testing.assert_allclose(ta[f"{key}/{q}/scores"],
                                   ja[f"{key}/{q}/scores"], rtol=0,
                                   atol=ATOL)
    assert tr[key] == jr[key]
    assert tr[key]["spans"] == nd == tr[key]["plan"]["devices"]
    corpus, queries = _search_inputs()
    one = SimilaritySearchServer(port_params(), CFG, shard_rows=8,
                                 device="cpu")
    one.index(corpus)
    one._calib = dict(one._calibration(), proxy=proxy)
    for q, (idx, sc) in enumerate(one.search(queries, k=10,
                                             mode="two_stage",
                                             prefilter_m=16)):
        assert idx.tobytes() == ta[f"{key}/{q}/idx"].tobytes()
        assert sc.tobytes() == ta[f"{key}/{q}/scores"].tobytes()


@pytest.mark.parametrize("nd", SEARCH_DEVICES)
def test_dead_span_degrades_to_exact_like_jax(jax_side, port_side, nd):
    (ja, jr), (ta, tr) = jax_side, port_side
    key = f"search/{nd}/dead"
    assert tr[key] == jr[key]
    assert tr[key]["degraded"] == 4
    for q in range(4):
        np.testing.assert_array_equal(ta[f"{key}/{q}/idx"],
                                      ja[f"{key}/{q}/idx"])


# ------------------------------------------------------ in this process

def port_params():
    return params_from_numpy(jax.tree.map(np.asarray, _jax_params()), "cpu")


@pytest.mark.parametrize("sparse", (False, True))
@pytest.mark.parametrize("n", (1, 2, 3, 5, 8))
@pytest.mark.parametrize("node_budget", (16, 64, 72, 128, 2048, 4096))
def test_tile_plan_equals_jax(node_budget, n, sparse):
    for t in (1, 2, 3, 7, 16, 17, 20, 51, 64, 105, 106, 128, 1000):
        assert ops.sharded_tile_plan(t, node_budget, n, sparse=sparse) == \
            jops.sharded_tile_plan(t, node_budget, n, sparse=sparse)
        tb = ops.sharded_tile_block(node_budget, sparse=sparse)
        assert tb == jops.sharded_tile_block(node_budget, sparse=sparse)
        assert ops.sharded_tile_target(t, tb, n) == \
            jops.sharded_tile_target(t, tb, n)
    assert ops.packed_tile_block(node_budget) == \
        jops.packed_tile_block(node_budget)
    assert ops.sparse_tile_block(node_budget) == \
        jops.sparse_tile_block(node_budget)


@pytest.mark.parametrize("n", (1, 2, 4, 8))
def test_shard_spans_cover_the_live_tiles_in_order(n):
    for t in (1, 5, 17, 64, 106):
        target, _ = ops.sharded_tile_plan(t, 64, n, sparse=True)
        spans = ops.shard_spans(t, target, n)
        assert len(spans) == n and spans[0][0] == 0 and spans[-1][1] == t
        for (lo, hi), (lo2, _) in zip(spans, spans[1:]):
            assert lo <= hi == lo2
        span = target // n
        assert [hi - lo for lo, hi in spans] == [
            max(0, min(t - d * span, span)) for d in range(n)]


def test_the_served_aids_request_shards_as_planned():
    """A 106-tile request (a 256-pair AIDS request) splits 64 + 42 on 2
    devices and 32 + 32 + 32 + 10 on 4."""
    for n, want in ((2, [64, 42]), (4, [32, 32, 32, 10])):
        target, _ = ops.sharded_tile_plan(106, 64, n, sparse=True)
        assert [hi - lo for lo, hi in ops.shard_spans(106, target, n)] \
            == want


@pytest.mark.parametrize("nd", (1, 2, 3, 4, 8))
def test_prefilter_spans_equal_jax(nd):
    js = JaxServer(_jax_params(), JCFG, shard_rows=8)
    ts = SimilaritySearchServer(port_params(), CFG, shard_rows=8,
                                device="cpu")
    js.engine.n_devices = ts.engine.n_devices = nd
    for n in (1, 7, 8, 9, 10, 64, 70, 255, 256, 1000, 8192):
        for block in (8, 256):
            spans = ts._prefilter_spans(n, block)
            assert spans == js._prefilter_spans(n, block)
            assert spans[0][0] == 0 and spans[-1][1] == n
            assert all(lo % block == 0 for lo, _ in spans)


@pytest.mark.parametrize("nd", (2, 8))
@pytest.mark.parametrize("sparse", (False, True))
def test_standalone_sharded_wrappers_bitwise(cpu_devices, sparse, nd):
    pairs = _pairs("mixed")
    packed, _ = pack_pairs(pairs, 64, slots_per_tile=16, with_edges=True,
                           device="cpu")
    params = port_params()
    mesh = sharding.tile_mesh(nd, "cpu")
    if sparse:
        want = ops.pair_score_sparse(params, packed, device="cpu")
        got = ops.pair_score_sparse_sharded(params, packed, mesh=mesh)
    else:
        want = ops.pair_score_packed(params, packed, device="cpu")
        got = ops.pair_score_packed_sharded(params, packed, mesh=mesh)
    assert got.shape == want.shape and torch_equal(got, want)


def torch_equal(a, b) -> bool:
    return a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("nd", (2, 8))
def test_pad_only_spans_launch_nothing(cpu_devices, nd, monkeypatch):
    """Each non-empty span calls its kernel wrapper once; spans of pad
    tiles only call nothing."""
    calls = []
    real = ops.sparse_pair_score

    def counting(*args):
        calls.append(args[0].shape[0])
        return real(*args)

    monkeypatch.setattr(ops, "sparse_pair_score", counting)
    packed, _ = pack_pairs(_pairs("mixed"), 64, slots_per_tile=16,
                           with_edges=True, device="cpu")
    t = packed.mask1.shape[0]
    ops.pair_score_sparse_sharded(port_params(), packed,
                                  mesh=sharding.tile_mesh(nd, "cpu"))
    target, _ = ops.sharded_tile_plan(t, 64, nd, sparse=True)
    spans = ops.shard_spans(t, target, nd)
    assert calls == [hi - lo for lo, hi in spans if hi > lo]
    assert sum(calls) == t
    # 17 tiles: at 2 devices spans of 16 and 1, at 8 three spans of pad
    # tiles only
    assert [hi - lo for lo, hi in spans] == (
        [16, 1] if nd == 2 else [4, 4, 4, 4, 1, 0, 0, 0])


@pytest.mark.parametrize("proxy", PROXIES)
@pytest.mark.parametrize("nd", (2, 4, 8))
def test_span_merge_keeps_the_one_span_tie_order(cpu_devices, nd, proxy):
    """A corpus of 9 graphs repeated in a cycle: equal scores straddle
    every span boundary and the top-M cut (M 16 > the 8-row spans at 8
    devices). The merged shortlist and the two-stage results equal the
    one-span scan's, earliest index first among ties."""
    rng = np.random.default_rng(21)
    graphs = [random_graph(rng, int(rng.integers(6, 30))) for _ in range(9)]
    corpus = [dict(graphs[i % 9]) for i in range(60)]
    queries = corpus[:3] + [random_graph(rng, 12) for _ in range(3)]
    servers = []
    for runtime in (None, sharding.tile_runtime(nd, "cpu")):
        srv = SimilaritySearchServer(port_params(), CFG, shard_rows=8,
                                     runtime=runtime, device="cpu")
        srv.index(corpus)
        srv._calib = dict(srv._calibration(), proxy=proxy)
        servers.append(srv)
    one, many = servers
    spans = many._prefilter_spans(60, 8)
    assert len(spans) == min(nd, 8)
    got = many.search(queries, k=10, mode="two_stage", prefilter_m=16)
    want = one.search(queries, k=10, mode="two_stage", prefilter_m=16)
    for (gi, gs), (wi, ws) in zip(got, want):
        assert gi.tobytes() == wi.tobytes() and gs.tobytes() == ws.tobytes()
    assert many.engine.counters["prefilter_span_scans"] == len(spans)
    hq = one.engine.embed_graphs(queries)
    qv = hq if proxy == "ntn_exact" else None
    ntn_ops = None
    if proxy == "linear":
        from repro_torch.kernels.retrieval import prefilter_query_vectors
        qv = prefilter_query_vectors(one.engine.params["ntn"]["w"], hq,
                                     one._calib)
    else:
        from repro_torch.kernels.retrieval import collapse_query_ntn
        ntn_ops = collapse_query_ntn(one.engine.params["ntn"], hq)
    ws, wi = one._span_topm(qv, ntn_ops, 16, 8, [(0, 60)])
    gs, gi = many._span_topm(qv, ntn_ops, 16, 8, spans)
    assert gi.tobytes() == wi.tobytes() and gs.tobytes() == ws.tobytes()
    # the cut falls inside a group of equal scores
    assert any(np.sum(row == row[-1]) > 1 for row in ws)


def test_tile_mesh_raises_beyond_the_devices_unless_armed():
    sharding.disarm_logical_devices()
    assert sharding.tile_mesh(1, "cpu").size == 1
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        sharding.tile_mesh(2, "cpu")
    with pytest.raises(ValueError):
        sharding.tile_runtime(8, "cpu")
    assert sharding.force_logical_device_count(4, "cpu") == 4
    try:
        mesh = sharding.tile_mesh(None, "cpu")
        assert mesh.size == 4 and mesh.logical
        assert mesh.streams == (None,) * 4
        assert sharding.TILE_AXIS == "tile"
        with pytest.raises(ValueError, match="requested 5 devices, have 4"):
            sharding.tile_mesh(5, "cpu")
    finally:
        sharding.disarm_logical_devices()
    with pytest.raises(ValueError):
        sharding.tile_mesh(4, "cpu")
    assert sharding.Runtime().n_devices == 1


def test_engine_rejects_a_mesh_of_another_kind(cpu_devices):
    class Mesh:
        kind, size = "cuda", 2

    with pytest.raises(ValueError, match="mesh on cuda"):
        ScoringEngine(port_params(), CFG, device="cpu",
                      runtime=sharding.Runtime(mesh=Mesh()))


@pytest.mark.parametrize("devices", (2, 8))
@pytest.mark.parametrize("start", PACKED)
def test_collapse_rung_then_the_ladder(start, devices):
    """A sharded start is followed by its one-device twin, then the JAX
    ladder (on the card without the reference rung)."""
    from repro.core.engine import DEGRADE_LADDER as JAX_LADDER

    name = f"{start}@{devices}d"
    assert engine_mod.degrade_rungs(start, on_card=False,
                                    devices=devices) == \
        (name, start) + JAX_LADDER[start]
    assert engine_mod.degrade_rungs(start, on_card=True,
                                    devices=devices) == \
        (name, start) + tuple(r for r in JAX_LADDER[start]
                              if r != "reference")
    assert engine_mod.degrade_rungs(start, on_card=True, devices=devices,
                                    degrade=False) == (name,)
    assert engine_mod._rung_of(name) == (start, devices)
    assert engine_mod._rung_of(start) == (start, 1)


def test_measured_planner_keys_carry_the_device_count(cpu_devices):
    """With a profile of `packed_sparse@8d`, `packed_dense@8d` and
    `bucketed_mega` walls, both engines on 8 devices pick and estimate the
    same; without the `@8d` walls (single-device ones only) neither model
    steers."""
    pairs = _pairs("mixed")

    def fill(rec, sharded: bool):
        for i in range(8):
            for path, wall in (("bucketed_mega", 0.004),
                               ("packed_dense", 0.002),
                               ("packed_sparse", 0.003)):
                nd = 8 if sharded and path != "bucketed_mega" else 1
                rec.record(kind="score", path=path, n_pairs=16 * (i + 1),
                           max_nodes=32, mean_nodes=18.0 + i,
                           avg_degree=3.0, density=0.1, occupancy=0.5,
                           to_embed=0, degraded_from=[], attempts=1,
                           wall_s=wall * (1 + i / 8), n_devices=nd)
        return rec

    for sharded in (True, False):
        jeng = JaxEngine(_jax_params(), JCFG,
                         recorder=fill(JaxRecorder(), sharded),
                         runtime=types.SimpleNamespace(n_devices=8))
        teng = ScoringEngine(port_params(), CFG, device="cpu",
                             recorder=fill(TraceRecorder(), sharded),
                             runtime=sharding.tile_runtime(8, "cpu"))
        jp, tp = jeng.plan(pairs), teng.plan(pairs)
        assert (tp.path, tp.reason, tp.devices) == (jp.path, jp.reason,
                                                    jp.devices)
        assert tp.cost_estimates == jp.cost_estimates
        assert bool(tp.cost_estimates) == sharded


def test_query_server_forwards_the_runtime(cpu_devices):
    pairs = _pairs("mixed")
    rt = sharding.tile_runtime(8, "cpu")
    score = simgnn_query_server(port_params(), CFG, use_kernels=True,
                                planner="threshold", runtime=rt,
                                device="cpu")
    plain = simgnn_query_server(port_params(), CFG, use_kernels=True,
                                planner="threshold", device="cpu")
    got, want = score(pairs), plain(pairs)
    assert score.engine.runtime is rt and score.last_plan.devices == 8
    assert score.last_pack_stats["devices"] == 8
    assert got.tobytes() == want.tobytes()


if __name__ == "__main__":
    _jax_main(sys.argv[1])
