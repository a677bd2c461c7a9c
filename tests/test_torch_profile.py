"""The port's trace recorder and measured planner (`repro_torch.core.
profile`, `ScoringEngine(planner=...)`) against the JAX package's, on the
CPU.

Pinned: the profile format (v2 and v1 schema digests, the golden v1
profile, byte-equal flushes that each package loads from the other), the
cost-model fit bit for bit (weights, support, residuals), the cold
planner's decision table (path and reason, train rows included) equal to
the JAX engine's and to the port's own threshold rules, partial support
falling back whole, a warm planner picking the JAX engine's path with the
same estimates on the same records, the refit cadence, health's planner
snapshot, and the fault seams: a failing recorder never fails scoring, a
torn profile flush heals on the next one.
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest

from repro.core import profile as jprofile
from repro.core.engine import ScoringEngine as JaxEngine
from repro.core.simgnn import SimGNNConfig as JaxConfig
from repro.core.simgnn import init_simgnn_params
from repro.testing import faults as jfaults
from repro_torch.core import profile as tprofile
from repro_torch.core.engine import TRAIN_PATHS, ScoringEngine, WorkloadStats
from repro_torch.core.simgnn import SimGNNConfig
from repro_torch.data.graphs import random_graph
from repro_torch.params import params_from_numpy
from repro_torch.testing import faults

CFG = SimGNNConfig()
JCFG = JaxConfig()
GOLDEN_PROFILE = os.path.join(os.path.dirname(__file__), "data",
                              "golden_profile.jsonl")
SCORE_PATHS = ("bucketed_mega", "packed_dense", "packed_sparse")


@functools.lru_cache(maxsize=None)
def _jparams():
    return init_simgnn_params(jax.random.PRNGKey(0), JCFG)


def _tparams():
    return params_from_numpy(jax.tree.map(np.asarray, _jparams()), "cpu")


def _engines(**kw):
    return (JaxEngine(_jparams(), JCFG, **kw),
            ScoringEngine(_tparams(), CFG, device="cpu", **kw))


class _FakeClock:
    def __init__(self, step=0.5):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def _pairs(seed, n, max_n=24, avg_degree=2.0):
    rng = np.random.default_rng(seed)
    return [(random_graph(rng, int(rng.integers(5, max_n + 1)),
                          avg_degree=avg_degree),
             random_graph(rng, int(rng.integers(5, max_n + 1)),
                          avg_degree=avg_degree))
            for _ in range(n)]


def _profile_for(paths, *, per_path=10, noise=0.0, seed=0, degree=2.0):
    """Port TraceRecords with planted per-path linear latency:
    wall = base[path] + per_pair[path] * n_pairs (+ optional noise)."""
    rng = np.random.default_rng(seed)
    out = []
    seq = 0
    for i, p in enumerate(paths):
        for j in range(per_path):
            n = 4 + 3 * j
            w = 0.002 * (i + 1) + 0.0005 * (i + 1) * n
            if noise:
                w *= 1.0 + rng.uniform(-noise, noise)
            out.append(tprofile.TraceRecord(
                kind="score", path=p, n_pairs=n, max_nodes=24,
                mean_nodes=16.0 + j, avg_degree=degree + 0.1 * j,
                density=0.1, occupancy=0.0, to_embed=0, degraded_from=(),
                attempts=1, wall_s=w, seq=seq))
            seq += 1
    return out


def _to_jax(records):
    return [jprofile.TraceRecord(**dataclasses.asdict(r)) for r in records]


def _seed(engine, records):
    for r in records:
        engine.recorder._ring.append(r)
        engine.recorder.total_records += 1


# ------------------------------------------------------------ file format


def test_schema_digests_equal_jax():
    assert tprofile.schema_digest() == jprofile.schema_digest()
    assert tprofile.v1_schema_digest() == jprofile.v1_schema_digest()
    assert tprofile.PROFILE_FORMAT_VERSION == jprofile.PROFILE_FORMAT_VERSION
    assert tprofile.TRACE_SCHEMA == jprofile.TRACE_SCHEMA
    assert tprofile.FEATURE_NAMES == jprofile.FEATURE_NAMES


def test_golden_profile_reads_equal_records():
    want, jdrop = jprofile.read_profile(GOLDEN_PROFILE)
    got, tdrop = tprofile.read_profile(GOLDEN_PROFILE)
    assert tdrop == jdrop
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in want]
    assert all(r.n_devices == 1 for r in got)


@pytest.mark.parametrize("writer", ("jax", "torch"))
def test_profile_cross_loads_both_ways(tmp_path, writer):
    """A profile flushed by either package is byte-identical to the
    other's and loads in both, records equal."""
    files = {}
    for pkg, mod in (("jax", jprofile), ("torch", tprofile)):
        path = str(tmp_path / f"{pkg}.jsonl")
        rec = mod.TraceRecorder(path=path)
        for i in range(5):
            rec.record(kind="score", path=SCORE_PATHS[i % 3], n_pairs=3 + i,
                       max_nodes=20 + i, mean_nodes=11.5 + i,
                       avg_degree=2.25 + i / 7, density=0.1 / (i + 1),
                       occupancy=0.5, to_embed=i, degraded_from=["x"] * i,
                       attempts=1 + i, wall_s=1e-3 * (i + 1) / 3)
        assert rec.flush() == 5
        files[pkg] = path
    with open(files["jax"], "rb") as a, open(files["torch"], "rb") as b:
        assert a.read() == b.read()
    path = files[writer]
    want = jprofile.TraceRecorder.load(path).records()
    got = tprofile.TraceRecorder.load(path).records()
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in want]


def test_unknown_header_refused(tmp_path):
    path = str(tmp_path / "p.jsonl")
    with open(path, "w") as f:
        f.write('{"profile_format_version": 99, "schema_digest": "x"}\n')
    with pytest.raises(jprofile.ProfileError):
        jprofile.TraceRecorder.load(path)
    with pytest.raises(tprofile.ProfileError):
        tprofile.TraceRecorder.load(path)


# -------------------------------------------------------------- cost model


@pytest.mark.parametrize("seed", range(6))
def test_fit_bit_equal_to_jax(seed):
    records = _profile_for(SCORE_PATHS + ("train:reference",),
                           per_path=9 + seed % 3, noise=0.3, seed=seed)
    order = np.random.default_rng(seed).permutation(len(records))
    records = [records[i] for i in order]
    want = jprofile.fit_cost_model(_to_jax(records), min_support=8)
    got = tprofile.fit_cost_model(records, min_support=8)
    assert set(got.weights) == set(want.weights)
    for p in want.weights:
        assert got.weights[p].tobytes() == want.weights[p].tobytes()
    assert got.support == want.support
    assert got.residual_medape == want.residual_medape
    assert got.snapshot() == want.snapshot()


# ------------------------------------------------- planner decision rule


#: The threshold decision table (tests/test_profile.py) — every folklore
#: regime, train rows included.
COLD_DECISIONS = [
    (dict(n_pairs=8, max_nodes=24, mean_nodes=16.0, avg_degree=2.0,
          density=0.1), 0.0, False, "packed_sparse"),
    (dict(n_pairs=8, max_nodes=24, mean_nodes=16.0, avg_degree=6.0,
          density=0.4), 0.0, False, "packed_dense"),
    (dict(n_pairs=3, max_nodes=24, mean_nodes=16.0, avg_degree=2.0,
          density=0.1), 0.0, False, "bucketed_mega"),
    (dict(n_pairs=8, max_nodes=24, mean_nodes=16.0, avg_degree=2.0,
          density=0.1), 0.6, False, "embedding_cache"),
    (dict(n_pairs=3, max_nodes=24, mean_nodes=16.0, avg_degree=2.0,
          density=0.1), 0.0, True, "reference"),
    (dict(n_pairs=8, max_nodes=24, mean_nodes=16.0, avg_degree=6.0,
          density=0.4), 0.9, True, "packed_dense"),
    (dict(n_pairs=8, max_nodes=24, mean_nodes=16.0, avg_degree=2.0,
          density=0.1), 0.0, True, "packed_sparse"),
    (dict(n_pairs=0), 0.0, False, "reference"),
    (dict(n_pairs=8, max_nodes=24, mean_nodes=16.0, avg_degree=2.0,
          density=0.1, has_labels=False), 0.0, True, "reference"),
]


@pytest.mark.parametrize("stats,hit_frac,train,want", COLD_DECISIONS)
def test_cold_planner_decision_table_matches_jax(stats, hit_frac, train,
                                                 want):
    """Empty profile: the port's `_select` equals the JAX engine's (path,
    reason, estimates) and its own threshold planner's, bit for bit."""
    from repro.core.engine import WorkloadStats as JaxStats

    jmeasured, measured = _engines(planner="measured")
    got = measured._select(WorkloadStats(**stats), hit_frac, train=train)
    ref = ScoringEngine(_tparams(), CFG, planner="threshold",
                        device="cpu")._select(WorkloadStats(**stats),
                                              hit_frac, train=train)
    jax_got = jmeasured._select(JaxStats(**stats), hit_frac, train=train)
    assert got == ref == jax_got
    assert got[0] == want and got[2] == {}


def test_forced_non_train_path_refuses_training():
    eng = ScoringEngine(_tparams(), CFG, path="bucketed_mega", device="cpu")
    with pytest.raises(ValueError, match="VJP-capable"):
        eng.plan(_pairs(1, 4), train=True)


def test_partial_support_falls_back_whole():
    """A profile covering some candidates must not steer."""
    jeng, eng = _engines(planner="measured")
    records = _profile_for(("packed_dense", "packed_sparse"))
    _seed(eng, records)
    _seed(jeng, _to_jax(records))
    pairs = _pairs(4, 8)
    plan, jplan = eng.plan(pairs), jeng.plan(pairs)
    assert (plan.path, plan.reason) == (jplan.path, jplan.reason)
    assert plan.path == "packed_sparse" and plan.cost_estimates == {}
    assert eng.health()["planner"] == jeng.health()["planner"]


@pytest.mark.parametrize("degree", (2.0, 6.0))
@pytest.mark.parametrize("n", (3, 8, 30))
def test_warm_planner_matches_jax(degree, n):
    """Full support: the port plans the path the JAX engine plans, with
    the same reason and the same estimates, bit for bit."""
    jeng, eng = _engines(planner="measured")
    records = _profile_for(SCORE_PATHS[::-1], noise=0.2, seed=n)
    _seed(eng, records)
    _seed(jeng, _to_jax(records))
    pairs = _pairs(int(degree) + n, n, avg_degree=degree)
    plan, jplan = eng.plan(pairs), jeng.plan(pairs)
    assert (plan.path, plan.reason) == (jplan.path, jplan.reason)
    assert plan.cost_estimates == jplan.cost_estimates
    assert set(plan.cost_estimates) == set(SCORE_PATHS)
    assert "cost model" in plan.reason
    snap = eng.health()["planner"]
    assert snap == jeng.health()["planner"]
    assert snap["enabled"] is True


def test_warm_planner_overrides_threshold_rule():
    """bucketed_mega measured cheapest flips a low-degree batch away from
    the sparse rule; the threshold engine keeps the rule."""
    eng = ScoringEngine(_tparams(), CFG, planner="measured", device="cpu")
    _seed(eng, _profile_for(SCORE_PATHS))        # bucketed_mega cheapest
    plan = eng.plan(_pairs(4, 8))
    assert plan.path == "bucketed_mega"
    assert plan.cost_estimates["bucketed_mega"] == min(
        plan.cost_estimates.values())
    ref = ScoringEngine(_tparams(), CFG, planner="threshold",
                        device="cpu").plan(_pairs(4, 8))
    assert ref.path == "packed_sparse" and ref.cost_estimates == {}


def test_train_planner_uses_train_keyed_model():
    jeng, eng = _engines(planner="measured")
    records = _profile_for(tuple(f"train:{p}" for p in TRAIN_PATHS))
    _seed(eng, records)
    _seed(jeng, _to_jax(records))
    pairs = _pairs(5, 8)
    plan, jplan = eng.plan(pairs, train=True), jeng.plan(pairs, train=True)
    assert plan.path == jplan.path == "reference"
    assert plan.cost_estimates == jplan.cost_estimates
    assert set(plan.cost_estimates) == set(TRAIN_PATHS)
    assert plan.fallback == "reference"


def test_cache_candidate_only_when_keys_hashed():
    """The embedding-cached path is a candidate only when the call hashed
    keys (auto with a non-empty cache), priced with its misses."""
    eng = ScoringEngine(_tparams(), CFG, planner="measured", device="cpu")
    records = _profile_for(SCORE_PATHS + ("embedding_cache",))
    _seed(eng, records)
    pairs = _pairs(6, 8)
    assert set(eng.plan(pairs).cost_estimates) == set(SCORE_PATHS)
    eng.embed_graphs([pairs[0][0]])
    plan = eng.plan(pairs)
    assert set(plan.cost_estimates) == set(SCORE_PATHS) | {"embedding_cache"}
    jeng = JaxEngine(_jparams(), JCFG, planner="measured")
    _seed(jeng, _to_jax(records))
    jeng.embed_graphs([pairs[0][0]])
    jplan = jeng.plan(pairs)
    assert plan.cost_estimates == jplan.cost_estimates
    assert (plan.path, plan.reason) == (jplan.path, jplan.reason)


def test_planner_refit_cadence():
    eng = ScoringEngine(_tparams(), CFG, path="packed_sparse",
                        clock=_FakeClock(), device="cpu")
    pairs = _pairs(6, 5)
    for _ in range(3):
        eng.score(pairs)
    assert eng.counters["planner_refits"] == 0
    for _ in range(6):
        eng.score(pairs)
    eng._cost_model()
    refits = eng.counters["planner_refits"]
    assert refits == 1
    for _ in range(eng.PLANNER_REFIT_EVERY):
        eng.score(pairs)
    eng._cost_model()
    assert eng.counters["planner_refits"] == refits + 1
    assert eng.health()["planner"]["model"]["support"] == {
        "packed_sparse": eng.recorder.total_records}


def test_score_records_one_trace_per_work_item():
    """An oversize split is two work items: two records with n_devices 1
    and the fields the JAX engine records (walls are each engine's
    own)."""
    rng = np.random.default_rng(11)
    pairs = [(random_graph(rng), random_graph(rng)) for _ in range(6)]
    pairs[2] = (random_graph(rng, 70), random_graph(rng, 20))
    jeng, eng = _engines(clock=_FakeClock(), planner="threshold")
    jeng.score(pairs)
    eng.score(pairs)
    got, want = eng.recorder.records(), jeng.recorder.records()
    assert [r.path for r in got] == ["packed_sparse", "bucketed_mega"]
    drop = ("wall_s",)
    assert [{k: v for k, v in dataclasses.asdict(r).items() if k not in drop}
            for r in got] == [
        {k: v for k, v in dataclasses.asdict(r).items() if k not in drop}
        for r in want]
    assert all(r.wall_s > 0 and r.n_devices == 1 for r in got)


def test_health_reports_planner_state():
    eng = ScoringEngine(_tparams(), CFG, path="packed_sparse",
                        clock=_FakeClock(), device="cpu")
    eng.score(_pairs(3, 5))
    h = eng.health()["planner"]
    assert h == {"mode": "measured", "enabled": False, "records": 1,
                 "records_dropped": 0, "record_errors": 0}


# ------------------------------------------------------------- fault seams


def test_recorder_failure_never_fails_scoring():
    eng = ScoringEngine(_tparams(), CFG, path="packed_sparse",
                        clock=_FakeClock(), device="cpu")
    pairs = _pairs(7, 6)
    with faults.inject("profile", mode="raise") as plan:
        out = eng.score(pairs)
    assert plan.triggered >= 1
    assert np.isfinite(out).all()
    assert eng.counters["profile_record_errors"] >= 1
    assert len(eng.recorder) == 0
    eng.score(pairs)
    assert len(eng.recorder) == 1


def test_degraded_record_is_not_clean():
    eng = ScoringEngine(_tparams(), CFG, clock=_FakeClock(), device="cpu")
    with faults.inject("packed_sparse", mode="raise"):
        eng.score(_pairs(2, 8))
    r = eng.recorder.records()[-1]
    assert r.degraded_from == ("packed_sparse",) and r.path == "packed_dense"
    assert tprofile.fit_cost_model([r], min_support=1).weights == {}


def test_torn_profile_flush_self_heals(tmp_path):
    path = str(tmp_path / "profile.jsonl")
    rec = tprofile.TraceRecorder(path=path)
    for i in range(4):
        rec.record(kind="score", path="reference", n_pairs=1 + i,
                   max_nodes=8, mean_nodes=8.0, avg_degree=1.0,
                   density=0.1, wall_s=0.001)
    with faults.fs_inject("profile", mode="torn") as plan:
        rec.flush()
    assert plan.triggered == 1
    records, dropped = tprofile.read_profile(path)
    assert dropped >= 1 and len(records) < 4
    # the JAX reader sees the same damage
    jrecords, jdropped = jprofile.read_profile(path)
    assert (len(jrecords), jdropped) == (len(records), dropped)
    rec2 = tprofile.TraceRecorder.load(path)
    rec2.record(kind="score", path="reference", n_pairs=9, max_nodes=8,
                mean_nodes=8.0, avg_degree=1.0, density=0.1, wall_s=0.002)
    assert rec2.flush() == 1
    records2, dropped2 = tprofile.read_profile(path)
    assert dropped2 == 0 and records2[-1].n_pairs == 9


def test_missing_profile_write_keeps_ring(tmp_path):
    path = str(tmp_path / "profile.jsonl")
    rec = tprofile.TraceRecorder(path=path)
    rec.record(kind="score", path="reference", n_pairs=1, max_nodes=8,
               mean_nodes=8.0, avg_degree=1.0, density=0.1, wall_s=0.001)
    with faults.fs_inject("profile", mode="missing"):
        rec.flush()
    assert not os.path.exists(path) and len(rec) == 1


def test_jax_fault_module_does_not_arm_the_port():
    """Each package's injector arms its own engine's seam only."""
    from repro_torch.core import engine as engine_mod

    with jfaults.inject("packed_sparse"):
        assert engine_mod._FAULT_HOOK is None
    with faults.inject("packed_sparse"):
        assert engine_mod._FAULT_HOOK is not None
    assert engine_mod._FAULT_HOOK is None
