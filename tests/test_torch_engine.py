"""The PyTorch port's ScoringEngine and serving front against the JAX
package's (`planner="threshold"`, which tests/test_parity_matrix.py pins
bit-identical to a cold measured planner), on the CPU where the kernel
wrappers run their plain versions.

Every case checks the same `path` and `reason` as the JAX engine and
scores within the parity matrix's bounds (tests/test_parity_matrix.py):
1e-6 for reference / packed_dense / packed_sparse, 2e-5 for bucketed_mega,
2e-2 for bf16 params. Also pinned: the oversize split, quarantine
(lenient NaN, strict raise), the empty call, a ladder walk through the
port's `_FAULT_HOOK` (armed by `repro_torch.testing.faults`), and the
copied validation, breaker and MicroBatcher modules.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import health as jhealth
from repro.core import validate as jvalidate
from repro.core.engine import ScoringEngine as JaxEngine
from repro.core.simgnn import SimGNNConfig as JaxConfig
from repro.core.simgnn import init_simgnn_params
from repro.serve import batching as jserve
from repro.testing import faults
from repro_torch.core import engine as engine_mod
from repro_torch.core import health as thealth
from repro_torch.core import validate as tvalidate
from repro_torch.core.engine import ScoringEngine
from repro_torch.core.simgnn import SimGNNConfig
from repro_torch.data.graphs import random_graph
from repro_torch.params import params_from_numpy
from repro_torch.serve import batching as tserve
from repro_torch.testing import faults as tfaults
from test_parity_matrix import ATOL_BF16, ATOL_F32

CFG = SimGNNConfig()
JCFG = JaxConfig()


@functools.lru_cache(maxsize=None)
def _jparams(dtype="float32"):
    p = init_simgnn_params(jax.random.PRNGKey(0), JCFG)
    if dtype == "bfloat16":
        p = jax.tree.map(lambda x: x.astype(jnp.bfloat16), p)
    return p


def _tparams(dtype="float32"):
    return params_from_numpy(jax.tree.map(np.asarray, _jparams(dtype)), "cpu")


@functools.lru_cache(maxsize=None)
def _pairs(batch: int, seed: int = 100):
    rng = np.random.default_rng(seed + batch)
    return tuple((random_graph(rng, int(rng.integers(5, 65))),
                  random_graph(rng, int(rng.integers(5, 65))))
                 for _ in range(batch))


def _engines(path="auto", dtype="float32", **kw):
    return (JaxEngine(_jparams(dtype), JCFG, path=path, planner="threshold",
                      **kw),
            ScoringEngine(_tparams(dtype), CFG, path=path, device="cpu", **kw))


def _check_same(jax_engine, engine, pairs, atol):
    want = jax_engine.score(pairs)
    got = engine.score(pairs)
    jp, tp = jax_engine.last_plan, engine.last_plan
    assert (tp.path, tp.fallback, tp.reason) == (jp.path, jp.fallback,
                                                 jp.reason)
    assert np.array_equal(tp.fit_idx, jp.fit_idx)
    assert np.array_equal(tp.over_idx, jp.over_idx)
    assert dataclasses.asdict(tp.stats) == dataclasses.asdict(jp.stats)
    assert (tp.degraded_from, tp.attempts) == (jp.degraded_from, jp.attempts)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    return got, want


@pytest.mark.parametrize("batch", (7, 12))
def test_auto_matches_jax(batch):
    jax_engine, engine = _engines()
    _check_same(jax_engine, engine, list(_pairs(batch)),
                ATOL_F32["packed_sparse"])
    assert engine.last_plan.path == "packed_sparse"
    assert engine.last_pack_stats == jax_engine.last_pack_stats


@pytest.mark.parametrize("path", ("reference", "bucketed_mega",
                                  "packed_dense", "packed_sparse",
                                  "embedding_cache", "two_kernel"))
def test_forced_paths_match_jax(path):
    jax_engine, engine = _engines(path)
    for batch in (7, 12):
        _check_same(jax_engine, engine, list(_pairs(batch)), ATOL_F32[path])
    assert engine.last_plan.reason == f"forced path={path}"


@pytest.mark.parametrize("path", ("packed_sparse", "bucketed_mega"))
def test_bf16_params_match_jax(path):
    jax_engine, engine = _engines(path, "bfloat16")
    _check_same(jax_engine, engine, list(_pairs(7)), ATOL_BF16)


def test_small_call_goes_bucketed():
    jax_engine, engine = _engines()
    _check_same(jax_engine, engine, list(_pairs(3)),
                ATOL_F32["bucketed_mega"])
    assert engine.last_plan.path == "bucketed_mega"
    assert engine.last_plan.reason.startswith("batch of 3 too small")


def test_oversize_pair_splits_to_bucketed():
    rng = np.random.default_rng(11)
    pairs = [(random_graph(rng), random_graph(rng)) for _ in range(6)]
    pairs[2] = (random_graph(rng, 70), random_graph(rng, 20))
    jax_engine, engine = _engines()
    got, want = _check_same(jax_engine, engine, pairs,
                            ATOL_F32["bucketed_mega"])
    plan = engine.last_plan
    assert plan.path == "packed_sparse" and plan.over_idx.tolist() == [2]
    assert plan.attempts == 2 and plan.degraded_from == ()
    live = [i for i in range(6) if i != 2]
    np.testing.assert_allclose(got[live], want[live], rtol=0,
                               atol=ATOL_F32["packed_sparse"])
    assert 128 in engine.bucket_fns          # the oversize bucket's callable


def _bad_pairs():
    pairs = [list(p) for p in _pairs(7)]
    bad = dict(pairs[3][1])
    bad["adj"] = bad["adj"].copy()
    bad["adj"][0, 0] = 1.0                       # self loop: invalid
    pairs[3][1] = bad
    return [tuple(p) for p in pairs]


def test_lenient_quarantine_and_strict_raise():
    pairs = _bad_pairs()
    jax_engine, engine = _engines()
    got, _ = _check_same(jax_engine, engine, pairs,
                         ATOL_F32["packed_sparse"])
    assert np.isnan(got[3]) and np.isfinite(np.delete(got, 3)).all()
    assert engine.last_plan.quarantined == tuple(
        tvalidate.InvalidGraph(r.pair, r.side, r.reasons)
        for r in jax_engine.last_plan.quarantined)
    assert engine.health()["counters"]["quarantined_graphs"] == 1
    strict = ScoringEngine(_tparams(), CFG, validation="strict",
                           device="cpu")
    with pytest.raises(tvalidate.GraphValidationError) as err:
        strict.score(pairs)
    assert [(r.pair, r.side) for r in err.value.records] == [(3, 1)]


def test_empty_call():
    jax_engine, engine = _engines()
    got, _ = _check_same(jax_engine, engine, [], 0.0)
    assert got.shape == (0,)
    assert (engine.last_plan.path, engine.last_plan.reason) == (
        "reference", "empty call")


def test_fault_hook_ladder_walk_matches_jax():
    """packed_sparse raises -> served by packed_dense, recorded and
    counted exactly as the JAX engine under `repro.testing.faults`."""
    pairs = list(_pairs(12))
    jax_engine, engine = _engines()
    with faults.inject("packed_sparse"):
        want = jax_engine.score(pairs)
    with tfaults.inject("packed_sparse"):
        got = engine.score(pairs)
    jp, tp = jax_engine.last_plan, engine.last_plan
    assert tp.degraded_from == jp.degraded_from == ("packed_sparse",)
    assert tp.attempts == jp.attempts == 2
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL_F32["packed_dense"])
    jh, th = jax_engine.health(), engine.health()
    assert th["counters"] == jh["counters"]
    assert th["breakers"] == jh["breakers"]
    assert engine.last_pack_stats == jax_engine.last_pack_stats


@pytest.mark.parametrize("start", ("packed_sparse", "packed_dense",
                                   "bucketed_mega", "reference",
                                   "two_kernel", "embedding_cache"))
def test_ladder_keeps_jax_rungs_on_cpu_and_stops_at_kernels_on_card(start):
    """On the CPU the ladder is the JAX engine's; on the card it ends at the
    last kernel rung, so no kernel failure is served by plain PyTorch."""
    from repro.core.engine import DEGRADE_LADDER as JAX_LADDER

    cpu = engine_mod.degrade_rungs(start, on_card=False)
    assert cpu == (start,) + JAX_LADDER[start]
    card = engine_mod.degrade_rungs(start, on_card=True)
    assert card == tuple(r for r in cpu if r != "reference" or r == start)
    assert engine_mod.degrade_rungs(start, on_card=True,
                                    degrade=False) == (start,)


def test_not_ported_paths_raise():
    """Every path of the JAX engine is ported now: each constructs, and
    only an unknown path raises."""
    from repro.core.engine import PATHS as JAX_PATHS

    assert engine_mod.PATHS == JAX_PATHS
    assert not hasattr(engine_mod, "NOT_PORTED")
    for path in JAX_PATHS:
        assert ScoringEngine(_tparams(), CFG, path=path,
                             device="cpu").path == path
    with pytest.raises(ValueError):
        ScoringEngine(_tparams(), CFG, path="bogus", device="cpu")


def test_query_server_contract_matches_jax():
    pairs = list(_pairs(12))
    flags = ({"use_kernels": False}, {"use_kernels": True, "packing": False},
             {"use_kernels": True}, {"path": "packed_dense"})
    for kw in flags:
        jscore = jserve.simgnn_query_server(_jparams(), JCFG, **kw)
        tscore = tserve.simgnn_query_server(_tparams(), CFG, device="cpu",
                                            **kw)
        assert tscore.engine.path == jscore.engine.path
        assert tscore.bucket_fns is tscore.engine.bucket_fns
        assert tscore.last_pack_stats is None and tscore.last_plan is None
        assert tscore.node_budget == jscore.node_budget == 64
        want, got = jscore(pairs), tscore(pairs)
        np.testing.assert_allclose(
            got, want, rtol=0, atol=ATOL_F32[jscore.last_plan.path])
        assert tscore.last_plan.reason == jscore.last_plan.reason
        assert tscore.last_pack_stats == jscore.last_pack_stats


def test_copied_validate_and_breaker_modules_agree():
    rng = np.random.default_rng(0)
    g = random_graph(rng, 6)
    broken = [
        {"adj": np.full((3, 3), np.nan, np.float32)},
        {"adj": np.ones((2, 3), np.float32)},
        {"adj": g["adj"], "labels": g["labels"].astype(np.float32)},
        {"adj": g["adj"], "labels": np.full(6, 40, np.int32)},
        {"labels": g["labels"]},
        {"adj": np.zeros((0, 0), np.float32)},
    ]
    for b in broken:
        assert (tvalidate.graph_problems(b, n_labels=29)
                == jvalidate.graph_problems(b, n_labels=29))
    pairs = [(g, b) for b in broken] + [(g, g), "not a pair"]
    ti, tr = tvalidate.validate_pairs(pairs, n_labels=29)
    ji, jr = jvalidate.validate_pairs(pairs, n_labels=29)
    assert np.array_equal(ti, ji)
    assert [(r.pair, r.side, r.reasons) for r in tr] == [
        (r.pair, r.side, r.reasons) for r in jr]
    now = [0.0]
    brs = [m.CircuitBreaker(failure_threshold=2, cooldown_s=5.0,
                            clock=lambda: now[0]) for m in (thealth, jhealth)]
    for step in ("f", "f", "a", "t", "a", "f", "t", "a", "s", "a"):
        outs = []
        for br in brs:
            if step == "f":
                br.record_failure()
            elif step == "s":
                br.record_success()
            elif step == "a":
                outs.append(br.allow())
        if step == "t":
            now[0] += 6.0
        assert len(set(outs)) <= 1
        assert brs[0].snapshot() == brs[1].snapshot()


def test_micro_batcher_copy_matches_jax():
    def run(mod):
        now = [0.0]
        mb = mod.MicroBatcher(run_batch=lambda xs: [x * 2 for x in xs],
                              max_batch=3, max_wait_s=1.0,
                              clock=lambda: now[0], sleep=lambda s: None)
        out = [mb.submit(1), mb.submit(2), mb.submit(3), mb.submit(4)]
        now[0] += 2.0
        out.append(mb.poll())
        out.append(mb.submit(5, timeout_s=0.5))
        now[0] += 0.6
        out.append(mb.submit(6))
        out.append(mb.flush())
        res = [[(type(r).__name__, getattr(r, "request", r)) for r in o]
               if isinstance(o, list) else o for o in out]
        return res, vars(mb.stats)

    assert run(tserve) == run(jserve)
