"""The port's fault injector (`repro_torch.testing.faults`) against the JAX
package's (`repro.testing.faults`), on the CPU.

For every mode (raise, oom, nan) at every score site, the port's engine
under its injector walks the ladder the JAX engine walks under the JAX
injector on the same pairs: the same `degraded_from`, attempts, counters
and plan counters, scores within the parity band of the rung that served
(tests/test_parity_matrix.py). The train sites degrade and skip as in the
JAX package, and the filesystem modes damage the port's store as the JAX
package's damage its own.
"""

import functools

import jax
import numpy as np
import pytest

from repro.core import store as jstore
from repro.core.engine import ScoringEngine as JaxEngine
from repro.core.simgnn import SimGNNConfig as JaxConfig
from repro.core.simgnn import init_simgnn_params
from repro.testing import faults as jfaults
from repro_torch.core import engine as engine_mod
from repro_torch.core import store as tstore
from repro_torch.core.engine import ScoringEngine, tree_all_finite
from repro_torch.core.health import OPEN
from repro_torch.core.simgnn import SimGNNConfig
from repro_torch.data.graphs import random_graph
from repro_torch.params import params_from_numpy, tree_leaves
from repro_torch.testing import faults
from test_parity_matrix import ATOL_F32

CFG = SimGNNConfig()
JCFG = JaxConfig()
#: the band of a call served by a rung other than its plan's: bucketed
#: scoring's (the widest of the rungs a ladder lands on).
DEGRADED_BAND = ATOL_F32["bucketed_mega"]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@functools.lru_cache(maxsize=None)
def _jparams():
    return init_simgnn_params(jax.random.PRNGKey(0), JCFG)


def _tparams():
    return params_from_numpy(jax.tree.map(np.asarray, _jparams()), "cpu")


@functools.lru_cache(maxsize=None)
def _pairs(seed, n, max_n=24, avg_degree=2.0):
    rng = np.random.default_rng(seed)
    return tuple((random_graph(rng, int(rng.integers(5, max_n + 1)),
                               avg_degree=avg_degree),
                  random_graph(rng, int(rng.integers(5, max_n + 1)),
                               avg_degree=avg_degree))
                 for _ in range(n))


def _engines(path="auto", **kw):
    return (JaxEngine(_jparams(), JCFG, path=path, clock=_FakeClock(), **kw),
            ScoringEngine(_tparams(), CFG, path=path, clock=_FakeClock(),
                          device="cpu", **kw))


def _run_both(path, site, mode, pairs, **kw):
    jeng, teng = _engines(path, **kw)
    outs = []
    for eng, mod in ((jeng, jfaults), (teng, faults)):
        with mod.inject(site, mode=mode) as plan:
            try:
                outs.append((eng.score(pairs), plan.calls, plan.triggered))
            except Exception as exc:
                outs.append((type(exc).__name__, plan.calls, plan.triggered))
    return jeng, teng, outs


#: (engine path, fault site): every score site the ladder or the cached
#: path calls, each from an engine whose plan reaches it.
SCORE_SITES = (("auto", "packed_sparse"), ("packed_dense", "packed_dense"),
               ("bucketed_mega", "bucketed_mega"),
               ("two_kernel", "two_kernel"), ("reference", "reference"),
               ("embedding_cache", "embed"),
               ("embedding_cache", "head"))


@pytest.mark.parametrize("mode", ("raise", "oom", "nan"))
@pytest.mark.parametrize("path,site", SCORE_SITES)
def test_score_site_ladder_matches_jax(path, site, mode):
    pairs = list(_pairs(0, 12))
    jeng, teng, ((want, jcalls, jtrig), (got, tcalls, ttrig)) = _run_both(
        path, site, mode, pairs)
    assert (tcalls, ttrig) == (jcalls, jtrig) and ttrig >= 1
    if isinstance(want, str):            # the terminal rung raised
        assert (path, mode) != ("reference", "nan")
        assert got == {"FaultError": "FaultError",
                       "ResourceExhausted": "ResourceExhausted"}[want]
        assert teng.counters == jeng.counters
        return
    jp, tp = jeng.last_plan, teng.last_plan
    assert (tp.path, tp.reason) == (jp.path, jp.reason)
    assert (tp.degraded_from, tp.attempts) == (jp.degraded_from,
                                               jp.attempts)
    assert teng.health()["counters"] == jeng.health()["counters"]
    assert np.array_equal(np.isnan(got), np.isnan(want))
    served = (jp.degraded_from and DEGRADED_BAND) or ATOL_F32[jp.path]
    np.testing.assert_allclose(got, want, rtol=0, atol=served)


def test_cascading_faults_reach_the_reference_like_jax():
    pairs = list(_pairs(3, 8))
    jeng, teng = _engines("packed_sparse")
    sites = ("packed_sparse", "packed_dense", "bucketed_mega")
    for eng, mod in ((jeng, jfaults), (teng, faults)):
        with mod.inject(sites[0]), mod.inject(sites[1]), \
                mod.inject(sites[2]):
            eng.score(pairs)
    assert teng.last_plan.degraded_from == jeng.last_plan.degraded_from \
        == sites
    assert teng.last_plan.attempts == jeng.last_plan.attempts == 4
    assert teng.counters == jeng.counters


@pytest.mark.parametrize("after,times", ((0, 1), (1, None), (2, 1)))
def test_after_and_times_counters_match_jax(after, times):
    pairs = list(_pairs(4, 8))
    plans = []
    for eng, mod in zip(_engines("packed_dense"), (jfaults, faults)):
        with mod.inject("packed_dense", after=after, times=times) as plan:
            for _ in range(3):
                eng.score(pairs)
        plans.append((plan.calls, plan.triggered, dict(eng.counters)))
    assert plans[0] == plans[1]


def test_breaker_opens_and_cools_down_like_jax():
    clocks, engines = [], []
    pairs = list(_pairs(6, 8))
    for cls, params, kw in ((JaxEngine, _jparams(), {}),
                            (ScoringEngine, _tparams(), {"device": "cpu"})):
        clk = _FakeClock()
        clocks.append(clk)
        engines.append(cls(params, JCFG if cls is JaxEngine else CFG,
                           path="packed_sparse", clock=clk,
                           breaker_threshold=3, breaker_cooldown_s=5.0,
                           **kw))
    for eng, mod in zip(engines, (jfaults, faults)):
        with mod.inject("packed_sparse"):
            for _ in range(3):
                eng.score(pairs)
    jeng, teng = engines
    (key,) = [k for k in teng.breakers if k[0] == "packed_sparse"]
    assert teng.breakers[key].state == OPEN
    for eng, clk in zip(engines, clocks):
        eng.score(pairs)                 # open: fallback, no attempt
    assert teng.last_plan.attempts == jeng.last_plan.attempts == 1
    assert teng.counters == jeng.counters
    for clk in clocks:
        clk.t += 5.0
    for eng in engines:
        eng.score(pairs)
    assert teng.last_plan.degraded_from == jeng.last_plan.degraded_from == ()
    assert teng.health()["breakers"] == jeng.health()["breakers"]


def test_embed_and_fallback_both_fail_like_jax():
    pairs = list(_pairs(1, 8))
    jeng, teng = _engines("embedding_cache")
    outs = []
    for eng, mod in ((jeng, jfaults), (teng, faults)):
        with mod.inject("embed"), mod.inject("embed_fallback"):
            outs.append(eng.score(pairs))
    assert teng.last_plan.degraded_from == jeng.last_plan.degraded_from \
        == ("embedding_cache",)
    assert teng.counters == jeng.counters
    assert teng.counters["embed_dropped_graphs"] > 0
    np.testing.assert_allclose(outs[1], outs[0], rtol=0,
                               atol=ATOL_F32["bucketed_mega"])


@pytest.mark.parametrize("mode", ("raise", "oom", "nan"))
@pytest.mark.parametrize("path", ("packed_sparse", "packed_dense"))
def test_train_site_degrades_like_jax(path, mode):
    pairs = list(_pairs(9, 12))
    tgt = np.linspace(0.1, 0.9, 12).astype(np.float32)
    jeng, teng = _engines(path)
    jl0, _ = jeng.loss_and_grad(pairs, tgt)
    l0, g0 = teng.loss_and_grad(pairs, tgt)
    with jfaults.inject(f"train:{path}", mode=mode):
        jl1, _ = jeng.loss_and_grad(pairs, tgt)
    with faults.inject(f"train:{path}", mode=mode) as plan:
        l1, g1 = teng.loss_and_grad(pairs, tgt)
    assert plan.triggered == 1
    assert teng.last_plan.degraded_from == jeng.last_plan.degraded_from \
        == (path,)
    assert teng.counters == jeng.counters
    assert abs(float(l1) - float(jl1)) <= 1e-6
    assert abs(float(l0) - float(l1)) <= 1e-6
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_profile_fault_never_fails_training():
    eng = ScoringEngine(_tparams(), CFG, path="packed_dense",
                        clock=_FakeClock(), device="cpu")
    batch = list(_pairs(41, 4))
    targets = np.linspace(0.1, 0.9, len(batch)).astype(np.float32)
    with faults.inject("profile", mode="raise") as plan:
        loss, grads = eng.loss_and_grad(batch, targets)
    assert plan.triggered >= 1
    assert tree_all_finite(loss, grads)
    assert eng.counters["profile_record_errors"] >= 1


def test_nan_mode_corrupts_every_float_leaf():
    import torch

    out = faults._nan_like((torch.ones(2), torch.ones(2, dtype=torch.int32),
                            {"a": np.ones(3, np.float32),
                             "b": [np.arange(2)]}, 1.5, "x"))
    assert torch.isnan(out[0]).all() and out[1].tolist() == [1, 1]
    assert np.isnan(out[2]["a"]).all() and out[2]["b"][0].tolist() == [0, 1]
    assert np.isnan(out[3]) and out[4] == "x"


def test_unknown_modes_rejected():
    with pytest.raises(ValueError):
        with faults.inject("packed_sparse", mode="boom"):
            pass
    with pytest.raises(ValueError):
        with faults.fs_inject("store:shard", mode="boom"):
            pass
    assert engine_mod._FAULT_HOOK is None and tstore._FS_HOOK is None


# ------------------------------------------------------- filesystem faults


def _write(store_mod, directory, m):
    return store_mod.ShardStore(str(directory)).write(
        m, shard_rows=3, graph_keys=[f"{i:02x}" for i in range(len(m))])


@pytest.mark.parametrize("site,mode", (
    ("store:shard", "torn"), ("store:shard", "bitflip"),
    ("store:shard", "missing"), ("store:manifest", "torn"),
    ("store:manifest", "bitflip"), ("store:manifest", "missing"),
    ("store:manifest", "stale")))
def test_fs_inject_damages_the_store_like_jax(tmp_path, site, mode):
    """Each write-time mode leaves the port's store in the state the JAX
    package's mode leaves its own: the same bytes on disk, the same
    verification verdicts or the same refusal."""
    m = np.arange(40, dtype=np.float32).reshape(10, 4)
    after = 1 if site == "store:shard" else 0     # the second shard
    results = []
    for tag, store_mod, mod in (("j", jstore, jfaults),
                                ("t", tstore, faults)):
        with mod.fs_inject(site, mode, after=after, times=1) as plan:
            _write(store_mod, tmp_path / tag, m)
        store = store_mod.ShardStore(str(tmp_path / tag))
        try:
            verdict = store.verify()
        except store_mod.StoreError as exc:
            verdict = type(exc).__name__
        files = sorted(p.name for p in (tmp_path / tag).iterdir())
        results.append((plan.calls, plan.triggered, verdict, files,
                        {f: (tmp_path / tag / f).read_bytes()
                         for f in files}))
    assert results[0] == results[1]
    assert results[1][1] == 1


@pytest.mark.parametrize("mode", ("bitflip", "torn", "missing", "stale"))
def test_corrupt_file_at_rest_like_jax(tmp_path, mode):
    m = np.arange(40, dtype=np.float32).reshape(10, 4)
    verdicts = []
    for tag, store_mod, mod in (("j", jstore, jfaults),
                                ("t", tstore, faults)):
        _write(store_mod, tmp_path / tag, m)
        target = (tmp_path / tag / ("manifest.json" if mode == "stale"
                                    else "shard_00001.bin"))
        mod.corrupt_file(str(target), mode)
        store = store_mod.ShardStore(str(tmp_path / tag))
        try:
            verdicts.append(store.verify())
        except store_mod.StoreError as exc:
            verdicts.append(type(exc).__name__)
    assert verdicts[0] == verdicts[1]
    assert verdicts[1] != {f"shard_{i:05d}.bin": "ok" for i in range(4)}


def test_profile_fs_site_tears_the_flush(tmp_path):
    from repro_torch.core.profile import TraceRecorder, read_profile

    path = str(tmp_path / "p.jsonl")
    rec = TraceRecorder(path=path)
    for i in range(4):
        rec.record(kind="score", path="reference", n_pairs=1 + i,
                   max_nodes=8, mean_nodes=8.0, avg_degree=1.0,
                   density=0.1, wall_s=0.001)
    with faults.fs_inject("profile", mode="bitflip", at_byte=3) as plan:
        rec.flush()
    assert plan.triggered == 1
    with pytest.raises(tstore.StoreError):        # the header is damaged
        read_profile(path)
