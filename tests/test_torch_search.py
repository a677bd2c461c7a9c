"""The search slice of the PyTorch port against the JAX package, on the CPU
where the kernel wrappers run their plain versions: the copied numpy
modules (`data/graphs.py` zipf streams, `core/cache.py`, `core/store.py`),
the engine's `embedding_cache` and `two_kernel` paths, and
`serve/search.SimilaritySearchServer`.

Bounds: graph keys, generators, store bytes and params digests bit for
bit; engine paths the parity matrix's (tests/test_parity_matrix.py:
embedding_cache 1e-6, two_kernel 2e-5) with the same plan (path, reason,
cached_idx, to_embed_idx); embeddings rtol 1e-5 / atol 1e-6; served top-k
indices equal, scores within 1e-6; two-stage search at M = N bit-identical
to the exact scan. Fault hooks: the CPU keeps the JAX engine's embed and
head retries and its prefilter -> exact-scan degradation, with the same
counters.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import cache as jcache
from repro.core import store as jstore
from repro.core.engine import ScoringEngine as JaxEngine
from repro.core.simgnn import SimGNNConfig as JaxConfig
from repro.core.simgnn import init_simgnn_params
from repro.data import graphs as jgraphs
from repro.serve.search import SimilaritySearchServer as JaxServer
from repro.testing import faults
from repro_torch.core import cache as tcache
from repro_torch.core import engine as engine_mod
from repro_torch.core import store as tstore
from repro_torch.core.engine import ScoringEngine
from repro_torch.core.simgnn import SimGNNConfig
from repro_torch.data import graphs as tgraphs
from repro_torch.params import params_from_numpy
from repro_torch.serve.search import SimilaritySearchServer
from repro_torch.testing import faults as tfaults
from test_parity_matrix import ATOL_F32

CFG = SimGNNConfig()
JCFG = JaxConfig()
BODY_TOL = dict(rtol=1e-5, atol=1e-6)
ATOL_HEAD = 1e-6


@functools.lru_cache(maxsize=None)
def _jparams(dtype="float32", seed=0):
    p = init_simgnn_params(jax.random.PRNGKey(seed), JCFG)
    if dtype == "bfloat16":
        p = jax.tree.map(lambda x: x.astype(jnp.bfloat16), p)
    return p


def _tparams(dtype="float32", seed=0):
    return params_from_numpy(jax.tree.map(np.asarray,
                                          _jparams(dtype, seed)), "cpu")


def _graphs(seed, n, max_n=40):
    rng = np.random.default_rng(seed)
    return [tgraphs.random_graph(rng, int(rng.integers(5, max_n)))
            for _ in range(n)]


def _queries(seed, n):
    stream = tgraphs.zipf_query_stream(seed, 2, n_corpus=16)
    return [next(stream)["query"] for _ in range(n)]


@contextlib.contextmanager
def _sites_seen(sites):
    """Records every site the armed seam sees, in order; the hook that
    fires stays `repro_torch.testing.faults`'."""
    armed = engine_mod._FAULT_HOOK

    def hook(site, thunk):
        sites.append(site)
        return armed(site, thunk)
    engine_mod._FAULT_HOOK = hook
    try:
        yield
    finally:
        engine_mod._FAULT_HOOK = armed


# ------------------------------------------------- generators, keys, cache

def test_zipf_generators_bit_identical_to_jax():
    for a, b in zip(tgraphs.zipf_corpus(3, 20),
                    jgraphs.zipf_corpus(3, 20)):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)
    ts, js = (m.zipf_query_stream(5, 6, n_corpus=12) for m in (tgraphs,
                                                                 jgraphs))
    for _ in range(3):
        t, j = next(ts), next(js)
        assert np.array_equal(t["corpus_idx"], j["corpus_idx"])
        assert t["unique_frac"] == j["unique_frac"]
        assert np.array_equal(t["query"]["adj"], j["query"]["adj"])


def test_graph_key_and_fingerprint_byte_equal_to_jax():
    fixed = {"adj": np.asarray([[0, 1, 0], [1, 0, 1], [0, 1, 0]], np.float32),
             "labels": np.asarray([0, 1, 2], np.int32)}
    assert tcache.graph_key(dict(fixed)).hex() == \
        "755be6bf1ea052fbbda850cc93286f88"
    for g in _graphs(1, 12) + tgraphs.zipf_corpus(2, 8):
        t = {"adj": g["adj"].copy(), "labels": g["labels"].copy()}
        j = {"adj": g["adj"].copy(), "labels": g["labels"].copy()}
        assert tcache.graph_key(t) == jcache.graph_key(j)
        assert tcache.graph_fingerprint(t) == jcache.graph_fingerprint(j)


def test_embedding_cache_copy_behaves_as_jax():
    """The same sequence of puts, gets and peeks (evictions and a key
    collision included) gives the same answers and counters."""
    def run(mod):
        c = mod.EmbeddingCache(3)
        log = []
        for i in range(5):
            c.put(bytes([i]), np.full(2, i, np.float32), (i,))
            log.append(c.get(bytes([max(0, i - 1)]), (max(0, i - 1),))
                       is not None)
        log.append(c.peek(bytes([4])) is not None)
        log.append(c.get(bytes([4]), ("other",)) is None)  # collision
        c.put(bytes([3]), np.zeros(2, np.float32), ("other",))
        log.append(bytes([3]) in c)
        return log, c.stats(), len(c)

    assert run(tcache) == run(jcache)
    with pytest.raises(ValueError):
        tcache.EmbeddingCache(-1)


# ------------------------------------------------------------------ store

def test_store_round_trip_corruption_and_fs_hook(tmp_path):
    m = np.arange(40, dtype=np.float32).reshape(10, 4)
    keys = [f"{i:02x}" for i in range(10)]
    tman = tstore.ShardStore(str(tmp_path / "t")).write(
        m, shard_rows=3, graph_keys=keys, meta={"x": 1})
    jman = jstore.ShardStore(str(tmp_path / "j")).write(
        m, shard_rows=3, graph_keys=keys, meta={"x": 1})
    assert tman == jman
    for name in [s["name"] for s in tman["shards"]] + ["manifest.json"]:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    store = tstore.ShardStore(str(tmp_path / "t"))
    back = np.concatenate([store.read_shard(i) for i in store.shard_infos()])
    assert back.tobytes() == m.tobytes()
    assert tstore.checksum(b"abc") == jstore.checksum(b"abc")
    victim = tmp_path / "t" / "shard_00001.bin"
    data = bytearray(victim.read_bytes())
    data[5] ^= 0x40
    victim.write_bytes(bytes(data))
    assert store.verify()["shard_00001.bin"] == "corrupt"
    with pytest.raises(tstore.StoreError):
        store.read_shard(store.shard_infos()[1])
    # The write seam: a torn shard and a lost manifest.
    with tfaults.fs_inject("store:shard", "torn"), \
            tfaults.fs_inject("store:manifest", "missing"):
        tstore.ShardStore(str(tmp_path / "torn")).write(m, shard_rows=5)
    with pytest.raises(tstore.ManifestError, match="no manifest"):
        tstore.ShardStore(str(tmp_path / "torn")).manifest()


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_tree_digest_equals_jax(dtype):
    assert tstore.tree_digest(_tparams(dtype)) == \
        jstore.tree_digest(_jparams(dtype))
    assert tstore.tree_digest(_tparams(dtype)) != \
        tstore.tree_digest(_tparams(dtype, seed=1))


# ----------------------------------------------------------- engine paths

def _check_plan(tp, jp):
    assert (tp.path, tp.fallback, tp.reason) == (jp.path, jp.fallback,
                                                 jp.reason)
    for f in ("fit_idx", "over_idx", "cached_idx", "to_embed_idx"):
        assert np.array_equal(getattr(tp, f), getattr(jp, f)), f
    assert tp.graph_keys == jp.graph_keys
    assert dataclasses.asdict(tp.stats) == dataclasses.asdict(jp.stats)
    assert (tp.degraded_from, tp.attempts) == (jp.degraded_from, jp.attempts)


@pytest.mark.parametrize("path", ("embedding_cache", "two_kernel"))
def test_cached_and_two_kernel_paths_match_jax(path):
    """Scores within the parity bound and the same plan on a cold call and
    on a warm one that mixes hits, misses and in-call duplicates."""
    shared, fresh = _graphs(10, 4), _graphs(11, 4)
    oversize = tgraphs.random_graph(np.random.default_rng(3), 70)
    pairs = (list(zip(shared, fresh)) + list(zip(fresh, shared))
             + [(shared[0], oversize), (shared[0], fresh[1])])
    jeng = JaxEngine(_jparams(), JCFG, path=path, planner="threshold")
    teng = ScoringEngine(_tparams(), CFG, path=path, device="cpu")
    for call in range(2):
        want, got = jeng.score(pairs), teng.score(pairs)
        _check_plan(teng.last_plan, jeng.last_plan)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32[path])
    if path == "embedding_cache":
        assert len(teng.last_plan.cached_idx) == 2 * len(pairs)
        assert teng.health()["cache"] == jeng.health()["cache"]
    assert teng.health()["counters"] == jeng.health()["counters"]


def test_auto_flips_to_the_cache_like_jax():
    rng = np.random.default_rng(15)
    corpus = _graphs(15, 8)
    pairs = [(tgraphs.random_graph(rng, 20), c) for c in corpus]
    jeng = JaxEngine(_jparams(), JCFG, planner="threshold")
    teng = ScoringEngine(_tparams(), CFG, device="cpu")
    _check_plan(teng.plan(pairs), jeng.plan(pairs))       # cold: packed
    for eng in (jeng, teng):
        np.asarray(eng.embed_graphs(corpus))
    np.testing.assert_allclose(teng.embed_graphs(corpus),
                               jeng.embed_graphs(corpus), **BODY_TOL)
    _check_plan(teng.plan(pairs), jeng.plan(pairs))
    assert teng.plan(pairs).path == "embedding_cache"
    np.testing.assert_allclose(teng.score(pairs), jeng.score(pairs),
                               rtol=0, atol=ATOL_F32["embedding_cache"])
    off = ScoringEngine(_tparams(), CFG, cache_size=0, device="cpu")
    off.embed_graphs(corpus)
    assert off.plan(pairs).path != "embedding_cache" and len(off.cache) == 0


@pytest.mark.parametrize("site,mode", (("embed", "raise"), ("embed", "nan"),
                                       ("head", "raise"), ("head", "nan")))
def test_cpu_fault_retries_match_jax(site, mode):
    """On the CPU a failing embed bucket or head is retried on the plain
    model, counted as the JAX engine counts it."""
    pairs = list(zip(_graphs(20, 5), _graphs(21, 5)))
    jeng = JaxEngine(_jparams(), JCFG, path="embedding_cache",
                     planner="threshold")
    teng = ScoringEngine(_tparams(), CFG, path="embedding_cache",
                         device="cpu")
    with faults.inject(site, mode=mode):
        want = jeng.score(pairs)
    with tfaults.inject(site, mode=mode):
        got = teng.score(pairs)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL_F32["embedding_cache"])
    assert teng.health()["counters"] == jeng.health()["counters"]
    _check_plan(teng.last_plan, jeng.last_plan)


def test_cpu_embed_bucket_dropped_when_both_embedders_fail():
    graphs = _graphs(22, 6, max_n=16)
    jeng = JaxEngine(_jparams(), JCFG, path="embedding_cache",
                     planner="threshold")
    teng = ScoringEngine(_tparams(), CFG, path="embedding_cache",
                         device="cpu")
    with faults.inject("embed"), faults.inject("embed_fallback"):
        want = jeng.embed_graphs(graphs)
    sites = []
    with tfaults.inject("embed"), tfaults.inject("embed_fallback"), \
            _sites_seen(sites):
        got = teng.embed_graphs(graphs)
    assert np.isnan(got).all() and np.isnan(want).all()
    assert teng.counters == jeng.counters
    assert teng.counters["embed_dropped_graphs"] == len(graphs)
    assert sites == ["embed", "embed_fallback"] * (len(sites) // 2)


# ---------------------------------------------------------- search server

@functools.lru_cache(maxsize=None)
def _servers(n_corpus: int = 96, seed: int = 40):
    corpus = tgraphs.zipf_corpus(seed, n_corpus)
    js = JaxServer(_jparams(), JCFG)
    ts = SimilaritySearchServer(_tparams(), CFG, device="cpu")
    return js, ts, js.index(corpus), ts.index(corpus), corpus


@pytest.mark.parametrize("mode", ("exact", "two_stage"))
def test_search_server_matches_jax(mode):
    js, ts, jemb, temb, _ = _servers()
    np.testing.assert_allclose(temb, jemb, **BODY_TOL)
    queries = _queries(41, 3)
    want = js.search(queries, k=10, mode=mode, prefilter_m=16)
    got = ts.search(queries, k=10, mode=mode, prefilter_m=16)
    for (gi, gs), (wi, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=ATOL_HEAD)
    jh, th = js.health(), ts.health()
    assert th["prefilter"]["proxy"] == jh["prefilter"]["proxy"]
    assert th["prefilter"]["block_cols"] == jh["prefilter"]["block_cols"]
    if mode == "two_stage":
        assert ts.engine.last_plan.reason == js.engine.last_plan.reason
        assert ts.engine.last_plan.prefilter_m == 16


def test_two_stage_at_m_equals_n_is_the_exact_scan():
    _, ts, _, _, _ = _servers()
    for q in _queries(43, 2):
        ei, es = ts.topk(q, k=10, mode="exact")
        ti, tsc = ts.topk(q, k=10, mode="two_stage", prefilter_m=96)
        np.testing.assert_array_equal(ei, ti)
        assert es.tobytes() == tsc.tobytes()
    big_k, _ = ts.topk(_queries(44, 1)[0], k=200, mode="two_stage")
    assert sorted(big_k.tolist()) == list(range(96))
    with pytest.raises(ValueError, match="mode"):
        ts.search(_queries(44, 1), mode="fuzzy")


@pytest.mark.parametrize("saved_by", ("jax", "port"))
def test_index_saved_by_one_package_loads_in_the_other(tmp_path, saved_by):
    js, ts, jemb, temb, corpus = _servers(12, 3)
    d = str(tmp_path / "index")
    src, emb = (js, jemb) if saved_by == "jax" else (ts, temb)
    man = src.save(d, shard_rows=4)
    assert man["meta"]["params_digest"] == tstore.tree_digest(_tparams())
    fresh = (SimilaritySearchServer(_tparams(), CFG, device="cpu")
             if saved_by == "jax" else JaxServer(_jparams(), JCFG))
    got = fresh.load(d, corpus)
    assert got.tobytes() == np.asarray(emb, np.float32).tobytes()
    assert fresh.stats.shards_loaded == 3 and fresh.stats.shards_recovered == 0
    if saved_by == "jax":
        assert fresh.corpus_dev.numpy().tobytes() == got.tobytes()
        q = _queries(4, 1)[0]
        np.testing.assert_array_equal(fresh.topk(q, k=5)[0],
                                      js.topk(q, k=5)[0])
    other = SimilaritySearchServer(_tparams(seed=1), CFG, device="cpu")
    with pytest.raises(tstore.StoreError, match="different model"):
        other.load(d, corpus)


def test_port_load_recovers_a_bad_shard(tmp_path):
    _, ts, _, temb, corpus = _servers(12, 3)
    d = tmp_path / "index"
    ts.save(str(d), shard_rows=4)
    (d / "shard_00001.bin").write_bytes(b"torn")
    fresh = SimilaritySearchServer(_tparams(), CFG, device="cpu")
    got = fresh.load(str(d), corpus)
    np.testing.assert_allclose(got, temb, **BODY_TOL)
    assert (fresh.stats.shards_loaded, fresh.stats.shards_recovered,
            fresh.stats.rows_reembedded) == (2, 1, 4)
    assert fresh.health()["counters"]["store_shard_corrupt"] == 1


@pytest.mark.parametrize("mode", ("raise", "nan"))
def test_prefilter_fault_degrades_to_exact_like_jax(mode):
    corpus = tgraphs.zipf_corpus(48, 48)
    js = JaxServer(_jparams(), JCFG)
    ts = SimilaritySearchServer(_tparams(), CFG, device="cpu")
    js.index(corpus)
    ts.index(corpus)
    queries = _queries(49, 3)
    exact = ts.search(queries, k=5, mode="exact")
    with faults.inject("prefilter", mode=mode):
        want = js.search(queries, k=5, mode="two_stage", prefilter_m=8)
    with tfaults.inject("prefilter", mode=mode):
        got = ts.search(queries, k=5, mode="two_stage", prefilter_m=8)
    for (gi, gs), (wi, _), (ei, es) in zip(got, want, exact):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gi, ei)
        assert gs.tobytes() == es.tobytes()
    assert ts.stats.prefilter_degraded == js.stats.prefilter_degraded == 3
    tc, jc = ts.engine.counters, js.engine.counters
    for key in ("prefilter_degraded", "errors:prefilter", "prefilter_calls"):
        assert tc[key] == jc[key], key
    assert ts.health()["prefilter"]["degraded"] == 3
