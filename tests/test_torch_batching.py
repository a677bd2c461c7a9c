"""Host-side data and packing of the PyTorch port against the JAX package:
`repro_torch.data.graphs` and `repro_torch.core.batching`.

Generators: the same seed gives the same graphs, bit for bit.

Packing: every index and layout plane of `pack_pairs(with_edges=True)` is
bit-equal to the JAX package's — adjacency, labels, masks, segment ids,
pair masks and indices, the ELL/COO sender and receiver planes and their
int16 dtype, edge masks — and so is the stats dict. The A' edge weights
are held within 2 ulp (rtol=2.5e-7, atol=0), not bit for bit: XLA's CPU
`lax.rsqrt`, which the JAX package's `normalized_adjacency` uses, is not
correctly rounded (over the integer degrees 1..256 in float32 it differs
from `torch.rsqrt` and `1/np.sqrt` by 1 ulp at 58 values, first 6, 7, 17
and 18, degrees AIDS-like graphs have), and each weight carries two such
factors.
"""

import functools

import numpy as np
import pytest
import torch

from repro.core import batching as jb
from repro.data import graphs as jg
from repro.kernels import ops as jops
from repro_torch.core import batching as tb
from repro_torch.data import graphs as tg
from repro_torch.kernels import ops as tops

#: 2 ulp of float32, relative (A' weights: one rsqrt rounding per factor).
WEIGHT_RTOL = 2.5e-7


@functools.lru_cache(maxsize=None)
def _parity_pairs(batch: int):
    """The parity-matrix streams (tests/test_parity_matrix.py)."""
    rng = np.random.default_rng(100 + batch)
    return tuple((tg.random_graph(rng, int(rng.integers(5, 65))),
                  tg.random_graph(rng, int(rng.integers(5, 65))))
                 for _ in range(batch))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(a, b, name):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), name


# ------------------------------------------------------------- generators

def _graphs_equal(g, h):
    assert g.keys() == h.keys()
    for k in g:
        _assert_same(g[k], h[k], k)


@pytest.mark.parametrize("seed", (0, 1, 7))
def test_generators_bit_identical_to_jax(seed):
    for a, b in zip(jg.query_pairs(seed, 24), tg.query_pairs(seed, 24)):
        _graphs_equal(a[0], b[0])
        _graphs_equal(a[1], b[1])
    for a, b in zip(jg.search_pairs(seed, 12, avg_degree=3.0),
                    tg.search_pairs(seed, 12, avg_degree=3.0)):
        _graphs_equal(a[0], b[0])
        _graphs_equal(a[1], b[1])
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    ga, gb = jg.random_graph(ra, 17), tg.random_graph(rb, 17)
    _graphs_equal(ga, gb)
    _graphs_equal(jg.edit_graph(ra, ga, 5), tg.edit_graph(rb, gb, 5))
    assert jg.ged_target(3, 10, 12) == tg.ged_target(3, 10, 12)


def test_pair_stream_matches_jax():
    ja = next(jg.pair_stream(3, 5))
    to = next(tg.pair_stream(3, 5, device="cpu"))
    _assert_same(ja["target"], to["target"], "target")
    assert ja["density"] == to["density"]
    assert ja["avg_degree"] == to["avg_degree"]
    for key in ("adj1", "feats1", "mask1", "adj2", "feats2", "mask2"):
        _assert_same(ja[key], to[key], key)
    for a, b in zip(ja["pairs"], to["pairs"]):
        _graphs_equal(a[0], b[0])
        _graphs_equal(a[1], b[1])


# ---------------------------------------------------------------- padding

def test_pad_graphs_and_bucket_pairs_equal():
    pairs = list(_parity_pairs(12))
    j = jb.pad_graphs([p[0] for p in pairs], 29, 64)
    t = tb.pad_graphs([p[0] for p in pairs], 29, 64, device="cpu")
    for name in ("feats", "adj", "mask", "n_nodes", "labels"):
        _assert_same(getattr(j, name), getattr(t, name), name)
    jbk = jb.bucket_pairs(pairs, 29, allow_oversize=True)
    tbk = tb.bucket_pairs(pairs, 29, allow_oversize=True, device="cpu")
    assert list(jbk) == list(tbk)
    for b in jbk:
        _assert_same(jbk[b][2], tbk[b][2], "idxs")
        for side in (0, 1):
            for name in ("feats", "adj", "mask", "n_nodes", "labels"):
                _assert_same(getattr(jbk[b][side], name),
                             getattr(tbk[b][side], name), name)
    for n in (1, 8, 9, 33, 64, 65, 130, 300):
        assert jb.bucket_for(n, allow_oversize=True) == tb.bucket_for(
            n, allow_oversize=True)
    with pytest.raises(ValueError):
        tb.bucket_for(65)


# ---------------------------------------------------------------- packing

def _overflow_pairs():
    """Dense-ish graphs (degree ~6) so a D=4 budget spills to the COO list."""
    rng = np.random.default_rng(5)
    return tuple((tg.random_graph(rng, int(rng.integers(20, 40)),
                                  avg_degree=6.0),
                  tg.random_graph(rng, int(rng.integers(20, 40)),
                                  avg_degree=6.0)) for _ in range(9))


PACK_CASES = {
    "batch7": (lambda: _parity_pairs(7), "ladder"),
    "batch12": (lambda: _parity_pairs(12), "ladder"),
    "spill": (_overflow_pairs, 4 * 64),
    "auto_budget": (lambda: _parity_pairs(12), None),
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_pairs_with_edges_matches_jax(case):
    make, budget = PACK_CASES[case]
    pairs = list(make())
    if budget == "ladder":
        deg = float(np.mean([g["avg_degree"] for p in pairs for g in p]))
        budget = jops.packed_edge_budget(64, deg)
        assert budget == tops.packed_edge_budget(64, deg)
    kw = dict(slots_per_tile=16, with_edges=True, edge_budget=budget)
    jp, js = jb.pack_pairs(pairs, 64, **kw)
    tp, ts = tb.pack_pairs(pairs, 64, device="cpu", **kw)
    assert js == ts
    for name in ("adj1", "labels1", "mask1", "seg1", "adj2", "labels2",
                 "mask2", "seg2", "pair_mask", "pair_index"):
        _assert_same(getattr(jp, name), getattr(tp, name), name)
    for part in ("edges1", "edges2", "overflow1", "overflow2"):
        je, te = getattr(jp.edges, part), getattr(tp.edges, part)
        for name in ("senders", "receivers", "edge_mask"):
            _assert_same(getattr(je, name), getattr(te, name),
                         f"{part}.{name}")
        assert _np(te.senders).dtype == np.int16
        np.testing.assert_allclose(_np(te.weights), _np(je.weights),
                                   rtol=WEIGHT_RTOL, atol=0)
        assert ((_np(te.weights) != 0) == (_np(je.weights) != 0)).all()
    if case == "spill":
        assert ts["overflow_budget"] > 8 and ts["nnz_lhs"] > 0
        assert int(_np(tp.edges.overflow1.edge_mask).sum()) > 0


def test_packed_pair_edges_on_packed_batch_matches_pack():
    """`packed_pair_edges` on an edge-less packed batch gives the planes
    `pack_pairs(with_edges=True)` builds, on the batch's device."""
    pairs = list(_parity_pairs(12))
    plain, _ = tb.pack_pairs(pairs, 64, slots_per_tile=16, device="cpu")
    full, _ = tb.pack_pairs(pairs, 64, slots_per_tile=16, with_edges=True,
                            edge_budget=256, device="cpu")
    edges = tb.packed_pair_edges(plain, 256)
    for part in ("edges1", "edges2", "overflow1", "overflow2"):
        for a, b in zip(getattr(edges, part), getattr(full.edges, part)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tb.packed_pair_edges(plain, 100)


def test_pack_pairs_without_slots_and_oversize_error():
    pairs = list(_parity_pairs(7))
    jp, js = jb.pack_pairs(pairs, 64)
    tp, ts = tb.pack_pairs(pairs, 64, device="cpu")
    assert js == ts
    _assert_same(jp.pair_index, tp.pair_index, "pair_index")
    rng = np.random.default_rng(0)
    big = [(tg.random_graph(rng, 70), tg.random_graph(rng, 10))]
    with pytest.raises(ValueError, match="node_budget"):
        tb.pack_pairs(big, 64, device="cpu")


def test_unpack_pair_scores_matches_jax():
    pairs = list(_parity_pairs(12))
    jp, _ = jb.pack_pairs(pairs, 64, slots_per_tile=16)
    tp, _ = tb.pack_pairs(pairs, 64, slots_per_tile=16, device="cpu")
    scores = np.random.default_rng(0).random(
        tp.pair_mask.shape).astype(np.float32)
    _assert_same(jb.unpack_pair_scores(scores, jp, len(pairs)),
                 tb.unpack_pair_scores(torch.from_numpy(scores), tp,
                                       len(pairs)), "unpacked")


def test_shape_policies_match_jax():
    for n in (0, 1, 3, 8, 9, 100, 1000):
        for floor in (1, 2, 8, 12):
            assert jb.next_pow2(n, floor) == tb.next_pow2(n, floor)
    for deg in (None, 1.5, 2.0, 2.5, 3.5, 4.5, 6.0, 11.5, 40.0, 100.0):
        assert (jops.packed_edge_budget(64, deg)
                == tops.packed_edge_budget(64, deg))
    # Half-way degrees round up: 1.5 -> 4, 2.5 -> 6, 3.5 -> 6, 4.5 -> 8.
    assert [tops.packed_edge_budget(64, d) // 64
            for d in (1.5, 2.5, 3.5, 4.5)] == [4, 6, 6, 8]
    for m in (1, 8, 33, 64, 65, 200):
        assert jops.packed_node_budget(m) == tops.packed_node_budget(m)
