"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same CUDA inputs. Every test here needs a CUDA device (the
`cuda` fixture skips without one, so on a CPU-only machine the whole file
skips); run them on the card with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package: the port's CPU tests
hold the plain versions against the JAX kernels, and these tests hold the
CUDA kernels against the plain versions. Bounds are the parity matrix's
(tests/test_parity_matrix.py): 1e-6 for the packed kernels, 2e-5 for the
bucketed one, on post-sigmoid scores.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.simgnn_aids import CONFIG
from repro_torch.core import batching
from repro_torch.core.engine import ScoringEngine
from repro_torch.core.simgnn import SimGNNConfig, init_simgnn_params
from repro_torch.data.graphs import edit_graph, query_pairs, random_graph
from repro_torch.kernels.fused_pair import (fused_pair_score,
                                            fused_pair_score_plain)
from repro_torch.kernels.packed_pair import (packed_pair_score,
                                             packed_pair_score_plain)
from repro_torch.kernels.sparse_pair import (sparse_pair_score,
                                             sparse_pair_score_plain)

ATOL_PACKED = 1e-6
ATOL_BUCKETED = 2e-5
NARROW = SimGNNConfig(gcn_dims=(16, 8, 8, 4))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _params(cfg=CONFIG, dtype="float32", device="cuda"):
    p = init_simgnn_params(torch.Generator().manual_seed(0),
                           cfg._replace(dtype=dtype), device=device)
    return p["gcn"], p["att"]["w"], p["ntn"], p["fcn"]


def _packed(dev, n_pairs=40, edge_budget=None, pad_to=1):
    """Sparse-kernel and dense-kernel argument lists of one packed batch,
    padded to a multiple of `pad_to` tiles with all-pad tiles."""
    pairs = query_pairs(3, n_pairs)
    packed, _ = batching.pack_pairs(pairs, 64, slots_per_tile=16,
                                    with_edges=True, edge_budget=edge_budget,
                                    device=dev)
    e = packed.edges
    sparse = (e.edges1.senders, e.edges1.weights, e.overflow1.senders,
              e.overflow1.receivers, e.overflow1.weights, packed.labels1,
              packed.mask1, packed.seg1, e.edges2.senders, e.edges2.weights,
              e.overflow2.senders, e.overflow2.receivers, e.overflow2.weights,
              packed.labels2, packed.mask2, packed.seg2, packed.pair_mask)
    dense = (packed.adj1, packed.labels1, packed.mask1, packed.seg1,
             packed.adj2, packed.labels2, packed.mask2, packed.seg2,
             packed.pair_mask)

    def pad(xs):
        extra = (-packed.mask1.shape[0]) % pad_to
        return [torch.cat([x, x.new_zeros((extra,) + x.shape[1:])])
                for x in xs]
    return pad(sparse), pad(dense), packed.mask1.shape[0]


def _check(kern, plain, arrays, weights, atol):
    before = kern.launches
    got = kern(*arrays, *weights)
    want = plain(*arrays, *weights)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= atol, err
    return got


CASES = {"main": ({}, CONFIG, "float32"),
         "overflow_d2": ({"edge_budget": 128}, CONFIG, "float32"),
         "pad_tiles": ({"pad_to": 8}, CONFIG, "float32"),
         "narrow": ({}, NARROW, "float32"),
         "bf16": ({}, CONFIG, "bfloat16")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_pair_kernel_matches_plain(cuda, case):
    kw, cfg, dtype = CASES[case]
    sparse, _, live = _packed(cuda, **kw)
    got = _check(sparse_pair_score, sparse_pair_score_plain, sparse,
                 _params(cfg, dtype), ATOL_PACKED)
    assert (got[live:] == 0).all()
    if case == "overflow_d2":
        assert (sparse[4] != 0).any()


@pytest.mark.parametrize("case", ("main", "pad_tiles", "narrow", "bf16"))
def test_packed_pair_kernel_matches_plain(cuda, case):
    kw, cfg, dtype = CASES[case]
    _, dense, live = _packed(cuda, **kw)
    got = _check(packed_pair_score, packed_pair_score_plain, dense,
                 _params(cfg, dtype), ATOL_PACKED)
    assert (got[live:] == 0).all()


@pytest.mark.parametrize("cfg", (CONFIG, NARROW), ids=("aids", "narrow"))
def test_fused_pair_kernel_matches_plain_every_bucket(cuda, cfg):
    rng = np.random.default_rng(4)
    pairs = [(random_graph(rng, n), random_graph(rng, m))
             for n, m in ((6, 5), (12, 9), (30, 17), (60, 64), (7, 3))]
    big = random_graph(rng, 130)
    pairs.append((big, edit_graph(rng, big, 3)))    # oversize: bucket 256
    buckets = batching.bucket_pairs(pairs, CONFIG.n_node_labels,
                                    allow_oversize=True, device=cuda)
    assert sorted(buckets) == [8, 16, 32, 64, 256]
    for lhs, rhs, _ in buckets.values():
        _check(fused_pair_score, fused_pair_score_plain,
               [lhs.adj, lhs.feats, lhs.mask, rhs.adj, rhs.feats, rhs.mask],
               _params(cfg), ATOL_BUCKETED)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    sparse, dense, _ = _packed(cuda)
    weights = _params()
    wide = list(sparse)
    wide[0] = wide[0].int()                      # int32 ELL plane
    with pytest.raises(ValueError, match="int16"):
        sparse_pair_score(*wide, *weights)
    strided = list(dense)
    strided[0] = strided[0].transpose(1, 2)      # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        packed_pair_score(*strided, *weights)
    deep = SimGNNConfig(gcn_dims=(8,) * 9)       # 9 GCN layers > 8
    with pytest.raises(ValueError, match="GCN"):
        sparse_pair_score(*sparse, *_params(deep))
    before = sparse_pair_score.launches
    empty = [x[:0] for x in sparse]
    assert sparse_pair_score(*empty, *weights).shape == (0, 16)
    assert sparse_pair_score.launches == before


def test_engine_on_the_card_raises_when_every_kernel_fails(cuda):
    """On the card the ladder ends at its last kernel rung: with every
    kernel rung failing the engine raises, and the plain reference is
    never asked for scores."""
    from repro_torch.core import engine as engine_mod

    p = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    card = ScoringEngine(p, CONFIG, device=cuda)
    sites = []

    def hook(site, thunk):
        sites.append(site)
        raise RuntimeError(f"injected fault at {site}")

    engine_mod._FAULT_HOOK = hook
    try:
        with pytest.raises(RuntimeError, match="bucketed_mega"):
            card.score(query_pairs(5, 64))
    finally:
        engine_mod._FAULT_HOOK = None
    assert sites == ["packed_sparse", "packed_dense", "bucketed_mega"]
    assert card.health()["counters"] == {
        "errors:packed_sparse": 1, "errors:packed_dense": 1,
        "errors:bucketed_mega": 1}


def test_engine_on_the_card_matches_the_cpu_engine(cuda):
    p = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    pairs = query_pairs(5, 64)
    card = ScoringEngine(p, CONFIG, device=cuda)
    host = ScoringEngine(p, CONFIG, device="cpu")
    before = sparse_pair_score.launches
    got, want = card.score(pairs), host.score(pairs)
    plan = card.last_plan
    assert plan.path == "packed_sparse" and plan.reason == host.last_plan.reason
    assert plan.degraded_from == () and plan.attempts == 1
    assert sparse_pair_score.launches == before + 1
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_PACKED)
