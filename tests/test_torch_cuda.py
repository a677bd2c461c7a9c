"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same CUDA inputs. Every test here needs a CUDA device (the
`cuda` fixture skips without one, so on a CPU-only machine the whole file
skips); run them on the card with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package: the port's CPU tests
hold the plain versions against the JAX kernels, and these tests hold the
CUDA kernels against the plain versions. Bounds are the parity matrix's
(tests/test_parity_matrix.py): 1e-6 for the packed kernels, 2e-5 for the
bucketed one, on post-sigmoid scores; embeddings and top-M scores rtol
1e-5 / atol 1e-6 (float32 sums in another order), head scores 1e-6,
top-M indices exact on inputs whose score gaps are wider than that.
The MoE expert kernel: float32 rtol 1e-5 / atol 1e-6 (the JAX kernel
sweep's bound) at the model's weight scale; bfloat16 one bf16 ulp of the
value plus that float32 bound (both sides round one float32 sum once).
The wkv6 and mamba scans: rtol 1e-4 / atol 1e-5, flash attention rtol
2e-4 / atol 2e-5 (the JAX kernel sweeps' bounds, tests/test_kernels.py);
outputs rounded to bfloat16 within one bf16 ulp plus that bound. bf16
calls of the expert FFN and of flash attention run the tensor-core
(wgmma) kernels, float32 calls the FMA bodies; both are held to the same
bounds.
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.configs.simgnn_aids import CONFIG
from repro_torch.core import batching
from repro_torch.core.engine import ScoringEngine
from repro_torch.core.gcn import normalized_adjacency
from repro_torch.core.simgnn import SimGNNConfig, init_simgnn_params
from repro_torch.data.graphs import (edit_graph, query_pairs, random_graph,
                                     search_pairs, zipf_corpus,
                                     zipf_query_stream)
from repro_torch.kernels import build, retrieval
from repro_torch.kernels.fused_gcn import fused_gcn_att, fused_gcn_att_plain
from repro_torch.kernels.fused_pair import (fused_pair_score,
                                            fused_pair_score_plain)
from repro_torch.kernels.packed_pair import (packed_pair_score,
                                             packed_pair_score_plain)
from repro_torch.kernels.simgnn_head import simgnn_head, simgnn_head_plain
from repro_torch.kernels.sparse_pair import (sparse_pair_score,
                                             sparse_pair_score_plain)
from repro_torch.serve.search import SimilaritySearchServer
from repro_torch.configs import reduced_config
from repro_torch.kernels import flash_attn as flash_mod
from repro_torch.kernels import moe_experts as moe_kernel_mod
from repro_torch.kernels.flash_attn import (flash_attention,
                                            flash_attention_plain,
                                            flash_attention_plan)
from repro_torch.kernels.mamba_scan import (
    mamba_scan_plan, mamba_selective_scan, mamba_selective_scan_plain,
    mamba_selective_scan_state, mamba_selective_scan_state_plain)
from repro_torch.kernels.moe_experts import (moe_expert_ffn,
                                             moe_expert_ffn_plain,
                                             moe_expert_ffn_plan)
from repro_torch.kernels.wkv6 import (wkv6, wkv6_plain, wkv6_plan,
                                      wkv6_state, wkv6_state_plain)
from repro_torch.models import moe as tmoe
from repro_torch.models.init import init_params as init_lm_params
from repro_torch.params import params_to
from repro_torch.serve.step import greedy_generate
from repro_torch.testing import faults

ATOL_PACKED = 1e-6
ATOL_BUCKETED = 2e-5
ATOL_HEAD = 1e-6
BODY_TOL = dict(rtol=1e-5, atol=1e-6)
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


def _packed(dev, n_pairs=40, edge_budget=None, pad_to=1, overflow_budget=8):
    """Sparse-kernel and dense-kernel argument lists of one packed batch,
    padded to a multiple of `pad_to` tiles with all-pad tiles."""
    pairs = query_pairs(3, n_pairs)
    packed, _ = batching.pack_pairs(pairs, 64, slots_per_tile=16,
                                    with_edges=True, edge_budget=edge_budget,
                                    overflow_budget=overflow_budget,
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


def _interleave_pad_tiles(arrays, before):
    """`arrays` with an all-pad tile inserted before each tile in
    `before`."""
    out = []
    for x in arrays:
        parts, last = [], 0
        for i in before:
            parts += [x[last:i], torch.zeros_like(x[:1])]
            last = i
        out.append(torch.cat(parts + [x[last:]]).contiguous())
    return out


def test_sparse_pair_all_pad_clusters_between_live_ones(cuda):
    """Both CTAs of a pad tile's cluster leave before any cluster barrier;
    the live clusters around them score as the plain version does."""
    sparse, _, live = _packed(cuda)
    arrays = _interleave_pad_tiles(sparse, (0, 1, 2, live))
    got = _check(sparse_pair_score, sparse_pair_score_plain, arrays,
                 _params(), ATOL_PACKED)
    pad = arrays[16].sum(-1) == 0
    assert pad.sum() == 4 and (got[pad] == 0).all()
    everything_pad = [torch.zeros_like(x[:3]) for x in sparse]
    assert (sparse_pair_score(*everything_pad, *_params()) == 0).all()
    # pair slots masked out whose nodes stay masked in: the kernel pools
    # their slots too, for the Att weights of those nodes
    dead = list(sparse)
    dead[16] = dead[16].clone()
    dead[16][::2, 0] = 0.0
    got = _check(sparse_pair_score, sparse_pair_score_plain, dead,
                 _params(), ATOL_PACKED)
    assert (got[::2, 0] == 0).all()


@pytest.mark.parametrize("t", (1, 2, 3))
def test_sparse_pair_few_tiles(cuda, t):
    sparse, _, _ = _packed(cuda)
    _check(sparse_pair_score, sparse_pair_score_plain,
           [x[:t].contiguous() for x in sparse], _params(), ATOL_PACKED)


@pytest.mark.parametrize("edge_budget,e_ov", [(None, 64), (None, 128),
                                               (128, 128)],
                         ids=("d_auto-64", "d_auto-128", "d2-128"))
def test_sparse_pair_wide_overflow_lists(cuda, edge_budget, e_ov):
    sparse, _, _ = _packed(cuda, edge_budget=edge_budget,
                           overflow_budget=e_ov)
    assert sparse[2].shape[-1] == e_ov
    _check(sparse_pair_score, sparse_pair_score_plain, sparse, _params(),
           ATOL_PACKED)


@pytest.mark.parametrize("where", ("w1", "att", "ntn"))
@pytest.mark.parametrize("value", (float("nan"), float("inf")))
def test_sparse_pair_non_finite_weights_sit_where_plain_puts_them(
        cuda, where, value):
    """On live pair slots the kernel's NaNs are where the plain version's
    are; pad slots stay 0 in the kernel (the plain version multiplies a
    NaN score by the zero pair mask)."""
    sparse, _, _ = _packed(cuda, edge_budget=128)
    gcn, att, ntn, fcn = _params()
    gcn = [dict(x) for x in gcn]
    ntn = dict(ntn)
    if where == "w1":
        label = int(sparse[5][0, 0])
        gcn[0]["w"] = gcn[0]["w"].clone()
        gcn[0]["w"][label, 3] = value
    elif where == "att":
        att = att.clone()
        att[4, 4] = value
    else:
        ntn["w"] = ntn["w"].clone()
        ntn["w"][3, 5, 6] = value
    weights = (gcn, att, ntn, fcn)
    got = sparse_pair_score(*sparse, *weights)
    want = sparse_pair_score_plain(*sparse, *weights)
    torch.cuda.synchronize()
    live = sparse[16] != 0
    if value != value:
        assert torch.isnan(got[live]).any()
    torch.testing.assert_close(got[live], want[live], rtol=0,
                               atol=ATOL_PACKED, equal_nan=True)
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("kw", ({}, {"edge_budget": 128,
                                     "overflow_budget": 128}),
                         ids=("served_like", "spill"))
def test_sparse_pair_launches_with_its_plan(cuda, kw):
    from repro_torch.kernels.fused_gcn import device_limits
    from repro_torch.kernels.sparse_pair import max_clusters, sparse_pair_plan

    sparse, _, _ = _packed(cuda, **kw)
    sparse_pair_score(*sparse, *_params())
    t, e = sparse[0].shape
    head = (CONFIG.ntn_k,) + tuple(CONFIG.fcn_dims) + (1,)
    plan = sparse_pair_plan(t, 64, e // 64, sparse[2].shape[-1], 16,
                            CONFIG.feature_dims,
                            *device_limits(cuda.index or 0), head=head)
    assert sparse_pair_score.last_plan == plan
    assert plan.grid == 2 * t and plan.ctas_per_sm == 2
    assert max_clusters(plan) >= t


@pytest.mark.parametrize("case", ("main", "pad_tiles", "narrow", "bf16"))
def test_packed_pair_kernel_matches_plain(cuda, case):
    kw, cfg, dtype = CASES[case]
    _, dense, live = _packed(cuda, **kw)
    got = _check(packed_pair_score, packed_pair_score_plain, dense,
                 _params(cfg, dtype), ATOL_PACKED)
    assert (got[live:] == 0).all()


def _dense_traffic(dev, case):
    """Dense-kernel arrays of 40 pairs of average degree 8 ("deg8", the
    traffic the engine routes to packed_dense), of `_packed`'s AIDS-like
    batch with every adjacency a random 0/1 matrix over all cells
    ("rewired": not block-diagonal), or of its first tile ("t1")."""
    if case == "deg8":
        packed, _ = batching.pack_pairs(search_pairs(5, 40, avg_degree=8.0),
                                        64, slots_per_tile=16, device=dev)
        return [packed.adj1, packed.labels1, packed.mask1, packed.seg1,
                packed.adj2, packed.labels2, packed.mask2, packed.seg2,
                packed.pair_mask]
    _, dense, _ = _packed(dev)
    if case == "t1":
        return [x[:1].contiguous() for x in dense]
    gen = torch.Generator().manual_seed(5)
    for s in (0, 4):
        cells = torch.rand(dense[s].shape, generator=gen) < 0.4
        dense[s] = (cells.triu(1) | cells.triu(1).transpose(1, 2)).to(
            dev, torch.float32)
    return dense


@pytest.mark.parametrize("case", ("deg8", "rewired", "t1"))
def test_packed_pair_kernel_matches_plain_on_dense_traffic(cuda, case):
    _check(packed_pair_score, packed_pair_score_plain,
           _dense_traffic(cuda, case), _params(), ATOL_PACKED)
    assert packed_pair_score.last_plan.route == "cluster"


@pytest.mark.parametrize("where", ("w1_label0", "ntn"))
def test_packed_pair_kernel_keeps_the_plain_versions_nan(cuda, where):
    """NaN weights: the live slots' NaN and values as the plain version's.
    Pad slots are exact zeros from the kernel (as from the one-CTA kernel
    before it), where the plain version's score * pair_mask gives NaN * 0;
    `unpack_pair_scores` reads only live slots."""
    _, dense, _ = _packed(cuda)
    gcn, att, ntn, fcn = _params()
    if where == "ntn":
        ntn = dict(ntn, w=ntn["w"].clone())
        ntn["w"][3, 5, 6] = float("nan")
    else:                     # label 0: the pad rows' W1 row too
        gcn = [dict(layer) for layer in gcn]
        gcn[0]["w"] = gcn[0]["w"].clone()
        gcn[0]["w"][0, 5] = float("nan")
    got = packed_pair_score(*dense, gcn, att, ntn, fcn)
    want = packed_pair_score_plain(*dense, gcn, att, ntn, fcn)
    torch.cuda.synchronize()
    live = dense[8] != 0
    assert torch.isnan(got[live]).any()
    torch.testing.assert_close(got[live], want[live], rtol=0,
                               atol=ATOL_PACKED, equal_nan=True)
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("head", ("aids", "ntn_k40"))
def test_packed_pair_launches_with_its_plan(cuda, head):
    from repro_torch.kernels.fused_gcn import device_limits
    from repro_torch.kernels.packed_pair import max_clusters, packed_pair_plan

    cfg = CONFIG if head == "aids" else CONFIG._replace(ntn_k=40)
    _, dense, _ = _packed(cuda)
    _check(packed_pair_score, packed_pair_score_plain, dense, _params(cfg),
           ATOL_PACKED)
    t = dense[0].shape[0]
    plan = packed_pair_plan(t, 64, 16, cfg.feature_dims,
                            *device_limits(cuda.index or 0),
                            head=(cfg.ntn_k,) + tuple(cfg.fcn_dims) + (1,))
    assert packed_pair_score.last_plan == plan
    if head == "aids":
        assert plan.route == "cluster" and plan.grid == 2 * t
        assert plan.ctas_per_sm == 2 and max_clusters(plan) >= t
    else:                     # the head's weights fit no cluster layout
        assert plan.route == "single" and plan.grid == t


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


def _fused_buckets(dev, pairs) -> dict:
    """Bucket -> `fused_pair_score` arrays of `pairs`, bucketed as the
    engine buckets them."""
    return {k: [lhs.adj, lhs.feats, lhs.mask, rhs.adj, rhs.feats, rhs.mask]
            for k, (lhs, rhs, _) in batching.bucket_pairs(
                pairs, CONFIG.n_node_labels, allow_oversize=True,
                device=dev).items()}


@pytest.mark.parametrize("b", (1, 2, 3, 2048))
def test_fused_pair_kernel_matches_plain_by_call_size(cuda, b):
    buckets = _fused_buckets(cuda, query_pairs(1, 256))
    for k in ((16, 32, 64) if b < 4 else (32,)):
        arrays = buckets[k]
        reps = -(-b // arrays[0].shape[0])
        arrays = [torch.cat([x] * reps)[:b].contiguous() for x in arrays]
        _check(fused_pair_score, fused_pair_score_plain, arrays, _params(),
               ATOL_BUCKETED)


@pytest.mark.parametrize("bucket", (8, 16, 32, 64, 128, 256, 512))
def test_fused_pair_kernel_matches_plain_at_every_bucket(cuda, bucket):
    size = {8: 5, 16: 12, 32: 25, 64: 50, 128: 100, 256: 130,
            512: 300}[bucket]
    rng = np.random.default_rng(bucket)
    g = random_graph(rng, size)
    pairs = [(g, edit_graph(rng, g, 3)),
             (random_graph(rng, max(3, size // 2)), g)]
    buckets = _fused_buckets(cuda, pairs)
    assert list(buckets) == [bucket]
    _check(fused_pair_score, fused_pair_score_plain, buckets[bucket],
           _params(), ATOL_BUCKETED)
    route = fused_pair_score.last_plan.route
    assert route == ("single" if bucket == 512 else "cluster"), route


def test_fused_pair_kernel_matches_plain_with_holes_in_the_masks(cuda):
    arrays = [x.clone() for x in _fused_buckets(cuda, query_pairs(1, 256))[64]]
    arrays[2][:, 3::7] = 0.0
    arrays[5][:, 1::5] = 0.0
    _check(fused_pair_score, fused_pair_score_plain, arrays, _params(),
           ATOL_BUCKETED)


@pytest.mark.parametrize("bucket", (32, 64))
def test_fused_pair_kernel_matches_plain_with_bf16_params(cuda, bucket):
    arrays = _fused_buckets(cuda, query_pairs(1, 256))[bucket]
    _check(fused_pair_score, fused_pair_score_plain, arrays,
           _params(dtype="bfloat16"), ATOL_BUCKETED)


@pytest.mark.parametrize("where", ("w0", "w1", "att", "ntn"))
def test_fused_pair_kernel_puts_nan_where_the_plain_version_does(cuda,
                                                                 where):
    arrays = _fused_buckets(cuda, query_pairs(1, 256))[64]
    gcn, att, ntn, fcn = _params()
    gcn = [dict(layer) for layer in gcn]
    ntn = dict(ntn)
    if where == "att":
        att = att.clone()
        att[4, 4] = float("nan")
    elif where == "ntn":
        ntn["w"] = ntn["w"].clone()
        ntn["w"][3, 5, 6] = float("nan")
    else:
        layer = int(where[-1])
        gcn[layer]["w"] = gcn[layer]["w"].clone()
        gcn[layer]["w"][int(arrays[1][0, 0].argmax()) if layer == 0 else 5,
                        3] = float("nan")
    got = fused_pair_score(*arrays, gcn, att, ntn, fcn)
    want = fused_pair_score_plain(*arrays, gcn, att, ntn, fcn)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert nan.any() and torch.equal(torch.isnan(got), nan)
    diff = (got[~nan] - want[~nan]).abs()
    assert diff.numel() == 0 or float(diff.max()) <= ATOL_BUCKETED


def test_fused_pair_launches_with_its_plan(cuda):
    from repro_torch.kernels.fused_pair import max_clusters, plan_for

    buckets = _fused_buckets(cuda, query_pairs(1, 256))
    weights = _params()
    for k, b in ((64, None), (64, 1), (32, 1), (32, None)):
        arrays = [x[:b].contiguous() for x in buckets[k]]
        pairs = arrays[0].shape[0]
        fused_pair_score(*arrays, *weights)
        plan = plan_for(pairs, k, arrays[1].shape[-1], *weights, cuda)
        assert fused_pair_score.last_plan == plan
        assert plan.route == "cluster" and plan.grid == plan.cluster * pairs
        assert max_clusters(plan) >= 1
    assert plan_for(1, 64, 29, *weights, cuda).cluster == 8


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
    p = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    card = ScoringEngine(p, CONFIG, device=cuda)
    sites = []
    with faults.inject("packed_sparse"), faults.inject("packed_dense"), \
            faults.inject("bucketed_mega"), _sites_seen(sites):
        with pytest.raises(RuntimeError, match="bucketed_mega"):
            card.score(query_pairs(5, 64))
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


# ------------------------------------------------ slice 2: search kernels

def _embed_inputs(dev, sizes, bucket, seed=6):
    """A', one-hot feats and mask of graphs of `sizes` nodes padded to
    `bucket`, on `dev`."""
    rng = np.random.default_rng(seed)
    batch = batching.pad_graphs([random_graph(rng, n) for n in sizes],
                                CONFIG.n_node_labels, bucket, device=dev)
    return normalized_adjacency(batch.adj, batch.mask), batch.feats, batch.mask


@pytest.mark.parametrize("cfg", (CONFIG, NARROW), ids=("aids", "narrow"))
def test_fused_gcn_kernel_matches_plain_every_bucket(cuda, cfg):
    gcn, att, _, _ = _params(cfg)
    for bucket, sizes in ((8, (5, 8, 3)), (16, (9, 16)), (32, (17, 30, 25)),
                          (64, (33, 64, 40)), (128, (70, 128)),
                          (256, (130,))):
        arrays = _embed_inputs(cuda, sizes, bucket)
        before = fused_gcn_att.launches
        got = fused_gcn_att(*arrays, gcn, att)
        want = fused_gcn_att_plain(*arrays, gcn, att)
        torch.cuda.synchronize()
        assert fused_gcn_att.launches == before + 1
        assert got.shape == (len(sizes), cfg.gcn_dims[-1])
        torch.testing.assert_close(got, want, **BODY_TOL)


def test_fused_gcn_embedding_bit_identical_across_batch_and_bucket(cuda):
    """The cache's contract: a graph's embedding is the same bits whatever
    its batch companions and whatever bucket it is padded to."""
    gcn, att, _, _ = _params()
    rng = np.random.default_rng(8)
    g = random_graph(rng, 20)
    others = [random_graph(rng, int(n)) for n in rng.integers(5, 33, 11)]
    rows = []
    for bucket, batch, at in ((32, [g], 0),
                              (32, others[:5] + [g] + others[5:], 5),
                              (64, others[:3] + [g], 3),
                              (256, [g] + others, 0)):
        padded = batching.pad_graphs(batch, CONFIG.n_node_labels, bucket,
                                     device=cuda)
        a = normalized_adjacency(padded.adj, padded.mask)
        out = fused_gcn_att(a, padded.feats, padded.mask, gcn, att)
        rows.append(out[at].cpu())
    for r in rows[1:]:
        assert torch.equal(r, rows[0])


def _check_gcn(arrays, gcn, att, equal_nan=False):
    before = fused_gcn_att.launches
    got = fused_gcn_att(*arrays, gcn, att)
    want = fused_gcn_att_plain(*arrays, gcn, att)
    torch.cuda.synchronize()
    assert fused_gcn_att.launches == before + 1
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, equal_nan=equal_nan, **BODY_TOL)
    return got


@pytest.mark.parametrize("b", (1, 7, 131, 133, 5 * 132 + 3))
def test_fused_gcn_persistent_grid_covers_every_graph(cuda, b):
    """Batches below, at and past the grid: the persistent loop's ragged
    last round and CTAs that get no graph (the card has 132 SMs)."""
    gcn, att, _, _ = _params()
    rng = np.random.default_rng(b)
    sizes = [int(x) for x in rng.integers(3, 33, b)]
    _check_gcn(_embed_inputs(cuda, sizes, 32, seed=b), gcn, att)


@pytest.mark.parametrize("gcn_dims", ((128, 64, 32), (16, 8, 8, 4), (32,),
                                      (24, 20, 16, 12, 10, 8, 6, 5),
                                      (256, 256)),
                         ids=("aids", "narrow", "one_layer", "eight_layers",
                              "wide"))
@pytest.mark.parametrize("bucket", (16, 64, 256))
def test_fused_gcn_widths_off_the_register_tile(cuda, gcn_dims, bucket):
    """F0 = 29 and widths that are not multiples of the 4-column tile, one
    and eight layers, on the shared and the scratch route; "wide" has more
    weights than a block's shared memory, which the kernel then reads from
    global memory."""
    gcn, att, _, _ = _params(SimGNNConfig(gcn_dims=gcn_dims))
    sizes = {16: (9, 16, 13), 64: (33, 64, 47), 256: (130, 200)}[bucket]
    _check_gcn(_embed_inputs(cuda, sizes, bucket), gcn, att)


@pytest.mark.parametrize("where", ("weight", "bias", "att", "adjacency"))
def test_fused_gcn_nan_sits_where_the_plain_version_puts_it(cuda, where):
    gcn, att, _, _ = _params()
    gcn = [dict(p) for p in gcn]
    arrays = list(_embed_inputs(cuda, (20, 7, 31), 32))
    if where == "weight":
        gcn[1]["w"] = gcn[1]["w"].clone()
        gcn[1]["w"][5, 3] = float("nan")
    elif where == "bias":
        gcn[2]["b"] = gcn[2]["b"].clone()
        gcn[2]["b"][7] = float("nan")
    elif where == "att":
        att = att.clone()
        att[2, 9] = float("nan")
    else:
        arrays[0] = arrays[0].clone()
        arrays[0][1, 2, 3] = float("nan")      # one graph's A' only
    got = _check_gcn(arrays, gcn, att, equal_nan=True)
    assert torch.isnan(got).any()
    if where == "adjacency":
        assert torch.isnan(got[1]).all() and torch.isfinite(got[[0, 2]]).all()


@pytest.mark.parametrize("case", ("aids", "narrow", "bf16"))
def test_simgnn_head_kernel_matches_plain(cuda, case):
    cfg = NARROW if case == "narrow" else CONFIG
    _, _, ntn, fcn = _params(cfg, "bfloat16" if case == "bf16" else
                             "float32")
    rng = np.random.default_rng(9)
    f = cfg.gcn_dims[-1]
    for b in (1, 7, 1001):
        h1, h2 = (rng.standard_normal((b, f)).astype(np.float32)
                  for _ in range(2))
        h2[b // 2] = np.nan                 # a dropped embedding scores NaN
        h1, h2 = torch.from_numpy(h1).to(cuda), torch.from_numpy(h2).to(cuda)
        before = simgnn_head.launches
        got = simgnn_head(h1, h2, ntn, fcn)
        want = simgnn_head_plain(h1, h2, ntn, fcn)
        torch.cuda.synchronize()
        assert simgnn_head.launches == before + 1 and got.shape == (b,)
        assert torch.isnan(got[b // 2])
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL_HEAD,
                                   equal_nan=True)


@pytest.mark.parametrize("cfg,b", ((CONFIG, 1), (CONFIG, 256),
                                   (CONFIG, 4096), (CONFIG, 8193),
                                   (NARROW, 1001)),
                         ids=("aids1", "aids256", "aids4096", "aids8193",
                              "narrow"))
def test_simgnn_head_launches_with_its_plan(cuda, cfg, b):
    """The wrapper launches the plan's route, grid and block: the tiled
    kernel for SimGNN-AIDS (the runtime holds the CTAs an SM the plan
    counts on), PR 12's one-warp-a-pair kernel for the narrow F = 4."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.fused_gcn import device_limits
    from repro_torch.kernels.simgnn_head import occupancy, plan_for

    _, _, ntn, fcn = _params(cfg)
    f = cfg.gcn_dims[-1]
    h1, h2 = (torch.randn((b, f), device=cuda) for _ in range(2))
    plan = plan_for(b, f, ntn, fcn, cuda)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        simgnn_head(h1, h2, ntn, fcn)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "simgnn_head" in e.key]
    assert simgnn_head.last_plan == plan
    if cfg is CONFIG:
        assert plan.route == "tiled" and plan.threads == 256
        sms, _ = device_limits(cuda.index or 0)
        assert plan.grid == min(plan.tiles, sms * plan.ctas_per_sm)
        assert occupancy(plan) >= plan.ctas_per_sm
        assert names and all("simgnn_head_tiled_kernel" in n for n in names)
    else:
        assert plan.route == "warp" and plan.grid == -(-b // 8)
        assert names and all("simgnn_head_tiled" not in n for n in names)


def test_simgnn_head_pair_bits_do_not_depend_on_batch_or_position(cuda):
    """A pair's score is a function of its two rows alone: scored alone,
    at every position of a 257-pair batch and inside B = 8192 (other
    tiles, other plans) it is the same bits."""
    _, _, ntn, fcn = _params()
    rng = np.random.default_rng(12)
    a, b = (torch.from_numpy(rng.standard_normal((1, 32)).astype(np.float32))
            .to(cuda) for _ in range(2))
    alone = simgnn_head(a, b, ntn, fcn)
    fill = [torch.from_numpy(rng.standard_normal((257, 32))
                             .astype(np.float32)).to(cuda) for _ in range(2)]
    for pos in range(257):
        h1, h2 = fill[0].clone(), fill[1].clone()
        h1[pos], h2[pos] = a[0], b[0]
        got = simgnn_head(h1, h2, ntn, fcn)[pos:pos + 1]
        assert torch.equal(got.view(torch.int32), alone.view(torch.int32))
    big = [torch.randn((8192, 32), device=cuda) for _ in range(2)]
    for pos in (0, 31, 32, 4095, 8191):
        big[0][pos], big[1][pos] = a[0], b[0]
    got = simgnn_head(big[0], big[1], ntn, fcn)
    for pos in (0, 31, 32, 4095, 8191):
        assert torch.equal(got[pos:pos + 1].view(torch.int32),
                           alone.view(torch.int32))


@pytest.mark.parametrize("b", (33, 1001, 8192))
def test_simgnn_head_takes_views_off_16_byte_alignment(cuda, b):
    """h1/h2 one element past a 16-byte boundary stage with 4-byte copies:
    the plain version's scores, and the aligned inputs' bits."""
    _, _, ntn, fcn = _params()
    h1, h2 = (torch.randn((b, 32), device=cuda) for _ in range(2))

    def off(x):
        flat = torch.empty(x.numel() + 1, device=cuda)
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)

    o1, o2 = off(h1), off(h2)
    assert o1.data_ptr() % 16 == 4 and o1.is_contiguous()
    got = simgnn_head(o1, o2, ntn, fcn)
    torch.testing.assert_close(got, simgnn_head_plain(h1, h2, ntn, fcn),
                               rtol=0, atol=ATOL_HEAD)
    assert torch.equal(got.view(torch.int32),
                       simgnn_head(h1, h2, ntn, fcn).view(torch.int32))
    assert torch.equal(simgnn_head(h1, o2, ntn, fcn).view(torch.int32),
                       got.view(torch.int32))


def _topm_case(dev, case):
    """(qv, corpus, m, block_cols) of one top-M case, on `dev`."""
    rng = np.random.default_rng(10)
    q, n, m, block = {"small": (5, 137, 10, 32), "m1": (5, 137, 1, 32),
                      "m_eq_n": (5, 137, 137, 32),
                      "m_over_block": (5, 137, 100, 32),
                      "nan_rows": (3, 40, 40, 16), "all_nan": (3, 8, 8, 8),
                      "ties": (4, 300, 50, 64),
                      "main": (64, 8192, 64, 256),
                      "served_m_eq_n": (1, 8192, 8192, 256),
                      "q1": (1, 8192, 64, 256), "q65": (65, 8192, 64, 256),
                      "f4": (64, 8192, 64, 256), "f64": (64, 8192, 64, 256),
                      "inf_rows": (6, 500, 100, 64),
                      "neg_zero_rows": (5, 300, 200, 64),
                      "unaligned": (64, 8192, 64, 256)}[case]
    f = {"f4": 4, "f64": 64}.get(case, 32)
    qv = rng.standard_normal((q, f)).astype(np.float32)
    corpus = rng.standard_normal((n, f)).astype(np.float32)
    if case in EXACT_TOPM_CASES:
        # small integers: every sum is exact in any order, so the plain
        # version's scores are the kernel's and ties are exact ties
        qv, corpus = (rng.integers(-2, 3, x.shape).astype(np.float32)
                      for x in (qv, corpus))
    if case == "nan_rows":
        corpus[[4, 17, 31]] = np.nan
    if case == "all_nan":
        corpus[:] = np.nan
    if case == "ties":
        corpus[100:200] = corpus[:100]         # exact duplicate rows
    if case == "inf_rows":
        corpus[[3, 70, 71, 400]] = np.inf
        corpus[[5, 250], 7] = -np.inf
    if case == "neg_zero_rows":
        # Each product of these rows underflows to a zero of its sign, so a
        # score is -0 or +0 by the sign of its last product: ties by index.
        qv = rng.choice(np.float32([-0.375, -0.25, -0.125, 0.125, 0.25,
                                     0.375]), qv.shape)
        tiny = np.float32(1.4e-45)
        corpus[::3] = np.where(rng.random((len(corpus[::3]), f)) < 0.5,
                               -tiny, tiny)
    qt, ct = torch.from_numpy(qv).to(dev), torch.from_numpy(corpus).to(dev)
    if case == "unaligned":                  # one float past 16 bytes
        flat = torch.empty(ct.numel() + 1, device=dev)
        flat[1:] = ct.reshape(-1)
        ct = flat[1:].view(ct.shape)
        assert ct.data_ptr() % 16 == 4
    return qt, ct, m, block


TOPM_CASES = ("small", "m1", "m_eq_n", "m_over_block", "nan_rows",
              "all_nan", "ties", "main", "served_m_eq_n", "q1", "q65", "f4",
              "f64", "inf_rows", "neg_zero_rows", "unaligned")
#: cases on small-integer (dyadic) data and, for the NTN scan, weights of
#: -1, 0 and 1: exact in float32, so even M = N is held index for index
EXACT_TOPM_CASES = TOPM_CASES[8:]


def _check_topm(got, want):
    torch.cuda.synchronize()
    (gs, gi), (ws, wi) = got, want
    assert gs.shape == ws.shape and gi.dtype == torch.int32
    assert torch.equal(gi.cpu(), wi.cpu())
    torch.testing.assert_close(gs, ws, **BODY_TOL)
    assert torch.isfinite(gs).all()


@pytest.mark.parametrize("case", TOPM_CASES)
def test_topm_dot_kernel_matches_plain(cuda, case):
    qv, corpus, m, block = _topm_case(cuda, case)
    before = retrieval.blocked_topm.launches
    got = retrieval.blocked_topm(qv, corpus, m, block_cols=block)
    assert retrieval.blocked_topm.launches == before + 1
    _check_topm(got,
                retrieval.blocked_topm_plain(qv, corpus, min(m, len(corpus))))


@pytest.mark.parametrize("case", TOPM_CASES)
def test_topm_ntn_kernel_matches_plain(cuda, case):
    qv, corpus, m, block = _topm_case(cuda, case)
    f = qv.shape[1]
    p = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG if f == 32
                           else SimGNNConfig(gcn_dims=(64, f)))
    if case in EXACT_TOPM_CASES:
        p = {part: ({k: torch.sign(t) for k, t in p[part].items()}
                    if part == "ntn" else
                    [{k: torch.sign(t) for k, t in layer.items()}
                     for layer in p[part]]) for part in ("ntn", "fcn")}
    uq, dq = (torch.from_numpy(x).to(cuda) for x in
              retrieval.collapse_query_ntn(p["ntn"], qv.cpu().numpy()))
    fcn = [{k: t.to(cuda) for k, t in layer.items()} for layer in p["fcn"]]
    before = retrieval.blocked_topm_ntn.launches
    got = retrieval.blocked_topm_ntn(uq, dq, corpus, fcn, m,
                                     block_cols=block)
    assert retrieval.blocked_topm_ntn.launches == before + 1
    _check_topm(got, retrieval.blocked_topm_ntn_plain(uq, dq, corpus, fcn,
                                                      min(m, len(corpus))))


def test_topm_records_its_plan_and_runs_one_select_launch(cuda):
    """The served shape runs the select route (one launch of clusters of 8,
    no per-block lists), M = N the sort route; a select launch is the one
    kernel `topm_select_kernel`, bit-identical to the sort route."""
    qv, corpus, m, block = _topm_case(cuda, "main")
    got = retrieval.blocked_topm(qv, corpus, m, block_cols=block)
    plan = retrieval.blocked_topm.last_plan
    assert plan.route == "select" and plan.cluster == 8
    assert plan.grid == (128,) and plan.list_entries == 0
    assert retrieval.max_clusters(plan, 32) >= 16
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        retrieval.blocked_topm(qv, corpus, m, block_cols=block)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if getattr(e, "device_time_total",
                        getattr(e, "cuda_time_total", 0)) > 0]
    assert [k for k in names if "topm" in k] and all(
        "topm_select_kernel" in k for k in names if "topm" in k), names
    sort = retrieval.topm_plan(64, 8192, 32, m, block,
                               *retrieval.device_limits(0), route="sort")
    want = [torch.empty_like(x) for x in got]
    retrieval.launch(sort, qv.data_ptr(), corpus.data_ptr(), 64, 8192, 32,
                     m, *want)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    retrieval.blocked_topm(qv[:1], corpus, 8192, block_cols=block)
    assert retrieval.blocked_topm.last_plan.route == "sort"


def test_topm_ntn_records_its_plan_and_runs_one_select_launch(cuda):
    """The served NTN scan (the AIDS head at (64, 8192, 64, block 256)) runs
    the select route: one launch of `topm_ntn_select_kernel` (one query a
    CTA, clusters of 2, no per-block lists), bit-identical to the sort
    route's two passes; M above the cap takes the sort route."""
    qv, corpus, m, block = _topm_case(cuda, "main")
    p = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    uq, dq = (torch.from_numpy(x).to(cuda) for x in
              retrieval.collapse_query_ntn(p["ntn"], qv.cpu().numpy()))
    fcn = [{k: t.to(cuda) for k, t in layer.items()} for layer in p["fcn"]]
    before = retrieval.blocked_topm_ntn.launches
    got = retrieval.blocked_topm_ntn(uq, dq, corpus, fcn, m,
                                     block_cols=block)
    assert retrieval.blocked_topm_ntn.launches == before + 1
    plan = retrieval.blocked_topm_ntn.last_plan
    assert plan.route == "select" and plan.scoring == "ntn_served"
    assert (plan.grid, plan.cluster, plan.queries) == ((128,), 2, 1)
    assert plan.list_entries == 0
    assert retrieval.max_clusters(plan, 32) * plan.cluster >= plan.grid[0]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        retrieval.blocked_topm_ntn(uq, dq, corpus, fcn, m, block_cols=block)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if getattr(e, "device_time_total",
                        getattr(e, "cuda_time_total", 0)) > 0]
    topm = [k for k in names if "topm" in k]
    assert topm and all("topm_ntn_select_kernel" in k for k in topm), names
    assert sum(e.count for e in prof.key_averages()
               if "topm_ntn_select_kernel" in e.key) == 1
    dims = (16, 8, 4, 1)
    sort = retrieval.topm_ntn_plan(64, 8192, 32, dims, m, block,
                                   *retrieval.device_limits(0), route="sort")
    params, _keep = build.simgnn_params({"fcn": fcn}, uq.device)
    want = [torch.empty_like(x) for x in got]
    retrieval.launch_ntn(sort, uq.data_ptr(), dq.data_ptr(),
                         corpus.data_ptr(), 64, 8192, 32, 16, m, params,
                         *want)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    retrieval.blocked_topm_ntn(uq, dq, corpus, fcn, 257, block_cols=block)
    assert retrieval.blocked_topm_ntn.last_plan.route == "sort"


def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    gcn, att, ntn, fcn = _params()
    a, feats, mask = _embed_inputs(cuda, (5, 8), 8)
    with pytest.raises(ValueError, match="contiguous"):
        fused_gcn_att(a.transpose(1, 2), feats, mask, gcn, att)
    with pytest.raises(ValueError, match="float32"):
        fused_gcn_att(a.double(), feats, mask, gcn, att)
    h = torch.zeros((4, 32), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        simgnn_head(h.half(), h, ntn, fcn)
    with pytest.raises(ValueError, match="mixed"):
        simgnn_head(h, h.cpu(), ntn, fcn)
    with pytest.raises(ValueError, match="contiguous"):
        retrieval.blocked_topm(h, torch.zeros((32, 64), device=cuda).T, 2)
    with pytest.raises(ValueError, match="RETRIEVAL_MAX_BLOCK_COLS"):
        retrieval.blocked_topm(h, h, 2, block_cols=2048)
    before = retrieval.blocked_topm.launches
    s, i = retrieval.blocked_topm(h[:0], h, 2)
    assert s.shape == i.shape == (0, 0)
    assert retrieval.blocked_topm.launches == before


@contextlib.contextmanager
def _sites_seen(sites):
    """Records every site the armed seam sees, in order; the hook that
    fires stays `repro_torch.testing.faults`'."""
    from repro_torch.core import engine as engine_mod

    armed = engine_mod._FAULT_HOOK

    def hook(site, thunk):
        sites.append(site)
        return armed(site, thunk)
    engine_mod._FAULT_HOOK = hook
    try:
        yield
    finally:
        engine_mod._FAULT_HOOK = armed


@pytest.mark.parametrize("mode", ("raise", "nan"))
def test_engine_on_the_card_raises_when_the_head_fails(cuda, mode):
    """No plain head stands in for the head kernel on the card: the head
    raises, and a cached-path call steps down to the bucketed kernel."""
    p = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    card = ScoringEngine(p, CONFIG, path="embedding_cache", device=cuda)
    h = torch.randn((6, CONFIG.gcn_dims[-1]), device=cuda)
    pairs = query_pairs(5, 16)
    with faults.inject("head", mode=mode):
        with pytest.raises(RuntimeError):
            card.pair_scores_from_embeddings(h, h)
        out = card.score(pairs)
    plan = card.last_plan
    assert plan.degraded_from == ("embedding_cache",)
    assert np.isfinite(out).all()
    assert card.counters["errors:head"] == 2
    assert "errors:head_fallback" not in card.counters


def test_engine_on_the_card_drops_a_failed_embed_bucket(cuda):
    """A failing embed bucket is dropped as NaN rows and counted; no plain
    embedder retries it on the card."""
    p = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    card = ScoringEngine(p, CONFIG, path="embedding_cache", device=cuda)
    graphs = zipf_corpus(3, 24)
    with faults.inject("embed"):
        emb = card.embed_graphs(graphs)
    assert np.isnan(emb).all()
    c = card.counters
    assert c["embed_dropped_graphs"] == len(graphs)
    assert c["errors:embed"] >= 1 and c["embed_fallbacks"] == 0
    assert len(card.cache) == 0


def test_search_on_the_card_matches_the_cpu_server(cuda):
    p = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    corpus = zipf_corpus(40, 300)
    stream = zipf_query_stream(41, 2, n_corpus=16)
    queries = [next(stream)["query"] for _ in range(4)]
    card = SimilaritySearchServer(p, CONFIG, device=cuda)
    host = SimilaritySearchServer(p, CONFIG, device="cpu")
    np.testing.assert_allclose(card.index(corpus), host.index(corpus),
                               **BODY_TOL)
    for mode in ("exact", "two_stage"):
        got = card.search(queries, k=10, mode=mode, prefilter_m=32)
        want = host.search(queries, k=10, mode=mode, prefilter_m=32)
        for (gi, gs), (wi, ws) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gs, ws, rtol=0, atol=ATOL_HEAD)
    ei, es = card.topk(queries[0], k=10)
    ti, ts = card.topk(queries[0], k=10, mode="two_stage", prefilter_m=300)
    np.testing.assert_array_equal(ei, ti)
    assert es.tobytes() == ts.tobytes()
    assert card.stats.prefilter_degraded == 0
    assert not [k for k in card.engine.counters if k.startswith("errors:")]


# ------------------------------------------------------------ moe_experts

MOE_CASES = {
    # (B or None for [E, C, D], E, C, D, F, dtype)
    "prefill_bf16": (4, 40, 129, 1536, 512, torch.bfloat16),
    "decode_bf16": (4, 40, 8, 1536, 512, torch.bfloat16),
    "prefill_f32": (4, 40, 129, 1536, 512, torch.float32),
    "odd_f32": (3, 7, 13, 200, 36, torch.float32),
    "odd_bf16": (3, 7, 13, 200, 36, torch.bfloat16),
    "rank3_f32": (None, 5, 21, 64, 32, torch.float32),
    # bf16 tile edges of the tensor-core kernels: B*C of 1, 32 and 33 (the
    # swapped tiles end at 32 rows), 63, 65 and 516 (64-row tiles), D and F
    # off the 64-deep stages and the 16-byte chunks, rank-3 x
    "bc1_bf16": (1, 3, 1, 200, 36, torch.bfloat16),
    "bc32_bf16": (4, 3, 8, 200, 36, torch.bfloat16),
    "bc33_bf16": (3, 3, 11, 200, 36, torch.bfloat16),
    "bc63_bf16": (None, 4, 63, 200, 36, torch.bfloat16),
    "bc65_bf16": (5, 3, 13, 200, 36, torch.bfloat16),
    "bc516_bf16": (4, 3, 129, 200, 36, torch.bfloat16),
    "aligned_bf16": (2, 3, 40, 264, 136, torch.bfloat16),
    "rank3_bf16": (None, 5, 21, 64, 32, torch.bfloat16),
}


def _moe_inputs(dev, b, e, c, d, f, dtype, seed=0):
    """x ~ N(0, 1) (an RMS-normed activation), weights at the model's
    init scale (0.02, and 0.02 / sqrt(32 layers) for W_out)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lead = () if b is None else (b,)
    x = torch.randn(lead + (e, c, d), device=dev, generator=g)
    w_in = torch.randn((e, d, 2 * f), device=dev, generator=g) * 0.02
    w_out = torch.randn((e, f, d), device=dev, generator=g) * 0.0035
    return x.to(dtype), w_in.to(dtype), w_out.to(dtype)


def _bf16_bound(want):
    _, ex = torch.frexp(want.float().abs())
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), ex - 8)
    return ulp + BODY_TOL["atol"] + BODY_TOL["rtol"] * want.float().abs()


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_expert_kernel_matches_plain(cuda, case):
    b, e, c, d, f, dtype = MOE_CASES[case]
    x, w_in, w_out = _moe_inputs(cuda, b, e, c, d, f, dtype)
    before = moe_expert_ffn.launches
    got = moe_expert_ffn(x, w_in, w_out)
    want = moe_expert_ffn_plain(x, w_in, w_out)
    torch.cuda.synchronize()
    assert moe_expert_ffn.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **BODY_TOL)
    else:
        excess = (got.float() - want.float()).abs() - _bf16_bound(want)
        assert float(excess.max()) <= 0


def test_moe_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, w_in, w_out = _moe_inputs(cuda, 2, 4, 5, 64, 32, torch.float32)
    with pytest.raises(ValueError, match="mixed"):
        moe_expert_ffn(x, w_in.cpu(), w_out)
    with pytest.raises(ValueError, match="ranks"):
        moe_expert_ffn(x[0, 0], w_in, w_out)
    with pytest.raises(ValueError, match="ranks"):
        moe_expert_ffn(x[None], w_in, w_out)
    with pytest.raises(ValueError, match="disagree"):
        moe_expert_ffn(x, w_in[:3], w_out)
    with pytest.raises(ValueError, match="one dtype"):
        moe_expert_ffn(x, w_in.bfloat16(), w_out)
    with pytest.raises(ValueError, match="one dtype"):
        moe_expert_ffn(x.double(), w_in.double(), w_out.double())
    with pytest.raises(ValueError, match="multiples of 4"):
        moe_expert_ffn(x[..., :62], w_in[:, :62], w_out[..., :62])
    with pytest.raises(ValueError, match="contiguous"):
        moe_expert_ffn(x.transpose(0, 1).contiguous().transpose(0, 1),
                       w_in, w_out)
    before = moe_expert_ffn.launches
    assert moe_expert_ffn(x[:, :, :0], w_in, w_out).shape == (2, 4, 0, 64)
    assert moe_expert_ffn.launches == before


def test_moe_kernel_failure_raises_and_nothing_falls_back(cuda):
    """Shapes whose smallest row tile does not fit in shared memory make
    the launch fail: the wrapper raises, counts no launch, and the model
    layer raises too (no plain version stands in on the card)."""
    d, f = 14000, 1000
    x, w_in, w_out = _moe_inputs(cuda, 1, 1, 2, d, f, torch.float32)
    before = moe_expert_ffn.launches
    with pytest.raises(RuntimeError, match="moe_expert_ffn launch failed"):
        moe_expert_ffn(x, w_in, w_out)
    assert moe_expert_ffn.launches == before
    cfg = reduced_config("granite-moe-3b-a800m").with_(
        moe_use_kernel=True, d_model=d, d_ff_expert=f, n_experts=2, top_k=1)
    g = torch.Generator(device=cuda).manual_seed(1)
    p = {"router": torch.randn((d, 2), device=cuda, generator=g),
         "w_in": torch.randn((2, d, 2 * f), device=cuda, generator=g) * 0.02,
         "w_out": torch.randn((2, f, d), device=cuda, generator=g) * 0.02}
    with pytest.raises(RuntimeError, match="moe_expert_ffn launch failed"):
        tmoe.moe_ffn(p, torch.randn((1, 3, d), device=cuda, generator=g),
                     cfg)


def _kernel_names(fn, calls=5) -> set:
    """Names of the CUDA kernels that calls of `fn` launched, from
    `torch.profiler` (over several calls: the trace can drop a launch's
    record)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {ev.key for ev in prof.key_averages()
            if getattr(ev, "device_time_total",
                       getattr(ev, "cuda_time_total", 0)) > 0}


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("c", (8, 129), ids=("decode", "prefill"))
def test_moe_bf16_runs_the_tensor_cores_and_f32_the_fma_body(cuda, dtype, c):
    """bf16 takes the two wgmma launches (swapped tiles at B*C <= 32),
    float32 the FMA body; the plan, the profiler's kernel names and the
    launch count (one per call) agree."""
    x, w_in, w_out = _moe_inputs(cuda, 4, 3, c, 256, 128, dtype)
    plan = moe_expert_ffn_plan(x, w_in, w_out)
    names = _kernel_names(lambda: moe_expert_ffn(x, w_in, w_out))
    wgmma = dtype == torch.bfloat16
    assert plan["path"] == ("wgmma" if wgmma else "fma")
    assert plan["swapped"] == (wgmma and 4 * c <= 32)
    want = [s["kernel"] for s in plan["launches"]]
    assert want == (["moe_up_wgmma_kernel", "moe_down_wgmma_kernel"] if wgmma
                    else ["moe_expert_ffn_kernel"])
    for kernel in want:
        assert any(kernel in n for n in names), (kernel, names)
    other = "moe_expert_ffn_kernel" if wgmma else "wgmma"
    assert not any(other in n for n in names), names
    before = moe_expert_ffn.launches
    moe_expert_ffn(x, w_in, w_out)
    assert moe_expert_ffn.launches == before + 1


@pytest.mark.parametrize("arch", ("granite-moe-3b-a800m",
                                  "phi3.5-moe-42b-a6.6b"))
def test_lm_on_the_card_matches_the_cpu(cuda, arch):
    """A reduced float32 MoE model served with the kernel on the card and
    with the plain version on the CPU: the same greedy tokens, one launch
    per MoE layer and step."""
    cfg = reduced_config(arch).with_(moe_use_kernel=True)
    host = init_lm_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    before = moe_expert_ffn.launches
    got = greedy_generate(params_to(host, cuda), cfg, prompt, max_new=5)
    launched = moe_expert_ffn.launches - before
    want = greedy_generate(host, cfg, prompt, max_new=5, device="cpu")
    assert launched == 5 * cfg.n_layers
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# ------------------------------------------- wkv6, flash_attn, mamba_scan

SCAN_TOL = dict(rtol=1e-4, atol=1e-5)
FLASH_TOL = dict(rtol=2e-4, atol=2e-5)


def _excess(got, want, tol):
    """max(|got - want| - (one bf16 ulp of want + the float32 bound));
    <= 0 passes."""
    want = want.float()
    _, ex = torch.frexp(want.abs())
    ulp = torch.ldexp(torch.ones_like(want), ex - 8)
    bound = ulp + tol["atol"] + tol["rtol"] * want.abs()
    return float(((got.float() - want).abs() - bound).max())


def _randn(g, shape, dev, scale=1.0):
    return torch.randn(shape, device=dev, generator=g) * scale


WKV_CASES = {  # (B, T, H, K, V): ragged time blocks, padded K, odd V
    "odd": (3, 37, 5, 24, 40),
    "head64": (2, 40, 4, 64, 64),
    "widest": (1, 9, 2, 128, 256),
    "tiny": (2, 1, 3, 5, 3),
    # around the time block of K = 64 (TB 32 in bf16, 16 in float32)
    "tb_less_1": (2, 31, 4, 64, 64),
    "tb": (2, 32, 4, 64, 64),
    "tb_plus_1": (2, 33, 4, 64, 64),
    "two_tb_plus_1": (2, 65, 4, 64, 64),
    # V not a multiple of the CTA's VB columns (32 here; 16 for V = 3)
    "v40_vb32": (2, 20, 80, 64, 40),
    "v3_long": (1, 70, 2, 16, 3),
    # bf16 rows of 10 and 24 bytes: staged by plain loads
    "k5": (2, 40, 3, 5, 16),
    "k12": (2, 45, 3, 12, 24),
    "one_head": (1, 50, 1, 64, 64),
    "served_decode": (4, 1, 64, 64, 64),
}


def _wkv_inputs(dev, b, t, h, kd, vd, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k = (_randn(g, (b, t, h, kd), dev, 0.5) for _ in range(2))
    v = _randn(g, (b, t, h, vd), dev, 0.5)
    w = torch.sigmoid(_randn(g, (b, t, h, kd), dev))
    u = _randn(g, (h, kd), dev, 0.1)
    s0 = _randn(g, (b, h, kd, vd), dev, 0.5)
    return [x.to(dtype) for x in (r, k, v)] + [w, u, s0]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_wkv6_kernel_matches_plain(cuda, case, dtype):
    """o and the final state, from a zero and from a given state; the JAX
    entry `wkv6` rounds o to r's dtype."""
    r, k, v, w, u, s0 = _wkv_inputs(cuda, *WKV_CASES[case], dtype)
    for init in (None, s0):
        before = wkv6_state.launches
        got_o, got_s = wkv6_state(r, k, v, w, u, init)
        want_o, want_s = wkv6_state_plain(r, k, v, w, u, init)
        torch.cuda.synchronize()
        assert wkv6_state.launches == before + 1
        assert got_o.dtype == torch.float32 and got_s.dtype == torch.float32
        torch.testing.assert_close(got_o, want_o, **SCAN_TOL)
        torch.testing.assert_close(got_s, want_s, **SCAN_TOL)
    got, want = wkv6(r, k, v, w, u), wkv6_plain(r, k, v, w, u)
    assert got.dtype == dtype and got.shape == v.shape
    assert _excess(got, want.float(), SCAN_TOL) <= 0


def test_wkv6_state_carries_across_calls(cuda):
    """Two launches with the state handed over equal one launch over the
    whole sequence (decode's use of the kernel at T = 1)."""
    r, k, v, w, u, _ = _wkv_inputs(cuda, 2, 20, 3, 16, 16, torch.float32)
    whole_o, whole_s = wkv6_state(r, k, v, w, u)
    head, tail = ([x[:, sl].contiguous() for x in (r, k, v, w)]
                  for sl in (slice(0, 19), slice(19, None)))
    o1, s1 = wkv6_state(*head, u)
    o2, s2 = wkv6_state(*tail, u, s1)
    torch.testing.assert_close(torch.cat([o1, o2], 1), whole_o, **SCAN_TOL)
    torch.testing.assert_close(s2, whole_s, **SCAN_TOL)


def test_wkv6_plan_stages_the_served_shape_asynchronously(cuda):
    """The served shapes (rwkv6-7b, B 4, H 64, K = V 64, bf16) stage rows
    by cp.async in 32-step blocks over at least 512 CTAs, prefill and
    decode alike; rows that are not whole 16-byte chunks take plain loads;
    the edge cases above do cross a column block."""
    for t in (512, 1):
        plan = wkv6_plan(4, t, 64, 64, 64, torch.bfloat16)
        assert plan["route"] == "async" and plan["ctas"] >= 512, plan
        assert plan["tb"] == 32, plan
        assert plan["threads"] * plan["cols_per_thread"] == 4 * plan["vb"]
    assert wkv6_plan(4, 512, 64, 64, 64, torch.float32)["route"] == "async"
    for shape in (WKV_CASES["k5"], WKV_CASES["k12"], WKV_CASES["tiny"]):
        assert wkv6_plan(*shape, torch.bfloat16)["route"] == "plain", shape
    for case in ("v40_vb32", "v3_long"):
        b, t, h, kd, vd = WKV_CASES[case]
        plan = wkv6_plan(b, t, h, kd, vd, torch.float32)
        assert vd % plan["vb"] != 0, (case, plan)
    assert wkv6_plan(*WKV_CASES["one_head"], torch.float32)["ctas"] > 1


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
def test_wkv6_column_split_does_not_mix_columns(cuda, dtype):
    """A column's output and state depend on no other column: the first 32
    columns of o and sT from a V = 32 call equal, bit for bit, those of a
    V = 64 call on the same r, k, w, u and the first 32 columns of v and
    s0 (on an H100's 132 SMs the two calls take 16 and 32 columns a
    CTA)."""
    r, k, v, w, u, s0 = _wkv_inputs(cuda, 4, 70, 64, 64, 64, dtype)
    for init in (None, s0):
        wide_o, wide_s = wkv6_state(r, k, v, w, u, init)
        narrow_o, narrow_s = wkv6_state(
            r, k, v[..., :32].contiguous(), w, u,
            None if init is None else init[..., :32].contiguous())
        assert torch.equal(narrow_o, wide_o[..., :32])
        assert torch.equal(narrow_s, wide_s[..., :32])


MAMBA_CASES = {  # (B, T, Din, N)
    "odd": (2, 45, 200, 16),
    "small_n": (1, 33, 70, 5),
    "widest_n": (3, 20, 130, 32),
    # around the time block (TB 32): full blocks, a ragged last block
    "tb_less_1": (2, 31, 256, 16),
    "tb": (2, 32, 256, 16),
    "tb_plus_1": (2, 33, 256, 16),
    "two_tb_plus_1": (2, 65, 256, 16),
    # Din not a multiple of the CTA's 128 channels, rows still 16-byte
    "din_not_ch": (2, 40, 8200, 16),
    # rows of 140 (bf16) and 280 (float32) bytes: staged by plain loads
    "din70_plain_rows": (2, 40, 70, 16),
    # N 8 and 12: float4 state rows under n < N predicates; N 5: scalar
    # state rows, B and C by plain loads; N 20: NMAX 32
    "n8": (2, 50, 192, 8),
    "n5_async_rows": (2, 40, 256, 5),
    "n12": (2, 33, 96, 12),
    "n20": (1, 35, 64, 20),
    "b1": (1, 40, 192, 16),
    "served_decode": (2, 1, 16384, 16),
}
# Every operand a view that starts one element past a 16-byte boundary:
# the launch takes plain loads and scalar state rows for such pointers.
MAMBA_UNALIGNED_CASES = {
    "unaligned": (2, 70, 256, 16),
    "unaligned_decode": (2, 1, 16384, 16),
    "unaligned_n8_plain_rows": (2, 40, 70, 8),
}


def _off16(z):
    """z's values in a view that starts one element past a 16-byte
    boundary."""
    flat = torch.empty(z.numel() + 1, dtype=z.dtype, device=z.device)
    flat[1:] = z.reshape(-1)
    out = flat[1:].view(z.shape)
    assert out.data_ptr() % 16 != 0
    return out


def _mamba_inputs(dev, bsz, t, din, n, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.nn.functional.softplus(_randn(g, (bsz, t, din), dev)) * 0.1
    x = _randn(g, (bsz, t, din), dev)
    b, c = (_randn(g, (bsz, t, n), dev, 0.5) for _ in range(2))
    a = -torch.exp(_randn(g, (din, n), dev, 0.3))
    d = _randn(g, (din,), dev)
    h0 = _randn(g, (bsz, din, n), dev, 0.5)
    return [dt.to(dtype), x.to(dtype), b, c, a, d, h0]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("case",
                         sorted(MAMBA_CASES) + sorted(MAMBA_UNALIGNED_CASES))
def test_mamba_scan_kernel_matches_plain(cuda, case, dtype):
    if case in MAMBA_UNALIGNED_CASES:
        dt, x, b, c, a, d, h0 = (_off16(z) for z in _mamba_inputs(
            cuda, *MAMBA_UNALIGNED_CASES[case], dtype))
    else:
        dt, x, b, c, a, d, h0 = _mamba_inputs(cuda, *MAMBA_CASES[case],
                                              dtype)
    for init in (None, h0):
        before = mamba_selective_scan_state.launches
        got_y, got_h = mamba_selective_scan_state(dt, x, b, c, a, d, init)
        want_y, want_h = mamba_selective_scan_state_plain(dt, x, b, c, a, d,
                                                          init)
        torch.cuda.synchronize()
        assert mamba_selective_scan_state.launches == before + 1
        torch.testing.assert_close(got_y, want_y, **SCAN_TOL)
        torch.testing.assert_close(got_h, want_h, **SCAN_TOL)
    got = mamba_selective_scan(dt, x, b, c, a, d)
    want = mamba_selective_scan_plain(dt, x, b, c, a, d)
    assert got.dtype == dtype and got.shape == x.shape
    assert _excess(got, want.float(), SCAN_TOL) <= 0


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
def test_mamba_scan_state_carries_across_calls(cuda, dtype):
    """Scanning [0, T1) and then [T1, T) from the returned state gives, bit
    for bit, the y and final state of one call over [0, T): a step's
    arithmetic does not depend on how the steps are blocked (T1 = 45
    splits a time block of 32)."""
    dt, x, b, c, a, d, h0 = _mamba_inputs(cuda, 2, 100, 256, 16, dtype)
    for init in (None, h0):
        whole_y, whole_h = mamba_selective_scan_state(dt, x, b, c, a, d,
                                                      init)
        head, tail = ([z[:, sl].contiguous() for z in (dt, x, b, c)]
                      for sl in (slice(0, 45), slice(45, None)))
        y1, h1 = mamba_selective_scan_state(*head, a, d, init)
        y2, h2 = mamba_selective_scan_state(*tail, a, d, h1)
        assert torch.equal(torch.cat([y1, y2], 1), whole_y)
        assert torch.equal(h2, whole_h)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
def test_mamba_scan_channels_do_not_mix(cuda, dtype):
    """A channel's y and state depend on no other channel: the first 64
    channels of a Din 64 call equal, bit for bit, those of a Din 192 call
    on the same rows, from a zero and from a given state."""
    dt, x, b, c, a, d, h0 = _mamba_inputs(cuda, 2, 70, 192, 16, dtype)
    for init in (None, h0):
        wide_y, wide_h = mamba_selective_scan_state(dt, x, b, c, a, d, init)
        narrow_y, narrow_h = mamba_selective_scan_state(
            dt[..., :64].contiguous(), x[..., :64].contiguous(), b, c,
            a[:64].contiguous(), d[:64].contiguous(),
            None if init is None else init[:, :64].contiguous())
        assert torch.equal(narrow_y, wide_y[..., :64])
        assert torch.equal(narrow_h, wide_h[:, :64])


def test_mamba_scan_plan_stages_the_served_shape_asynchronously(cuda):
    """Jamba's Mamba block (B 2, Din 16384, N 16), prefill and decode,
    float32 and bf16: dt, x, B and C by cp.async, float4 state rows, the
    N = 16 instantiation, at least 256 CTAs of 32-step blocks, at least two
    CTAs' shared memory an SM; rows that are not whole 16-byte chunks take
    plain loads, N 5 reads and writes its state rows by scalar accesses,
    and the edge cases above do cross a CTA's channels."""
    for t in (2048, 1):
        for dtype in (torch.float32, torch.bfloat16):
            plan = mamba_scan_plan(2, t, 16384, 16, dtype)
            assert plan["route"] == "async" and plan["ctas"] >= 256, plan
            assert plan["bc_route"] == "async", plan
            assert plan["state_rows"] == "float4" and plan["exact_n"], plan
            assert plan["tb"] == 32 and plan["threads"] == plan["ch"], plan
            assert 2 * plan["smem_bytes"] <= 227 * 1024, plan
    for dtype in (torch.float32, torch.bfloat16):
        plan = mamba_scan_plan(*MAMBA_CASES["din70_plain_rows"], dtype)
        assert plan["route"] == "plain", plan
    plan = mamba_scan_plan(*MAMBA_CASES["n5_async_rows"], torch.float32)
    assert plan["route"] == "async" and plan["bc_route"] == "plain", plan
    assert plan["state_rows"] == "scalar" and not plan["exact_n"], plan
    assert mamba_scan_plan(*MAMBA_CASES["n8"], torch.float32)[
        "state_rows"] == "float4"
    for case in ("odd", "din_not_ch", "din70_plain_rows"):
        bsz, t, din, n = MAMBA_CASES[case]
        assert din % mamba_scan_plan(bsz, t, din, n, torch.float32)[
            "ch"] != 0, case


FLASH_CASES = {  # (B, T, S, H, KV, D, causal, window, softcap)
    "odd_gqa": (2, 77, 77, 6, 3, 40, True, None, None),
    "t_above_s": (1, 100, 37, 4, 2, 64, True, None, None),
    "t_below_s": (1, 37, 100, 4, 2, 64, True, None, None),
    "window_softcap_d96": (1, 130, 130, 4, 1, 96, True, 17, 30.0),
    "not_causal": (2, 65, 90, 4, 4, 16, False, None, None),
    "d256_window_softcap": (1, 70, 70, 2, 1, 256, True, 32, 50.0),
    "masked_rows": (1, 128, 32, 2, 2, 32, True, 16, None),
    "d120": (1, 66, 66, 3, 1, 120, True, None, None),
    # the tensor-core kernel's tile edges: T and S of 63, 65 and 129
    # (64-row query and kv tiles), D of 16, 40, 80 and 256 (16-deep steps,
    # 32-wide P.V blocks, zero padding)
    "t63_s63_d16": (2, 63, 63, 4, 2, 16, True, None, None),
    "t65_s65_d40": (1, 65, 65, 4, 1, 40, True, None, None),
    "t129_s129_d80": (1, 129, 129, 6, 2, 80, True, None, None),
    "t63_s129_d256": (1, 63, 129, 2, 1, 256, True, None, None),
    "t129_s65_d40_window": (1, 129, 65, 4, 2, 40, True, 33, None),
    "t65_s63_d80_softcap": (2, 65, 63, 2, 2, 80, False, None, 30.0),
    "t129_s129_d256_window_softcap": (1, 129, 129, 2, 1, 256, True, 65,
                                      50.0),
}


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    b, t, s, h, kv, d, causal, window, softcap = FLASH_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(g, (b, t, h, d), cuda).to(dtype)
    k, v = (_randn(g, (b, s, kv, d), cuda).to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **FLASH_TOL)
    else:
        assert _excess(got, want, FLASH_TOL) <= 0
    if case == "masked_rows":            # rows t >= S + window - 1 see nothing
        assert float(got[:, s + window - 1:].float().abs().max()) == 0.0
        assert float(got[:, :s + window - 1].float().abs().max()) > 0.0


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
def test_flash_bf16_runs_the_tensor_cores_and_f32_the_fma_body(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(g, (1, 130, 4, 64), cuda).to(dtype)
    k, v = (_randn(g, (1, 130, 2, 64), cuda).to(dtype) for _ in range(2))
    plan = flash_attention_plan(q, k, v)
    names = _kernel_names(lambda: flash_attention(q, k, v))
    wgmma = dtype == torch.bfloat16
    assert plan["path"] == ("wgmma" if wgmma else "fma")
    assert plan["kernel"] == ("flash_attn_wgmma_kernel" if wgmma
                              else "flash_attn_kernel")
    # 128 query rows a CTA on the tensor cores, 64 in the FMA body
    assert plan["ctas"] == (2 if wgmma else 3) * 4 and plan["dp"] == 64
    other = "flash_attn_kernel" if wgmma else "flash_attn_wgmma_kernel"
    assert any(plan["kernel"] in n for n in names), names
    assert not any(other in n for n in names), names


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
def test_flash_kernel_failure_raises_and_nothing_falls_back(cuda, dtype,
                                                           monkeypatch):
    """More batch rows than the grid takes (B > 65535) make the launch
    fail: the wrapper raises, counts no launch and never runs the plain
    version in its place."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for CUDA tensors")

    monkeypatch.setattr(flash_mod, "flash_attention_plain", plain)
    q = torch.zeros((65536, 1, 2, 16), device=cuda, dtype=dtype)
    kv = torch.zeros((65536, 1, 1, 16), device=cuda, dtype=dtype)
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="flash_attention launch failed"):
        flash_attention(q, kv, kv)
    assert flash_attention.launches == before


def test_moe_bf16_never_falls_back(cuda, monkeypatch):
    """A bf16 call on the card runs the tensor-core kernels only: the plain
    version is never called in their place."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for CUDA tensors")

    monkeypatch.setattr(moe_kernel_mod, "moe_expert_ffn_plain", plain)
    x, w_in, w_out = _moe_inputs(cuda, 2, 3, 5, 64, 32, torch.bfloat16)
    y = moe_expert_ffn(x, w_in, w_out)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


def test_new_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """A wrong dtype, shape or layout raises on CUDA tensors; nothing runs
    the plain version there and no launch is counted."""
    r, k, v, w, u, s0 = _wkv_inputs(cuda, 2, 5, 3, 16, 16, torch.float32)
    counts = (wkv6_state.launches, flash_attention.launches,
              mamba_selective_scan_state.launches)
    with pytest.raises(ValueError, match="mixed"):
        wkv6_state(r, k, v, w.cpu(), u)
    with pytest.raises(ValueError, match="one dtype"):
        wkv6_state(r.double(), k.double(), v.double(), w, u)
    with pytest.raises(ValueError, match="one dtype"):
        wkv6_state(r, k.bfloat16(), v, w, u)
    with pytest.raises(ValueError, match="disagree"):
        wkv6_state(r, k[:, :4], v, w, u)
    with pytest.raises(ValueError, match="float32 s0"):
        wkv6_state(r, k, v, w, u, s0.bfloat16())
    with pytest.raises(ValueError, match="K <= 128"):
        big = torch.zeros((1, 2, 1, 130), device=cuda)
        wkv6_state(big, big, big[..., :4], big, big[0, 0])
    with pytest.raises(ValueError, match="contiguous"):
        wkv6_state(r.transpose(0, 1).contiguous().transpose(0, 1), k, v, w,
                   u)
    q = torch.zeros((1, 8, 4, 32), device=cuda)
    kk = torch.zeros((1, 8, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention(q.half(), kk.half(), kk.half())
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention(q[:, :, :3], kk, kk)
    with pytest.raises(ValueError, match="D <= 256"):
        big = torch.zeros((1, 4, 1, 264), device=cuda)
        flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), kk,
                        kk)
    dt, x, b, c, a, d, h0 = _mamba_inputs(cuda, 2, 6, 10, 4, torch.float32)
    with pytest.raises(ValueError, match="one dtype"):
        mamba_selective_scan_state(dt.bfloat16(), x, b, c, a, d)
    with pytest.raises(ValueError, match="disagree"):
        mamba_selective_scan_state(dt, x, b[:, :5], c, a, d)
    with pytest.raises(ValueError, match="N <= 32"):
        wide = torch.zeros((2, 6, 40), device=cuda)
        mamba_selective_scan_state(dt, x, wide, wide,
                                   torch.zeros((10, 40), device=cuda), d)
    with pytest.raises(ValueError, match="float32 h0"):
        mamba_selective_scan_state(dt, x, b, c, a, d, h0.bfloat16())
    assert counts == (wkv6_state.launches, flash_attention.launches,
                      mamba_selective_scan_state.launches)


@pytest.mark.parametrize("arch,prompt_len", (("rwkv6-7b", 12),
                                             ("jamba-1.5-large-398b", 2048)))
def test_recurrent_lm_on_the_card_matches_the_cpu(cuda, arch, prompt_len):
    """Reduced float32 rwkv6 and Jamba hybrid (mamba + attention + MoE,
    a prompt long enough for the flash kernel) served on the card and on
    the CPU: the same greedy tokens, one scan launch per recurrent layer
    and step, one flash launch per attention layer in prefill."""
    cfg = reduced_config(arch).with_(moe_use_kernel=True)
    host = init_lm_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, prompt_len)).astype(np.int32))
    kinds = cfg.layer_kinds() * cfg.n_groups
    before = (wkv6_state.launches, mamba_selective_scan_state.launches,
              flash_attention.launches)
    got = greedy_generate(params_to(host, cuda), cfg, prompt, max_new=5)
    launched = (wkv6_state.launches - before[0],
                mamba_selective_scan_state.launches - before[1],
                flash_attention.launches - before[2])
    want = greedy_generate(host, cfg, prompt, max_new=5, device="cpu")
    assert launched == (5 * kinds.count("rwkv"), 5 * kinds.count("mamba"),
                        kinds.count("attn") if prompt_len >= 2048 else 0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# ------------------------------------------------------- training on the card


#: the training path's bounds, card against CPU (tests/test_grad.py's
#: GRAD_ATOL_F32 on every gradient leaf, 1e-6 relative on the loss).
GRAD_ATOL_F32 = 1e-5


def _train_batch(seed=7, batch=32):
    from repro_torch.data.graphs import pair_stream

    b = next(pair_stream(seed, batch, device="cpu"))
    return b["pairs"], b["target"]


@pytest.mark.parametrize("path", ("auto", "packed_dense", "reference"))
def test_loss_and_grad_on_the_card_matches_the_cpu(cuda, path):
    from repro_torch.params import tree_leaves

    p = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    pairs, target = _train_batch()
    card = ScoringEngine(p, CONFIG, path=path, device=cuda)
    host = ScoringEngine(p, CONFIG, path=path, device="cpu")
    launched = sparse_pair_score.launches + packed_pair_score.launches
    cl, cg = card.loss_and_grad(pairs, target)
    hl, hg = host.loss_and_grad(pairs, target)
    assert card.last_plan.path == host.last_plan.path
    assert card.last_plan.degraded_from == ()
    assert abs(float(cl) - float(hl)) <= 1e-6 * abs(float(hl))
    for a, b in zip(tree_leaves(cg), tree_leaves(hg)):
        assert a.is_cuda
        assert float((a.cpu() - b).abs().max()) <= GRAD_ATOL_F32
    # training launches no scoring kernel
    assert sparse_pair_score.launches + packed_pair_score.launches == \
        launched


@pytest.mark.parametrize("path", ("packed_sparse", "packed_dense",
                                  "reference"))
def test_backward_bits_deterministic_on_the_card(cuda, path):
    """No backward rule sums with atomics: two runs give the same bits."""
    from repro_torch.params import tree_leaves

    p = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    pairs, target = _train_batch(9, 64)
    card = ScoringEngine(p, CONFIG, path=path, device=cuda)
    runs = [card.loss_and_grad(pairs, target, accum_steps=2)
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
        assert torch.equal(a, b)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.params import tree_leaves
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import build_simgnn_train_step

    p = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    pairs, target = _train_batch(11, 64)
    out = []
    for dev in (cuda, "cpu"):
        eng = ScoringEngine(p, CONFIG, device=dev)
        step = build_simgnn_train_step(eng, peak_lr=1e-2)
        params = eng.params
        new, state, metrics = step(params, adamw_init(params),
                                   {"pairs": pairs, "target": target})
        assert "skipped" not in metrics and int(state.step) == 1
        out.append((new, metrics))
    (cp, cm), (hp, hm) = out
    assert abs(float(cm["loss"]) - float(hm["loss"])) <= \
        1e-6 * abs(float(hm["loss"]))
    for a, b in zip(tree_leaves(cp), tree_leaves(hp)):
        assert float((a.cpu() - b).abs().max()) <= GRAD_ATOL_F32


# ----------------------------- gradients through the LM kernels' wrappers

def _lm_kernel_case(name, dev):
    """(wrapper, plain version, float32 inputs, bound) of one LM kernel at
    a small shape; the first output is what a loss reads."""
    g = torch.Generator(device=dev).manual_seed(3)
    if name == "flash_attn":
        q = _randn(g, (1, 300, 4, 32), dev)
        k, v = (_randn(g, (1, 300, 2, 32), dev) for _ in range(2))
        return flash_attention, flash_attention_plain, (q, k, v), FLASH_TOL
    if name == "wkv6":
        r, k = (_randn(g, (2, 40, 2, 16), dev, 0.5) for _ in range(2))
        v = _randn(g, (2, 40, 2, 16), dev, 0.5)
        w = torch.exp(-torch.exp(_randn(g, (2, 40, 2, 16), dev, 0.5) - 1))
        u = _randn(g, (2, 16), dev, 0.5)
        return wkv6_state, wkv6_state_plain, (r, k, v, w, u), SCAN_TOL
    if name == "mamba_scan":
        dt = torch.nn.functional.softplus(_randn(g, (2, 40, 24), dev) - 2)
        x = _randn(g, (2, 40, 24), dev)
        b, c = (_randn(g, (2, 40, 8), dev) for _ in range(2))
        a = -torch.exp(_randn(g, (24, 8), dev, 0.5))
        d = _randn(g, (24,), dev)
        return (mamba_selective_scan_state, mamba_selective_scan_state_plain,
                (dt, x, b, c, a, d), SCAN_TOL)
    x = _randn(g, (2, 4, 8, 32), dev)
    w_in = _randn(g, (4, 32, 64), dev, 0.1)
    w_out = _randn(g, (4, 32, 32), dev, 0.1)
    return moe_expert_ffn, moe_expert_ffn_plain, (x, w_in, w_out), BODY_TOL


@pytest.mark.parametrize("name", ("flash_attn", "wkv6", "mamba_scan",
                                  "moe_experts"))
def test_lm_kernel_gradients_match_plain_autograd(cuda, name):
    """Under grad the wrapper still launches its kernel (one count) and
    its output has a backward: autograd of the plain version, giving every
    input the plain forward's gradients within the kernel's bound."""
    wrapper, plain, inputs, tol = _lm_kernel_case(name, cuda)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    before = wrapper.launches
    out = wrapper(*leaves)
    assert wrapper.launches == before + 1
    y = out[0] if isinstance(out, tuple) else out
    assert y.grad_fn is not None
    ref_leaves = [t.clone().requires_grad_(True) for t in inputs]
    ref = plain(*ref_leaves)
    ref_y = ref[0] if isinstance(ref, tuple) else ref
    torch.testing.assert_close(y, ref_y, **tol)
    cot = torch.randn(y.shape, device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(4))
    got = torch.autograd.grad(y, leaves, cot)
    want = torch.autograd.grad(ref_y, ref_leaves, cot)
    assert wrapper.launches == before + 1        # the backward is plain
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **tol)



# ------------------------------- device-sharded serving (DESIGN.md §16)
#
# Logical devices over the one card, each shard on its own stream
# (`distributed.sharding.force_logical_device_count(n, "cuda:0")`): the
# sharded path launches the same kernels at the shards' shapes and must
# give the unsharded bits.

@pytest.fixture
def logical(cuda):
    from repro_torch.distributed import sharding

    sharding.force_logical_device_count(8, "cuda:0")
    try:
        yield sharding
    finally:
        sharding.disarm_logical_devices()


def test_tile_mesh_on_the_card_needs_armed_devices(cuda):
    from repro_torch.distributed import sharding

    sharding.disarm_logical_devices()
    n = torch.cuda.device_count()
    mesh = sharding.tile_mesh(None)
    assert mesh.size == n and not mesh.logical
    assert all(isinstance(s, torch.cuda.Stream) for s in mesh.streams)
    with pytest.raises(ValueError, match=f"have {n}"):
        sharding.tile_mesh(n + 1)


#: spans (lo, hi) over a packed batch's T tiles: a shard of one tile at
#: either end, spans of pad tiles only (lo == hi), four near-equal spans
#: and single tiles.
SHARD_SPLITS = {
    "one_tile_last": lambda t: [(0, t - 1), (t - 1, t)],
    "one_tile_first": lambda t: [(0, 1), (1, t)],
    "pad_only_spans": lambda t: [(0, t // 2), (t // 2, t), (t, t), (t, t)],
    "quarters": lambda t: [(min(t, d * -(-t // 4)),
                            min(t, (d + 1) * -(-t // 4))) for d in range(4)],
    "single_tiles": lambda t: [(d, d + 1) for d in range(4)] + [(4, t)],
}


@pytest.mark.parametrize("split", sorted(SHARD_SPLITS))
@pytest.mark.parametrize("sparse", (True, False), ids=("sparse", "dense"))
def test_sharded_tiles_bitwise_equal_to_unsharded(logical, split, sparse):
    """`score_tiles_sharded` over logical devices of the card: the same
    bits as one launch over all tiles, one launch a non-empty span and
    none for a span of pad tiles only."""
    from repro_torch.kernels import ops

    sparse_args, dense_args, t = _packed(torch.device("cuda"), n_pairs=96)
    arrays = sparse_args if sparse else dense_args
    kern = sparse_pair_score if sparse else packed_pair_score
    want = kern(*arrays, *_params())
    spans = SHARD_SPLITS[split](t)
    mesh = logical.tile_mesh(len(spans))
    params = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG,
                                device="cuda")
    before = kern.launches
    got = ops.score_tiles_sharded(kern, arrays, ops.shard_params(params, mesh),
                                  mesh, spans)
    torch.cuda.synchronize()
    assert kern.launches - before == sum(hi > lo for lo, hi in spans)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n_pairs", (5, 40, 256))
@pytest.mark.parametrize("nd", (2, 4))
@pytest.mark.parametrize("path", ("packed_sparse", "packed_dense"))
def test_sharded_engine_bitwise_equal_to_unsharded(logical, path, nd,
                                                   n_pairs):
    """The engine on nd logical devices: the unsharded engine's bits, the
    plan's device count (5 pairs plan one device), `last_pack_stats`
    matching the plan, one launch a non-empty shard."""
    from repro_torch.kernels import ops

    params = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    pairs = query_pairs(13, n_pairs)
    one = ScoringEngine(params, CONFIG, path=path)
    eng = ScoringEngine(params, CONFIG, path=path,
                        runtime=logical.tile_runtime(nd))
    kern = sparse_pair_score if path == "packed_sparse" else \
        packed_pair_score
    want = one.score(pairs)
    before = kern.launches
    got = eng.score(pairs)
    plan = eng.last_plan
    assert plan.degraded_from == () and plan.attempts == 1
    assert got.tobytes() == want.tobytes()
    devices = 1 if n_pairs < 2 * 4 else nd
    assert plan.devices == devices
    if devices == 1:
        assert kern.launches - before == 1
        return
    ps = eng.last_pack_stats
    target, _ = ops.sharded_tile_plan(ps["tiles"], eng.node_budget, nd,
                                      sparse=path == "packed_sparse")
    spans = ops.shard_spans(ps["tiles"], target, nd)
    assert ps["devices"] == nd and ps["tiles_padded"] == target
    assert kern.launches - before == sum(hi > lo for lo, hi in spans)


@pytest.mark.parametrize("mode", ("raise", "nan"))
def test_dead_shard_on_the_card_serves_single_device(logical, mode):
    params = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    pairs = query_pairs(13, 64)
    want = ScoringEngine(params, CONFIG, path="packed_sparse").score(pairs)
    eng = ScoringEngine(params, CONFIG, path="packed_sparse",
                        runtime=logical.tile_runtime(2))
    with faults.inject("sharded:packed_sparse", mode, times=1):
        got = eng.score(pairs)
    assert got.tobytes() == want.tobytes()
    assert eng.last_plan.degraded_from == ("packed_sparse@2d",)
    assert eng.health()["counters"] == {"errors:packed_sparse@2d": 1}
    assert eng.score(pairs).tobytes() == want.tobytes()
    assert eng.last_plan.degraded_from == ()


def _tied_corpus(n=200, distinct=9):
    """A corpus of few distinct graphs repeated in a cycle, so equal
    embeddings (and equal scores) straddle every span boundary."""
    rng = np.random.default_rng(21)
    graphs = [random_graph(rng, int(rng.integers(6, 30)))
              for _ in range(distinct)]
    return [dict(graphs[i % distinct]) for i in range(n)]


@pytest.mark.parametrize("proxy", ("linear", "ntn_exact"))
@pytest.mark.parametrize("nd", (2, 4))
def test_span_search_bitwise_equal_to_one_span(logical, nd, proxy):
    """Spans of whole 32-row blocks over a 200-row corpus (at 4 devices
    64, 64, 64 and 8 rows: a last span shorter than M = 16 that ends on a
    partial block), ties across every span boundary: the merged shortlist,
    and the two-stage results, equal the one-span server's bit for bit."""
    params = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    corpus = _tied_corpus()
    queries = [random_graph(np.random.default_rng(s), 12)
               for s in range(5)] + corpus[:3]
    servers = []
    for runtime in (None, logical.tile_runtime(nd)):
        srv = SimilaritySearchServer(params, CONFIG, shard_rows=32,
                                     runtime=runtime)
        srv.index(corpus)
        srv._calib = dict(srv._calibration(), proxy=proxy)
        servers.append(srv)
    one, many = servers
    spans = many._prefilter_spans(200, 32)
    assert len(spans) == nd and many.health()["prefilter"]["spans"] == nd
    hq = one.engine.embed_graphs(queries)
    if proxy == "linear":
        from repro_torch.kernels.retrieval import prefilter_query_vectors

        qv, ntn_ops = prefilter_query_vectors(params["ntn"]["w"], hq,
                                              one._calib), None
    else:
        qv, ntn_ops = hq, retrieval.collapse_query_ntn(params["ntn"], hq)
    ws, wi = one._span_topm(qv, ntn_ops, 16, 32, [(0, 200)])
    gs, gi = many._span_topm(qv, ntn_ops, 16, 32, spans)
    assert np.array_equal(gi, wi) and gs.tobytes() == ws.tobytes()
    want = one.search(queries, k=10, mode="two_stage", prefilter_m=16)
    scans = many.engine.counters["prefilter_span_scans"]
    got = many.search(queries, k=10, mode="two_stage", prefilter_m=16)
    assert many.engine.counters["prefilter_span_scans"] - scans == nd
    assert many.engine.last_plan.devices == nd
    for (a, sa), (b, sb) in zip(got, want):
        assert np.array_equal(a, b) and sa.tobytes() == sb.tobytes()


# ------------------------------ device-sharded training (DESIGN.md §16)
#
# `loss_and_grad` with the tile axis over logical devices of the card: each
# span's forward and backward on its own stream, the losses and grads
# summed on the first device.

def _tree_bits(a, b) -> bool:
    from repro_torch.params import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


@pytest.mark.parametrize("accum", (1, 4))
@pytest.mark.parametrize("path", ("packed_sparse", "packed_dense"))
def test_sharded_loss_and_grad_on_the_card(logical, path, accum):
    """2 logical devices: loss and every gradient leaf within 1e-6 of the
    one-device call on the card, two calls bit-equal, the grads on the
    card and no scoring kernel launched."""
    from repro_torch.params import tree_leaves

    params = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    pairs, target = _train_batch(9, 64)
    one = ScoringEngine(params, CONFIG, path=path)
    eng = ScoringEngine(params, CONFIG, path=path,
                        runtime=logical.tile_runtime(2))
    launched = sparse_pair_score.launches + packed_pair_score.launches
    wl, wg = one.loss_and_grad(pairs, target, accum_steps=accum)
    runs = [eng.loss_and_grad(pairs, target, accum_steps=accum)
            for _ in range(2)]
    plan = eng.last_plan
    assert plan.devices == 2 and plan.degraded_from == ()
    assert eng.last_pack_stats["devices"] == 2
    (gl, gg), (al, ag) = runs
    assert torch.equal(gl, al) and _tree_bits(gg, ag)
    assert abs(float(gl) - float(wl)) <= 1e-6
    for a, b in zip(tree_leaves(gg), tree_leaves(wg)):
        assert a.is_cuda and float((a - b).abs().max()) <= 1e-6
    assert sparse_pair_score.launches + packed_pair_score.launches == \
        launched


@pytest.mark.parametrize("mode", ("raise", "nan"))
def test_dead_shard_in_training_on_the_card_collapses(logical, mode):
    params = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG)
    pairs, target = _train_batch(9, 64)
    wl, wg = ScoringEngine(params, CONFIG, path="packed_sparse"
                           ).loss_and_grad(pairs, target)
    eng = ScoringEngine(params, CONFIG, path="packed_sparse",
                        runtime=logical.tile_runtime(2))
    with faults.inject("sharded:train:packed_sparse", mode, times=1):
        gl, gg = eng.loss_and_grad(pairs, target)
    assert torch.equal(gl, wl) and _tree_bits(gg, wg)
    assert eng.last_plan.degraded_from == ("packed_sparse@2d",)
    assert eng.health()["counters"] == {
        "errors:train:packed_sparse@2d": 1}
    eng.loss_and_grad(pairs, target)
    assert eng.last_plan.degraded_from == () and eng.last_plan.devices == 2


# ------------------------------------------ the LM mesh (DESIGN.md §6)
#
# The mesh step (`train/step.py`) over logical devices of the card: params
# and AdamW moments stored as per-device blocks, one replica a batch row
# on its first device's stream, each replica's loss on its model row
# (every member on its own stream) where the config splits over `model`,
# the LM kernels launched in each replica's forward.

#: (arch, config changes, the kernel the family's forward launches)
MESH_FAMILIES = (("granite-moe-3b-a800m", {"moe_use_kernel": True},
                  "moe_experts"),
                 ("rwkv6-7b", {}, "wkv6"),
                 ("jamba-1.5-large-398b", {}, "mamba_scan"))
MESH_WRAPPERS = {"moe_experts": moe_expert_ffn, "wkv6": wkv6_state,
                 "mamba_scan": mamba_selective_scan_state}


def _lm_mesh_run(arch, kw, shape, device, steps=3):
    """`steps` mesh steps of reduced float32 `arch` on a `shape` mesh over
    `device` (logical devices on a one-card machine; batch 4 x 64 tokens,
    2 replicas at data 2): the final params and AdamW moments gathered
    onto the CPU, and the losses."""
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.distributed import placement, sharding
    from repro_torch.launch.mesh import mesh_runtime
    from repro_torch.params import tree_leaves
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import build_train_step

    cfg = reduced_config(arch).with_(**kw)
    host = init_lm_params(torch.Generator().manual_seed(11), cfg,
                          device="cpu")
    rt, _ = mesh_runtime("x".join(map(str, shape)), torch.device(device))
    params = placement.shard_tree(params_to(host, device),
                                  sharding.param_shardings(rt, host))
    opt = adamw_init(params)
    step = build_train_step(cfg, rt)
    losses = []
    for s in range(steps):
        batch = batch_for_step(cfg, s, global_batch=4, seq_len=64)
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    return [placement.gather(x).cpu()
            for x in tree_leaves((params, opt.m, opt.v))], losses


@pytest.mark.parametrize("arch,kw,kernel", MESH_FAMILIES,
                         ids=[f[0] for f in MESH_FAMILIES])
def test_lm_mesh_step_on_the_card_matches_the_cpu(cuda, arch, kw, kernel):
    """(2, 2): params and moments within 1e-5 of the same steps on logical
    CPU devices, the family's kernel launched in the replicas' forward."""
    wrapper = MESH_WRAPPERS[kernel]
    before = wrapper.launches
    card, card_losses = _lm_mesh_run(arch, kw, (2, 2), "cuda:0")
    assert wrapper.launches > before
    host, host_losses = _lm_mesh_run(arch, kw, (2, 2), "cpu")
    for a, b in zip(card, host):
        assert float((a - b).abs().max()) <= 1e-5
    np.testing.assert_allclose(card_losses, host_losses, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch,kw,kernel", MESH_FAMILIES,
                         ids=[f[0] for f in MESH_FAMILIES])
def test_lm_mesh_step_on_the_card_is_bit_equal_across_runs_and_agrees_across_model(
        cuda, arch, kw, kernel):
    """Two (2, 2) runs bit-equal (their model rows of two members on
    their own streams); (2, 1) and (2, 4), which differ only in `model`,
    within 1e-5 of them (granite's 2 KV heads do not split over 4: its
    (2, 4) rows are one member, bit-equal to (2, 1))."""
    first = _lm_mesh_run(arch, kw, (2, 2), "cuda:0")
    again = _lm_mesh_run(arch, kw, (2, 2), "cuda:0")
    assert again[1] == first[1]
    assert all(torch.equal(a, b) for a, b in zip(again[0], first[0]))
    dp = _lm_mesh_run(arch, kw, (2, 1), "cuda:0")
    for shape in ((2, 1), (2, 4)):
        leaves, losses = dp if shape == (2, 1) else _lm_mesh_run(
            arch, kw, shape, "cuda:0")
        np.testing.assert_allclose(losses, first[1], rtol=0, atol=1e-5)
        for a, b in zip(leaves, first[0]):
            assert float((a - b).abs().max()) <= 1e-5, shape
        if shape == (2, 4) and arch == "granite-moe-3b-a800m":
            assert losses == dp[1]
            assert all(torch.equal(a, b) for a, b in zip(leaves, dp[0]))


@pytest.mark.parametrize("arch,kw,kernel", MESH_FAMILIES,
                         ids=[f[0] for f in MESH_FAMILIES])
def test_tp_train_value_and_grad_on_the_card_matches_the_cpu(cuda, arch, kw,
                                                            kernel):
    """`value_and_grad` of `lm_loss` on a (1, 2) model row of logical card
    devices (each member on its own stream, remat, the family's kernel in
    the forward): the loss and every gradient leaf within 1e-5 of the
    same call on logical CPU devices, and two card calls bit-equal."""
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.launch.mesh import mesh_runtime
    from repro_torch.params import tree_leaves
    from repro_torch.train.step import value_and_grad

    cfg = reduced_config(arch).with_(**kw)
    host = init_lm_params(torch.Generator().manual_seed(11), cfg,
                          device="cpu")
    batch = batch_for_step(cfg, 0, global_batch=2, seq_len=64)
    wrapper = MESH_WRAPPERS[kernel]
    runs = []
    for device in ("cuda:0", "cuda:0", "cpu"):
        rt, _ = mesh_runtime("1x2", torch.device(device))
        before = wrapper.launches
        loss, g = value_and_grad(
            params_to(host, device), cfg,
            {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
            rt=rt)
        assert (wrapper.launches > before) == (device != "cpu")
        runs.append([loss.cpu()] + [x.cpu() for x in tree_leaves(g)])
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    for a, b in zip(runs[0], runs[2]):
        assert float((a - b).abs().max()) <= 1e-5


# ------------------------------------ GPipe (distributed/pipeline.py)
#
# The pipeline over 4 logical devices of the card, each stage on its own
# stream (`distributed.pipeline.gpipe` on a ("stage",) mesh, 4
# microbatches): float32 calls within 1e-6 of the same calls on 4 logical
# CPU devices (y and every gradient leaf, relative to the CPU tensor's
# largest |value|, as tests/test_torch_pipeline.py holds the CPU against
# JAX), two calls bit-equal, and the pipelined forward bit-equal to the
# stages applied in order, microbatch by microbatch, on one stream
# (`pipeline.sequential`), its gradients too. The toy stage function's x
# gradient reaches |74|, and the CPU's own float32 result is 9.0e-7 of
# that from a float64 run (the card's 1.34e-6 from the CPU's on an H100),
# so the toy leaves are held within PIPE_TOY_BOUND, granite and rwkv6
# within 1e-6.

#: the JAX test's stage function ("toy": x + tanh(x @ w1) @ w2, d 16,
#: hidden 32, 8 rows) and reduced float32 granite (MoE and attention) and
#: rwkv6 at 4 layer groups, one a stage (4 x 16 tokens)
PIPE_FAMILIES = ("toy", "granite-moe-3b-a800m", "rwkv6-7b")
PIPE_STAGES = 4
#: twice the toy's float32-to-float64 distance on the CPU (9.0e-7, the x
#: gradient), rounded up
PIPE_TOY_BOUND = 2e-6


def _pipe_case(family):
    """(stage function, per-stage CPU trees, x on the CPU)."""
    from repro_torch.models import lm
    from repro_torch.params import tree_map

    rng = np.random.default_rng(5)
    if family == "toy":
        stages = [{"w1": torch.from_numpy((rng.standard_normal((16, 32))
                                           * 0.3).astype(np.float32)),
                   "w2": torch.from_numpy((rng.standard_normal((32, 16))
                                           * 0.3).astype(np.float32))}
                  for _ in range(PIPE_STAGES)]
        x = rng.standard_normal((8, 16))
        return (lambda p, x: x + torch.tanh(x @ p["w1"]) @ p["w2"], stages,
                torch.from_numpy(x.astype(np.float32)))
    cfg = reduced_config(family)
    cfg = cfg.with_(n_layers=PIPE_STAGES * cfg.group_size)
    groups = init_lm_params(torch.Generator().manual_seed(11), cfg,
                            device="cpu")["groups"]
    stages = [tree_map(lambda t, i=i: t[i:i + 1], groups)
              for i in range(PIPE_STAGES)]
    x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    return (lambda p, x: lm._run_groups({"groups": p}, cfg, x,
                                        positions=lm._positions(x))[0],
            stages, torch.from_numpy(x))


def _pipe_run(family, device, in_order=False):
    """y and the gradients of sum(y ** 2) (stacked leaves, then x), on the
    CPU, of the pipelined call on 4 logical devices over `device`; with
    `in_order`, of the stages applied in order microbatch by microbatch on
    the current stream (`sequential`)."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.pipeline import (gpipe, sequential,
                                                  stack_stage_params)
    from repro_torch.params import tree_leaves, tree_map

    fn, stages, x = _pipe_case(family)
    stages = [tree_map(lambda t: t.to(device).requires_grad_(), s)
              for s in stages]
    stacked = stack_stage_params(stages)
    x = x.to(device).requires_grad_()
    with sharding.logical_devices(PIPE_STAGES, device):
        mesh = sharding.lm_mesh((PIPE_STAGES,), ("stage",), device)
    y = (sequential if in_order else gpipe)(fn, mesh)(stacked, x)
    grads = torch.autograd.grad(torch.sum(y ** 2),
                                tree_leaves(stacked) + [x])
    return [t.detach().cpu() for t in (y, *grads)]


@pytest.mark.parametrize("family", PIPE_FAMILIES)
def test_gpipe_on_the_card_matches_the_cpu(cuda, family):
    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())

    card = _pipe_run(family, "cuda:0")
    host = _pipe_run(family, "cpu")
    bound = PIPE_TOY_BOUND if family == "toy" else 1e-6
    for a, b in zip(card, host):
        assert rel(a, b) <= bound, (rel(a, b), bound)


@pytest.mark.parametrize("family", PIPE_FAMILIES)
def test_gpipe_on_the_card_repeats_bit_for_bit(cuda, family):
    first = _pipe_run(family, "cuda:0")
    again = _pipe_run(family, "cuda:0")
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("family", PIPE_FAMILIES)
def test_gpipe_on_the_card_is_the_stages_in_order_on_one_stream(cuda,
                                                                family):
    piped = _pipe_run(family, "cuda:0")
    in_order = _pipe_run(family, "cuda:0", in_order=True)
    assert all(torch.equal(a, b) for a, b in zip(piped, in_order))


# -------------- tensor-parallel serving (distributed/tensor_parallel.py)
#
# Reduced float32 granite (the expert kernel; a 2048-token prompt, so the
# flash kernel runs in prefill), rwkv6 (wkv6) and the Jamba hybrid
# (mamba_scan and the expert kernel) served on a (1, 2) mesh of logical
# devices over the card, each member launching its shard's kernels on its
# own stream: the greedy tokens equal to the same mesh's on logical CPU
# devices (the plain versions), the logits of a prefill and 4 decode steps
# fed those tokens and the assembled caches within TP_ATOL (the float32
# card-against-CPU bound of chip_smoke's 2-layer models); two runs
# bit-equal, and a (1, 1) mesh bit-equal to unsharded serving on the card.
# Then each of the four kernels at the shard shapes chip_smoke's phase 26
# gives them on (1, 4) against its plain version.

TP_FAMILIES = (("granite-moe-3b-a800m", {"moe_use_kernel": True}, 2048),
               ("rwkv6-7b", {}, 16),
               ("jamba-1.5-large-398b", {"moe_use_kernel": True}, 64))
TP_ATOL = 1e-4
TP_NEW = 5
TP_WRAPPERS = {"moe_experts": moe_expert_ffn, "flash_attn": flash_attention,
               "wkv6": wkv6_state, "mamba_scan": mamba_selective_scan_state}


def _tp_expected(cfg, prompt_len, m) -> dict:
    """Launches of a greedy_generate of TP_NEW tokens on one row of m."""
    kinds = cfg.layer_kinds() * cfg.n_groups
    moes = cfg.layer_is_moe() * cfg.n_groups
    attn = sum(k in ("attn", "attn_local") for k in kinds)
    return {"moe_experts": TP_NEW * m * sum(moes) if cfg.moe_use_kernel
            else 0,
            "flash_attn": m * attn if prompt_len >= 2048 else 0,
            "wkv6": TP_NEW * m * kinds.count("rwkv"),
            "mamba_scan": TP_NEW * m * kinds.count("mamba")}


def _tp_card_run(arch, kw, prompt_len, device, shape=(1, 2), tokens=None):
    """Reduced float32 `arch` served on a `shape` mesh over `device`
    (logical devices on a one-card machine; None: unsharded): (greedy
    tokens, the launches of that greedy_generate, [logits of a prefill
    and TP_NEW - 1 decode steps fed `tokens` (default: its own)], the
    caches' leaves assembled whole), all on the CPU."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import mesh_runtime
    from repro_torch.params import tree_leaves
    from repro_torch.serve.step import build_decode_step, build_prefill_step

    cfg = reduced_config(arch).with_(**kw)
    host = init_lm_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, prompt_len)).astype(np.int32)).to(device)
    rt = None if shape is None else mesh_runtime(
        "x".join(map(str, shape)), torch.device(device))[0]
    params = params_to(host, device) if rt is None else tp.tp_layout(
        host, cfg, rt)
    before = {k: w.launches for k, w in TP_WRAPPERS.items()}
    toks = greedy_generate(params, cfg, prompt, max_new=TP_NEW,
                           device=device, rt=rt)
    launched = {k: w.launches - before[k] for k, w in TP_WRAPPERS.items()}
    tokens = toks if tokens is None else tokens.to(device)
    prefill, decode = build_prefill_step(cfg, rt), build_decode_step(cfg, rt)
    last, cache, pos = prefill(params, prompt)
    logits = [last]
    for t in range(TP_NEW - 1):
        last, cache, pos = decode(params, tokens[:, t:t + 1], cache, pos)
        logits.append(last)
    whole = cache if rt is None else tp.gather_caches(cache)
    return (toks.cpu(), launched, [x.cpu() for x in logits],
            [x.cpu() for x in tree_leaves(whole)])


@pytest.mark.parametrize("arch,kw,prompt_len", TP_FAMILIES,
                         ids=[f[0] for f in TP_FAMILIES])
def test_tp_serving_on_the_card_matches_the_cpu(cuda, arch, kw, prompt_len):
    toks, launched, logits, caches = _tp_card_run(arch, kw, prompt_len,
                                                  "cuda:0")
    cfg = reduced_config(arch).with_(**kw)
    assert launched == _tp_expected(cfg, prompt_len, 2), launched
    assert any(launched.values())
    h_toks, h_launched, h_logits, h_caches = _tp_card_run(
        arch, kw, prompt_len, "cpu", tokens=toks)
    assert not any(h_launched.values())
    np.testing.assert_array_equal(toks.numpy(), h_toks.numpy())
    for a, b in zip(logits, h_logits):
        torch.testing.assert_close(a, b, rtol=0, atol=TP_ATOL)
    for a, b in zip(caches, h_caches):
        if a.dtype == torch.int32:                     # the pos planes
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=TP_ATOL)


@pytest.mark.parametrize("arch,kw,prompt_len", TP_FAMILIES,
                         ids=[f[0] for f in TP_FAMILIES])
def test_tp_serving_on_the_card_repeats_and_one_member_is_unsharded(
        cuda, arch, kw, prompt_len):
    def same(a, b):
        return torch.equal(a[0], b[0]) and all(
            torch.equal(x, y) for x, y in zip(a[2] + a[3], b[2] + b[3]))

    first = _tp_card_run(arch, kw, prompt_len, "cuda:0")
    assert same(_tp_card_run(arch, kw, prompt_len, "cuda:0"), first)
    one = _tp_card_run(arch, kw, prompt_len, "cuda:0", shape=(1, 1))
    assert same(one, _tp_card_run(arch, kw, prompt_len, "cuda:0",
                                  shape=None))


@pytest.mark.parametrize("kernel", ("moe_prefill", "moe_decode", "flash",
                                    "wkv6_prefill", "wkv6_decode",
                                    "mamba_prefill", "mamba_decode"))
def test_kernels_at_tensor_parallel_shard_shapes_match_plain(cuda, kernel):
    """granite's experts at F 512 / 4 (C 129 for 512-token prompts, C 8 in
    decode) and its attention at 24 / 4 q and 8 / 4 kv heads, rwkv6-7b's
    64 / 4 heads, Jamba's 16384 / 4 Mamba channels; bf16, as served."""
    bf16 = torch.bfloat16
    if kernel.startswith("moe"):
        c = 129 if kernel == "moe_prefill" else 8
        x, w_in, w_out = _moe_inputs(cuda, 4, 40, c, 1536, 128, bf16)
        got = moe_expert_ffn(x, w_in, w_out)
        want = moe_expert_ffn_plain(x, w_in, w_out)
        assert moe_expert_ffn_plan(x, w_in, w_out)["path"] == "wgmma"
        assert _excess(got, want, BODY_TOL) <= 0
    elif kernel == "flash":
        g = torch.Generator(device=cuda).manual_seed(3)
        q = _randn(g, (1, 2048, 6, 64), cuda).to(bf16)
        k, v = (_randn(g, (1, 2048, 2, 64), cuda).to(bf16) for _ in range(2))
        got, want = flash_attention(q, k, v), flash_attention_plain(q, k, v)
        assert _excess(got, want, FLASH_TOL) <= 0
    elif kernel.startswith("wkv6"):
        t = 512 if kernel == "wkv6_prefill" else 1
        r, k, v, w, u, s0 = _wkv_inputs(cuda, 4, t, 16, 64, 64, bf16)
        init = None if t > 1 else s0
        got, want = (wkv6_state(r, k, v, w, u, init),
                     wkv6_state_plain(r, k, v, w, u, init))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **SCAN_TOL)
    else:
        t = 2048 if kernel == "mamba_prefill" else 1
        dt, x, b, c, a, d, h0 = _mamba_inputs(cuda, 2, t, 4096, 16, bf16)
        init = None if t > 1 else h0
        got = mamba_selective_scan_state(dt, x, b, c, a, d, init)
        want = mamba_selective_scan_state_plain(dt, x, b, c, a, d, init)
        for a_, b_ in zip(got, want):
            torch.testing.assert_close(a_, b_, **SCAN_TOL)
    torch.cuda.synchronize()
