"""Kernel modules of the PyTorch port against the JAX package's Pallas
kernels (interpret mode, as the JAX tests run them on the CPU).

On CPU tensors every kernel wrapper runs its plain PyTorch version, which
is what these tests hold against the JAX kernels on the same inputs (the
JAX package's packed planes, converted). The CUDA kernels themselves run
only on the card: `chip_smoke.py` holds each against its plain version
there.

Bounds (tests/test_parity_matrix.py): packed_sparse and packed_dense
scores 1e-6, the bucketed megakernel 2e-5, bf16 params 2e-2. Kernel
bodies' intermediate activations: rtol 1e-5 / atol 1e-6 (float32 sums in
another order); A' within 2 ulp (XLA's CPU rsqrt, see
tests/test_torch_batching.py); index and segment one-hots exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batching as jb
from repro.core.simgnn import SimGNNConfig, init_simgnn_params
from repro.data.graphs import random_graph
from repro.kernels import common as jc
from repro.kernels import ops as jops
from repro.kernels.fused_pair import fused_pair_score as jax_fused
from repro.kernels.packed_pair import packed_pair_score as jax_packed
from repro.kernels.sparse_pair import sparse_pair_score as jax_sparse
from repro_torch.core import batching as tb
from repro_torch.kernels import common as tc
from repro_torch.kernels import ops as tops
from repro_torch.kernels.fused_pair import fused_pair_score
from repro_torch.kernels.packed_pair import packed_pair_score
from repro_torch.kernels.sparse_pair import sparse_pair_score
from repro_torch.params import params_from_numpy
from test_parity_matrix import ATOL_BF16, ATOL_F32

CONFIGS = {"aids": {}, "narrow": {"gcn_dims": (16, 8, 8, 4)}}
BODY_TOL = dict(rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _jparams(config="aids", dtype="float32"):
    p = init_simgnn_params(jax.random.PRNGKey(0),
                           SimGNNConfig(**CONFIGS[config]))
    if dtype == "bfloat16":
        p = jax.tree.map(lambda x: x.astype(jnp.bfloat16), p)
    return p


def _tparams(config="aids", dtype="float32"):
    return params_from_numpy(jax.tree.map(np.asarray,
                                          _jparams(config, dtype)), "cpu")


def _weights(p):
    return p["gcn"], p["att"]["w"], p["ntn"], p["fcn"]


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _pairs(batch: int, seed: int = 100):
    rng = np.random.default_rng(seed + batch)
    return tuple((random_graph(rng, int(rng.integers(5, 65))),
                  random_graph(rng, int(rng.integers(5, 65))))
                 for _ in range(batch))


@functools.lru_cache(maxsize=None)
def _packed_arrays(batch: int, edge_budget: int, pad_to: int):
    """JAX package's packed planes (sparse order, then dense order) as
    numpy, padded to `pad_to` tiles with all-zero pad tiles."""
    packed, _ = jb.pack_pairs(list(_pairs(batch)), 64, slots_per_tile=16,
                              with_edges=True, edge_budget=edge_budget)
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
        return tuple(np.asarray(jops._pad_batch(jnp.asarray(x), pad_to)[0])
                     for x in xs)
    return pad(sparse), pad(dense), packed.mask1.shape[0]


# (batch, edge budget, pad multiple): odd tile counts, pad tiles, a
# non-empty COO overflow (D=2).
PACKED_CASES = {"batch7": (7, 256, 1), "batch12_pad_tiles": (12, 256, 8),
                "overflow_d2": (12, 128, 1)}


def _sparse_scores(case, config="aids", dtype="float32"):
    sparse, _, _ = _packed_arrays(*PACKED_CASES[case])
    want = np.asarray(jax_sparse(*map(jnp.asarray, sparse),
                                 *_weights(_jparams(config, dtype)),
                                 tile_block=1))
    got = sparse_pair_score(*map(_t, sparse),
                            *_weights(_tparams(config, dtype)))
    return got.numpy(), want


@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_sparse_pair_plain_matches_pallas(case):
    got, want = _sparse_scores(case)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL_F32["packed_sparse"])
    _, _, live = _packed_arrays(*PACKED_CASES[case])
    assert (got[live:] == 0).all()               # pad tiles: exact zeros
    if case == "overflow_d2":
        sparse, _, _ = _packed_arrays(*PACKED_CASES[case])
        assert (sparse[4] != 0).any()            # the COO list is used


@functools.lru_cache(maxsize=None)
def _dense_arrays(case: str):
    """The dense kernel's arrays of a PACKED_CASES case, or of 12 pairs of
    average degree 8 ("deg8": the traffic the engine routes to
    packed_dense), or of those tiles with every adjacency replaced by a
    random symmetric 0/1 matrix over all NB x NB cells ("rewired": rows
    whose nonzero columns cross graph boundaries and pad nodes)."""
    if case in PACKED_CASES:
        return _packed_arrays(*PACKED_CASES[case])[1]
    rng = np.random.default_rng(8)
    pairs = [(random_graph(rng, avg_degree=8.0),
              random_graph(rng, avg_degree=8.0)) for _ in range(12)]
    packed, _ = jb.pack_pairs(pairs, 64, slots_per_tile=16)
    dense = [np.asarray(x) for x in (
        packed.adj1, packed.labels1, packed.mask1, packed.seg1, packed.adj2,
        packed.labels2, packed.mask2, packed.seg2, packed.pair_mask)]
    if case == "rewired":
        for s in (0, 4):
            a = np.triu(rng.random(dense[s].shape) < 0.4, 1)
            dense[s] = (a | a.transpose(0, 2, 1)).astype(np.float32)
    return tuple(dense)


def _packed_scores(case, config="aids", dtype="float32"):
    dense = _dense_arrays(case)
    want = np.asarray(jax_packed(*map(jnp.asarray, dense),
                                 *_weights(_jparams(config, dtype)),
                                 tile_block=1))
    got = packed_pair_score(*map(_t, dense),
                            *_weights(_tparams(config, dtype)))
    return got.numpy(), want


@pytest.mark.parametrize("case", ("batch7", "batch12_pad_tiles", "deg8",
                                  "rewired"))
def test_packed_pair_plain_matches_pallas(case):
    got, want = _packed_scores(case)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL_F32["packed_dense"])


@pytest.mark.parametrize("config,dtype", (("narrow", "float32"),
                                          ("aids", "bfloat16")))
def test_packed_kernels_narrow_and_bf16(config, dtype):
    atol = ATOL_BF16 if dtype == "bfloat16" else ATOL_F32["packed_sparse"]
    got, want = _sparse_scores("batch7", config, dtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    got, want = _packed_scores("batch7", config, dtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@functools.lru_cache(maxsize=None)
def _bucketed(batch: int):
    out = {}
    for b, (lhs, rhs, _) in jb.bucket_pairs(list(_pairs(batch)), 29,
                                            allow_oversize=True).items():
        out[b] = tuple(np.asarray(x) for x in (lhs.adj, lhs.feats, lhs.mask,
                                               rhs.adj, rhs.feats, rhs.mask))
    return out


@pytest.mark.parametrize("config,dtype", (("aids", "float32"),
                                          ("narrow", "float32"),
                                          ("aids", "bfloat16")))
def test_fused_pair_plain_matches_pallas(config, dtype):
    atol = ATOL_BF16 if dtype == "bfloat16" else ATOL_F32["bucketed_mega"]
    for bucket, arrays in _bucketed(12).items():
        n = arrays[0].shape[0]
        block = max(8, -(-n // 8) * 8)
        padded = [np.asarray(jops._pad_batch(jnp.asarray(x), block)[0])
                  for x in arrays]
        want = np.asarray(jax_fused(*map(jnp.asarray, padded),
                                    *_weights(_jparams(config, dtype)),
                                    block_pairs=block))
        got = fused_pair_score(*map(_t, padded),
                               *_weights(_tparams(config, dtype))).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_fused_pair_oversize_bucket():
    rng = np.random.default_rng(9)
    g = random_graph(rng, 70)
    (b, (lhs, rhs, _)), = jb.bucket_pairs([(g, random_graph(rng, 12))], 29,
                                          allow_oversize=True).items()
    assert b == 128
    arrays = [np.asarray(x) for x in (lhs.adj, lhs.feats, lhs.mask,
                                      rhs.adj, rhs.feats, rhs.mask)]
    want = np.asarray(jops.pair_score_megakernel(_jparams(), *arrays))
    got = tops.pair_score_megakernel(_tparams(), *map(_t, arrays),
                                     device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL_F32["bucketed_mega"])


def test_ops_wrappers_match_jax_wrappers():
    """The ops wrappers give the same [T, P] blocks as the JAX wrappers
    with `quantize_tiles` as the JAX engine calls them: the port passes the
    tiles unpadded, the JAX wrappers pad them and slice the pad off."""
    pairs = list(_pairs(12))
    jp, _ = jb.pack_pairs(pairs, 64, slots_per_tile=16, with_edges=True,
                          edge_budget=256)
    tp, _ = tb.pack_pairs(pairs, 64, slots_per_tile=16, with_edges=True,
                          edge_budget=256, device="cpu")
    for jfn, tfn, atol in ((jops.pair_score_sparse, tops.pair_score_sparse,
                            ATOL_F32["packed_sparse"]),
                           (jops.pair_score_packed, tops.pair_score_packed,
                            ATOL_F32["packed_dense"])):
        want = np.asarray(jfn(_jparams(), jp, quantize_tiles=True))
        got = tfn(_tparams(), tp, device="cpu").numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # Without edges the sparse wrapper extracts them itself.
    want = np.asarray(jops.pair_score_sparse(_jparams(), jp._replace(
        edges=None)))
    got = tops.pair_score_sparse(_tparams(), tp._replace(edges=None),
                                 device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL_F32["packed_sparse"])


def test_cpu_wrappers_launch_nothing_and_cuda_requests_raise():
    """CPU tensors take the plain version and never count a launch; asking
    an entry point for the card where there is none raises (no silent CPU
    fallback)."""
    counts = [k.launches for k in (sparse_pair_score, packed_pair_score,
                                   fused_pair_score)]
    _sparse_scores("batch7")
    _packed_scores("batch7")
    assert counts == [k.launches for k in (sparse_pair_score,
                                           packed_pair_score,
                                           fused_pair_score)]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    packed, _ = tb.pack_pairs(list(_pairs(7)), 64, slots_per_tile=16,
                              with_edges=True, device="cpu")
    for fn in (tops.pair_score_sparse, tops.pair_score_packed):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(_tparams(), packed, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(_tparams(), packed)                      # None = the card
    lhs, rhs, _ = tb.bucket_pairs(list(_pairs(7)), 29, allow_oversize=True,
                                  device="cpu")[64]
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.pair_score_megakernel(_tparams(), lhs.adj, lhs.feats, lhs.mask,
                                   rhs.adj, rhs.feats, rhs.mask)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.pack_pairs(list(_pairs(7)), 64)


def test_params_struct_is_built_once_per_tree():
    """The kernels' by-value weights struct is reused while the tree's
    tensors are unchanged, and rebuilt after an in-place update or for
    another tree; bf16 leaves are upcast copies."""
    from repro_torch.kernels import build

    tp = _tparams()
    s1, keep1 = build.simgnn_params(tp, "cpu")
    s2, keep2 = build.simgnn_params(tp, "cpu")
    assert s2 is s1 and keep2 is keep1
    assert s1.gcn_w[0] == tp["gcn"][0]["w"].data_ptr()     # f32: no copy
    assert list(s1.gcn_dims)[:4] == [29, 128, 64, 32]
    assert (s1.n_gcn, s1.n_fcn, s1.ntn_k, s1.f_max) == (3, 3, 16, 128)
    tp["gcn"][1]["b"].add_(1.0)
    s3, _ = build.simgnn_params(tp, "cpu")
    assert s3 is not s1 and s3.gcn_b[1] == tp["gcn"][1]["b"].data_ptr()
    other = _tparams()
    assert build.simgnn_params(other, "cpu")[0] is not s3
    bf = _tparams(dtype="bfloat16")
    sb, keep_b = build.simgnn_params(bf, "cpu")
    assert all(t.dtype == torch.float32 for t in keep_b)
    assert sb.gcn_w[0] != bf["gcn"][0]["w"].data_ptr()
    deep = params_from_numpy(jax.tree.map(np.asarray, init_simgnn_params(
        jax.random.PRNGKey(0), SimGNNConfig(gcn_dims=(8,) * 9))), "cpu")
    with pytest.raises(ValueError, match="GCN"):
        build.simgnn_params(deep, "cpu")


# ---------------------------------------------------------- body twins

def _rand_edges(seed):
    """A packed batch's planes and a random HW block for the bodies."""
    pairs = list(_pairs(7, seed=200 + seed))
    packed, _ = jb.pack_pairs(pairs, 64, slots_per_tile=16, with_edges=True,
                              edge_budget=128)
    e = packed.edges
    hw = np.random.default_rng(seed).standard_normal(
        (packed.mask1.shape[0], 64, 24)).astype(np.float32)
    return packed, e, hw


def test_aggregation_bodies_match_jax():
    packed, e, hw = _rand_edges(0)
    ov = (e.overflow1.senders, e.overflow1.receivers, e.overflow1.weights)
    assert (np.asarray(ov[2]) != 0).any()
    want = np.asarray(jc._overflow_aggregate(*ov, jnp.asarray(hw)))
    got = tc._overflow_aggregate(*map(_t, ov), _t(hw)).numpy()
    np.testing.assert_allclose(got, want, **BODY_TOL)
    csr = (e.edges1.senders, e.edges1.weights) + ov
    want = np.asarray(jc._csr_aggregate(*csr, jnp.asarray(hw)))
    got = tc._csr_aggregate(*map(_t, csr), _t(hw)).numpy()
    np.testing.assert_allclose(got, want, **BODY_TOL)
    # The edge form equals the dense A' contraction.
    a_norm = tc.normalize_adjacency_block(_t(packed.adj1), _t(packed.mask1))
    np.testing.assert_allclose(got, torch.bmm(a_norm, _t(hw)).numpy(),
                               **BODY_TOL)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_gcn_bodies_match_jax(config):
    packed, e, _ = _rand_edges(1)
    jw = [(p["w"], p["b"]) for p in _jparams(config)["gcn"]]
    tw = tc.layer_pairs(_tparams(config)["gcn"])
    adj, mask, labels = (np.asarray(x) for x in (packed.adj1, packed.mask1,
                                                 packed.labels1))
    a_j = jc.normalize_adjacency_block(jnp.asarray(adj), jnp.asarray(mask))
    a_t = tc.normalize_adjacency_block(_t(adj), _t(mask))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=2.5e-7,
                               atol=0)
    want = np.asarray(jc.gcn_layers_block(a_j, None, jnp.asarray(mask), jw,
                                          labels=jnp.asarray(labels)))
    got = tc.gcn_layers_block(a_t, None, _t(mask), tw, labels=_t(labels))
    np.testing.assert_allclose(got.numpy(), want, **BODY_TOL)
    feats = np.eye(29, dtype=np.float32)[labels]
    got_f = tc.gcn_layers_block(a_t, _t(feats), _t(mask), tw)
    np.testing.assert_allclose(got_f.numpy(), want, **BODY_TOL)
    planes = (e.edges1.senders, e.edges1.weights, e.overflow1.senders,
              e.overflow1.receivers, e.overflow1.weights)
    want_e = np.asarray(jc.gcn_layers_edge_block(
        *planes, None, jnp.asarray(mask), jw, labels=jnp.asarray(labels)))
    got_e = tc.gcn_layers_edge_block(*map(_t, planes), None, _t(mask), tw,
                                     labels=_t(labels))
    np.testing.assert_allclose(got_e.numpy(), want_e, **BODY_TOL)
    att_j = _jparams(config)["att"]["w"]
    att_t = _tparams(config)["att"]["w"]
    np.testing.assert_allclose(
        tc.gcn_att_block(a_t, None, _t(mask), tw, att_t,
                         labels=_t(labels)).numpy(),
        np.asarray(jc.gcn_att_block(a_j, None, jnp.asarray(mask), jw, att_j,
                                    labels=jnp.asarray(labels))), **BODY_TOL)
    w1 = _tparams(config)["gcn"][0]["w"]
    lab = _t(labels).reshape(-1)
    assert torch.equal(tc.label_gather(w1, lab),
                       _t(jc.label_gather(jnp.asarray(w1.numpy()),
                                          jnp.asarray(lab.numpy()))))


def test_pooling_and_head_bodies_match_jax():
    packed, _, _ = _rand_edges(2)
    rng = np.random.default_rng(2)
    mask, seg = np.asarray(packed.mask1), np.asarray(packed.seg1)
    h = rng.standard_normal(mask.shape + (32,)).astype(np.float32)
    h *= mask[..., None]
    jp, tp = _jparams(), _tparams()
    assert torch.equal(tc.segment_onehot(_t(seg), _t(mask), 16),
                       _t(jc.segment_onehot(jnp.asarray(seg),
                                            jnp.asarray(mask), 16)))
    hg_t = tc.segment_att_pool_block(_t(h), _t(mask), _t(seg),
                                     tp["att"]["w"], 16)
    hg_j = jc.segment_att_pool_block(jnp.asarray(h), jnp.asarray(mask),
                                     jnp.asarray(seg), jp["att"]["w"], 16)
    np.testing.assert_allclose(hg_t.numpy(), np.asarray(hg_j), **BODY_TOL)
    np.testing.assert_allclose(
        tc.att_pool_block(_t(h), _t(mask), tp["att"]["w"]).numpy(),
        np.asarray(jc.att_pool_block(jnp.asarray(h), jnp.asarray(mask),
                                     jp["att"]["w"])), **BODY_TOL)
    h1, h2 = hg_t.reshape(-1, 32)[:40], hg_t.reshape(-1, 32)[40:80]
    k = 16
    wt_j = jnp.transpose(jp["ntn"]["w"], (1, 0, 2)).reshape(32, k * 32)
    want = np.asarray(jc.ntn_fcn_block(
        jnp.asarray(h1.numpy()), jnp.asarray(h2.numpy()), wt_j,
        jp["ntn"]["v"].T, jp["ntn"]["b"],
        [(p["w"], p["b"]) for p in jp["fcn"]]))
    got = tc.ntn_fcn_block(h1, h2, *tc.ntn_operands(tp["ntn"], 32),
                           tc.layer_pairs(tp["fcn"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL_F32["packed_sparse"])
