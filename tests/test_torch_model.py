"""The PyTorch port's plain model (`repro_torch.core.gcn`,
`repro_torch.core.simgnn`) against the JAX package's on the same inputs and
converted params.

Bounds: `normalized_adjacency` within 2 ulp (XLA's CPU rsqrt is not
correctly rounded, see tests/test_torch_batching.py); post-sigmoid scores
within the parity matrix's f32 reference bound (1e-6) and its bf16 band
(2e-2), both read from tests/test_parity_matrix.py; GCN activations and
embeddings within rtol 1e-5 / atol 1e-6 (float32 sums taken in another
order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gcn as jgcn
from repro.core import simgnn as jsim
from repro.core.batching import bucket_pairs as jax_bucket_pairs
from repro_torch.core import gcn as tgcn
from repro_torch.core import simgnn as tsim
from repro_torch.core.batching import bucket_pairs
from repro_torch.data.graphs import random_graph
from repro_torch.params import params_from_numpy
from test_parity_matrix import ATOL_BF16, ATOL_F32

CONFIGS = {"aids": {}, "narrow": {"gcn_dims": (16, 8, 8, 4)}}


@functools.lru_cache(maxsize=None)
def _jparams(config="aids", dtype="float32"):
    p = jsim.init_simgnn_params(jax.random.PRNGKey(0),
                                jsim.SimGNNConfig(**CONFIGS[config]))
    if dtype == "bfloat16":
        p = jax.tree.map(lambda x: x.astype(jnp.bfloat16), p)
    return p


def _tparams(config="aids", dtype="float32"):
    return params_from_numpy(jax.tree.map(np.asarray,
                                          _jparams(config, dtype)), "cpu")


@functools.lru_cache(maxsize=None)
def _pairs(batch: int):
    rng = np.random.default_rng(100 + batch)
    return tuple((random_graph(rng, int(rng.integers(5, 65))),
                  random_graph(rng, int(rng.integers(5, 65))))
                 for _ in range(batch))


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_block(seed, b=5, n=16):
    """Random symmetric adjacency with isolated and pad nodes."""
    rng = np.random.default_rng(seed)
    adj = np.triu((rng.random((b, n, n)) < 0.25).astype(np.float32), 1)
    adj = adj + adj.transpose(0, 2, 1)
    mask = np.ones((b, n), np.float32)
    mask[0, 10:] = 0.0
    mask[1, :] = 0.0
    adj[2, 3, :] = adj[2, :, 3] = 0.0            # isolated node
    return adj * mask[:, :, None] * mask[:, None, :], mask


@pytest.mark.parametrize("seed", (0, 1))
def test_normalized_adjacency_within_2ulp(seed):
    adj, mask = _random_block(seed)
    want = np.asarray(jgcn.normalized_adjacency(jnp.asarray(adj),
                                                jnp.asarray(mask)))
    got = tgcn.normalized_adjacency(_t(adj), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    assert ((got != 0) == (want != 0)).all()
    assert (got[1] == 0).all()                   # all-pad graph


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_gcn_stacks_match_jax(config):
    adj, mask = _random_block(3)
    labels = np.random.default_rng(3).integers(0, 29, mask.shape).astype(
        np.int32)
    feats = np.eye(29, dtype=np.float32)[labels]
    jp, tp = _jparams(config), _tparams(config)
    a_j = jgcn.normalized_adjacency(jnp.asarray(adj), jnp.asarray(mask))
    a_t = tgcn.normalized_adjacency(_t(adj), _t(mask))
    want = np.asarray(jgcn.gcn_stack(jp["gcn"], a_j, jnp.asarray(feats),
                                     jnp.asarray(mask)))
    got = tgcn.gcn_stack(tp["gcn"], a_t, _t(feats), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want_l = np.asarray(jgcn.gcn_stack_from_labels(
        jp["gcn"], a_j, jnp.asarray(labels), jnp.asarray(mask)))
    got_l = tgcn.gcn_stack_from_labels(tp["gcn"], a_t, _t(labels),
                                       _t(mask)).numpy()
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_l, got, rtol=1e-5, atol=1e-6)


def test_pooling_and_head_match_jax():
    rng = np.random.default_rng(4)
    h = rng.standard_normal((6, 12, 32)).astype(np.float32)
    mask = (rng.random((6, 12)) < 0.8).astype(np.float32)
    hg1 = rng.standard_normal((6, 32)).astype(np.float32)
    hg2 = rng.standard_normal((6, 32)).astype(np.float32)
    jp, tp = _jparams(), _tparams()
    np.testing.assert_allclose(
        tsim.attention_pooling(tp["att"], _t(h), _t(mask)).numpy(),
        np.asarray(jsim.attention_pooling(jp["att"], h, mask)),
        rtol=1e-5, atol=1e-6)
    s_t = tsim.ntn_scores(tp["ntn"], _t(hg1), _t(hg2))
    s_j = jsim.ntn_scores(jp["ntn"], hg1, hg2)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tsim.fcn_head(tp["fcn"], s_t).numpy(),
                               np.asarray(jsim.fcn_head(jp["fcn"], s_j)),
                               rtol=0, atol=ATOL_F32["reference"])


def _score_buckets(batch, fn_j, fn_t, jp, tp, labels: bool):
    pairs = list(_pairs(batch))
    got = np.zeros(batch, np.float32)
    want = np.zeros(batch, np.float32)
    jb = jax_bucket_pairs(pairs, 29, allow_oversize=True)
    for b, (lhs, rhs, idxs) in bucket_pairs(pairs, 29, allow_oversize=True,
                                            device="cpu").items():
        jl, jr, _ = jb[b]
        x = "labels" if labels else "feats"
        got[idxs] = fn_t(tp, lhs.adj, getattr(lhs, x), lhs.mask,
                         rhs.adj, getattr(rhs, x), rhs.mask).numpy()
        want[idxs] = np.asarray(fn_j(jp, jl.adj, getattr(jl, x), jl.mask,
                                     jr.adj, getattr(jr, x), jr.mask))
    return got, want


@pytest.mark.parametrize("labels", (False, True))
@pytest.mark.parametrize("batch", (7, 12))
def test_pair_scores_match_jax(batch, labels):
    fn_j = jsim.pair_score_from_labels if labels else jsim.pair_score
    fn_t = tsim.pair_score_from_labels if labels else tsim.pair_score
    got, want = _score_buckets(batch, fn_j, fn_t, _jparams(), _tparams(),
                               labels)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL_F32["reference"])


def test_pair_scores_bf16_and_narrow_config():
    got, want = _score_buckets(7, jsim.pair_score, tsim.pair_score,
                               _jparams(dtype="bfloat16"),
                               _tparams(dtype="bfloat16"), False)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_BF16)
    got, want = _score_buckets(7, jsim.pair_score_from_labels,
                               tsim.pair_score_from_labels,
                               _jparams("narrow"), _tparams("narrow"), True)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL_F32["reference"])
