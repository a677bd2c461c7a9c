"""The search slice's kernel modules of the PyTorch port against the JAX
package's Pallas kernels (interpret mode, as the JAX tests run them on the
CPU): `kernels/fused_gcn.py`, `kernels/simgnn_head.py`,
`kernels/retrieval.py` and the new `kernels/ops.py` wrappers.

On CPU tensors every wrapper runs its plain PyTorch version, which is what
is held here against the JAX kernels on the same numpy inputs; the CUDA
kernels are held against the plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).

Bounds: embeddings rtol 1e-5 / atol 1e-6 (float32 sums in another order);
head scores 1e-6; the two-kernel path 2e-5 (tests/test_parity_matrix.py);
top-M scores rtol 1e-5 / atol 1e-6, top-M indices exact on inputs whose
score gaps are wider than that (duplicated rows give exact ties); the
numpy helpers (query collapse, calibration, references) equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batching as jb
from repro.core.gcn import normalized_adjacency as jax_norm
from repro.core.simgnn import SimGNNConfig, init_simgnn_params
from repro.data.graphs import random_graph
from repro.kernels import ops as jops
from repro.kernels import retrieval as jr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import retrieval as tr
from repro_torch.kernels.fused_gcn import fused_gcn_att
from repro_torch.kernels.simgnn_head import simgnn_head
from repro_torch.params import params_from_numpy
from test_parity_matrix import ATOL_F32

CONFIGS = {"aids": {}, "narrow": {"gcn_dims": (16, 8, 8, 4)}}
BODY_TOL = dict(rtol=1e-5, atol=1e-6)
ATOL_HEAD = 1e-6


@functools.lru_cache(maxsize=None)
def _jparams(config="aids"):
    return init_simgnn_params(jax.random.PRNGKey(0),
                              SimGNNConfig(**CONFIGS[config]))


def _tparams(config="aids"):
    return params_from_numpy(jax.tree.map(np.asarray, _jparams(config)),
                             "cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _emb(rng, n, f=32):
    return rng.standard_normal((n, f)).astype(np.float32)


# ------------------------------------------------------ embeddings + head

@functools.lru_cache(maxsize=None)
def _embed_batch(bucket: int):
    """JAX package's padded batch of one bucket and its A', as numpy."""
    rng = np.random.default_rng(bucket)
    lo = {8: 3, 16: 9, 32: 17, 64: 33, 128: 65}[bucket]
    graphs = [random_graph(rng, int(rng.integers(lo, bucket + 1)))
              for _ in range(5)]
    batch = jb.pad_graphs(graphs, 29, bucket)
    a = jax_norm(batch.adj, batch.mask)
    return tuple(np.asarray(x) for x in (a, batch.feats, batch.mask))


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("bucket", (8, 32, 64, 128))
def test_fused_gcn_plain_matches_pallas(config, bucket):
    arrays = _embed_batch(bucket)
    want = np.asarray(jops.graph_embeddings_fused(
        _jparams(config), *map(jnp.asarray, arrays)))
    tp = _tparams(config)
    before = fused_gcn_att.launches
    got = tops.graph_embeddings_fused(tp, *map(_t, arrays), device="cpu")
    assert fused_gcn_att.launches == before        # CPU: the plain version
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **BODY_TOL)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_simgnn_head_plain_matches_pallas(config):
    f = SimGNNConfig(**CONFIGS[config]).gcn_dims[-1]
    rng = np.random.default_rng(1)
    h1, h2 = _emb(rng, 13, f), _emb(rng, 13, f)
    h2[4] = np.nan                                 # a dropped embedding
    want = np.asarray(jops.pair_scores_fused(
        _jparams(config), jnp.asarray(h1), jnp.asarray(h2), block_pairs=8))
    before = simgnn_head.launches
    got = tops.pair_scores_fused(_tparams(config), _t(h1), _t(h2),
                                 device="cpu").numpy()
    assert simgnn_head.launches == before
    assert got.shape == (13,) and np.isnan(got[4])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_HEAD)


def test_two_kernel_wrapper_matches_jax():
    rng = np.random.default_rng(2)
    pairs = [(random_graph(rng, int(rng.integers(5, 33))),
              random_graph(rng, int(rng.integers(5, 33)))) for _ in range(6)]
    lhs, rhs, _ = jb.bucket_pairs(pairs, 29)[32]
    arrays = [np.asarray(x) for x in (lhs.adj, lhs.feats, lhs.mask,
                                      rhs.adj, rhs.feats, rhs.mask)]
    want = np.asarray(jops.simgnn_pair_score_kernel(
        _jparams(), *map(jnp.asarray, arrays)))
    got = tops.simgnn_pair_score_kernel(_tparams(), *map(_t, arrays),
                                        device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL_F32["two_kernel"])


# ------------------------------------------------------------ top-M scans

def _check_topm(got, want):
    (gs, gi), (ws, wi) = got, want
    gs, gi = gs.numpy(), gi.numpy()
    assert gi.dtype == np.int32 and gs.dtype == np.float32
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_allclose(gs, np.asarray(ws), **BODY_TOL)
    assert np.isfinite(gs).all() and np.all(np.diff(gs, axis=1) <= 0)


@pytest.mark.parametrize("m", [1, 10, 137, 200])
def test_blocked_topm_plain_matches_pallas(m):
    rng = np.random.default_rng(0)
    qv, corpus = _emb(rng, 5), _emb(rng, 137)     # N not a block multiple
    corpus[60:80] = corpus[:20]                   # exact ties
    want = jr.blocked_topm(qv, corpus, m, block_cols=32)
    before = tr.blocked_topm.launches
    got = tr.blocked_topm(_t(qv), _t(corpus), m, block_cols=32)
    assert tr.blocked_topm.launches == before
    assert got[0].shape == (5, min(m, 137))
    _check_topm(got, want)
    _check_topm(got, tr.topm_reference(qv, corpus, m))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_blocked_topm_ntn_plain_matches_pallas(config):
    f = SimGNNConfig(**CONFIGS[config]).gcn_dims[-1]
    rng = np.random.default_rng(3)
    hq, corpus = _emb(rng, 4, f), _emb(rng, 100, f)
    corpus[50:60] = corpus[:10]
    jp, tp = _jparams(config), _tparams(config)
    uq, dq = jr.collapse_query_ntn(jp["ntn"], hq)
    tuq, tdq = tr.collapse_query_ntn(tp["ntn"], hq)
    np.testing.assert_array_equal(tuq, uq)
    np.testing.assert_array_equal(tdq, dq)
    want = jr.blocked_topm_ntn(uq, dq, corpus, jp["fcn"], 60, block_cols=32)
    before = tr.blocked_topm_ntn.launches
    got = tr.blocked_topm_ntn(_t(uq), _t(dq), _t(corpus), tp["fcn"], 60,
                              block_cols=32)
    assert tr.blocked_topm_ntn.launches == before
    _check_topm(got, want)
    _check_topm(got, tr.ntn_logit_reference(uq, dq, corpus, tp["fcn"], 60))


@pytest.mark.parametrize("kind", ("dot", "ntn"))
def test_topm_nan_rows_rank_last_and_all_nan(kind):
    """NaN rows surface last with the finite sentinel, never as NaN and
    never displaced by pad columns; an all-NaN corpus ranks in ascending
    index order."""
    rng = np.random.default_rng(1)
    jp, tp = _jparams(), _tparams()

    def scan(qv, corpus, m, block):
        if kind == "dot":
            return (jr.blocked_topm(qv, corpus, m, block_cols=block),
                    tr.blocked_topm(_t(qv), _t(corpus), m, block_cols=block))
        uq, dq = jr.collapse_query_ntn(jp["ntn"], qv)
        return (jr.blocked_topm_ntn(uq, dq, corpus, jp["fcn"], m,
                                    block_cols=block),
                tr.blocked_topm_ntn(_t(uq), _t(dq), _t(corpus), tp["fcn"],
                                    m, block_cols=block))

    qv, corpus = _emb(rng, 3), _emb(rng, 40)
    corpus[[4, 17, 31]] = np.nan
    want, got = scan(qv, corpus, 40, 16)
    _check_topm(got, want)
    np.testing.assert_array_equal(np.sort(got[1].numpy()[:, -3:], axis=1),
                                  [[4, 17, 31]] * 3)
    np.testing.assert_allclose(got[0].numpy()[:, -3:], tr.NEG_FILL)
    want, got = scan(qv, np.full((12, 32), np.nan, np.float32), 4, 8)
    _check_topm(got, want)
    np.testing.assert_array_equal(got[1].numpy(), [[0, 1, 2, 3]] * 3)


def test_topm_guard_shapes_and_empty_match_jax():
    rng = np.random.default_rng(5)
    qv, corpus = _emb(rng, 2), _emb(rng, 64)
    uq, dq = tr.collapse_query_ntn(_tparams()["ntn"], qv)
    fcn = _tparams()["fcn"]
    with pytest.raises(ValueError, match="materializes"):
        tr.blocked_topm(_t(qv), _t(corpus), 8, block_cols=4096)
    with pytest.raises(ValueError, match="materializes"):
        tr.blocked_topm_ntn(_t(uq), _t(dq), _t(corpus), fcn, 8,
                            block_cols=2048)
    with pytest.raises(ValueError, match="shape mismatch"):
        tr.blocked_topm(_t(qv), _t(_emb(rng, 4, 33)), 2)
    with pytest.raises(ValueError, match=r"not \[Q, K\*F\]"):
        tr.blocked_topm_ntn(torch.zeros((2, 7)), _t(dq), _t(corpus), fcn, 2)
    for q, n in ((0, 4), (2, 0)):
        s, i = tr.blocked_topm(torch.zeros((q, 32)), torch.zeros((n, 32)), 2)
        js, ji = jr.blocked_topm(np.zeros((q, 32), np.float32),
                                 np.zeros((n, 32), np.float32), 2)
        assert s.shape == i.shape == js.shape == (q, 0)
        assert i.dtype == torch.int32
    for n, shard in ((100_000, 256), (512, 1024), (1 << 20, 8192),
                     (300, None), (3, None), (1 << 20, None), (9, 6)):
        assert (tr.retrieval_block_cols(n, shard_rows=shard)
                == jr.retrieval_block_cols(n, shard_rows=shard))
    assert (tr.RETRIEVAL_MAX_BLOCK_COLS, tr.NEG_FILL) == (
        jr.RETRIEVAL_MAX_BLOCK_COLS, jr.NEG_FILL)


def test_calibration_functions_match_jax():
    """The proxy's numpy helpers give the JAX functions' outputs on the
    same inputs (tensor or numpy NTN weights alike)."""
    rng = np.random.default_rng(7)
    jw = np.asarray(_jparams()["ntn"]["w"])
    tw = _tparams()["ntn"]["w"]
    hq, hc = _emb(rng, 64), _emb(rng, 64)
    y = rng.uniform(0.05, 0.95, 64)
    y[:3] = np.nan
    want = jr.fit_prefilter_calibration(jw, hq, hc, y)
    got = tr.fit_prefilter_calibration(tw, hq, hc, y)
    assert got.keys() == want.keys()
    for key in ("alpha", "beta"):
        np.testing.assert_array_equal(got[key], want[key])
    assert (got["r2"], got["n_samples"]) == (want["r2"], want["n_samples"])
    np.testing.assert_array_equal(
        tr.prefilter_query_vectors(tw, hq[:5], got),
        jr.prefilter_query_vectors(jw, hq[:5], want))
    for a, b in zip(tr.topm_reference(hq, hc, 10),
                    jr.topm_reference(hq, hc, 10)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="finite calibration pairs"):
        tr.fit_prefilter_calibration(tw, hq[:16], hc[:16], y[:16])
