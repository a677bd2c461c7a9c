"""The port's per-graph edge lists (`core.batching.to_edge_batch`,
`edge_aggregate`) against the JAX package's, on the CPU: index planes and
masks bit-equal, A' weights within 2 ulp (XLA's CPU rsqrt, see
`repro_torch.core.gcn`), the aggregation within 1e-6 (float32), the budget
growing to a power of two with one warning per distinct growth, and
`reset_grow_warnings` re-arming it.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batching as jbatching
from repro_torch.core import batching as tbatching
from repro_torch.data.graphs import random_graph

#: float32 bound on the aggregation against the JAX package's.
AGG_ATOL = 1e-6


def _graphs(seed, n, max_n=24, avg_degree=None):
    rng = np.random.default_rng(seed)
    return [random_graph(rng, int(rng.integers(3, max_n + 1)),
                         avg_degree=avg_degree) for _ in range(n)]


def _both(graphs, bucket, max_edges):
    tb = tbatching.pad_graphs(graphs, 29, bucket, device="cpu")
    jb = jbatching.pad_graphs(graphs, 29, bucket)
    return (tbatching.to_edge_batch(tb, max_edges),
            jbatching.to_edge_batch(jb, max_edges), tb, jb)


@pytest.mark.parametrize("seed,degree", ((0, None), (1, 2.0), (2, 6.0)))
def test_to_edge_batch_matches_jax(seed, degree):
    graphs = _graphs(seed, 7, avg_degree=degree)
    tbatching.reset_grow_warnings()
    jbatching.reset_grow_warnings()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        te, je, _, _ = _both(graphs, 32, 1024)
    for name in ("senders", "receivers", "edge_mask"):
        got, want = getattr(te, name).numpy(), np.asarray(getattr(je, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    ulp = np.spacing(np.abs(np.asarray(je.weights)))
    assert (np.abs(te.weights.numpy() - np.asarray(je.weights))
            <= 2 * ulp).all()
    assert te.edge_budget == je.edge_budget == 1024


@pytest.mark.parametrize("seed", range(3))
def test_edge_aggregate_matches_jax(seed):
    graphs = _graphs(10 + seed, 6)
    te, je, tb, _ = _both(graphs, 32, 512)
    hw = np.random.default_rng(seed).normal(size=(6, 32, 8)).astype(
        np.float32)
    got = tbatching.edge_aggregate(te, torch.from_numpy(hw)).numpy()
    want = np.asarray(jbatching.edge_aggregate(je, jnp.asarray(hw)))
    np.testing.assert_allclose(got, want, rtol=0, atol=AGG_ATOL)
    # and it is A' @ hw (pad rows and columns exactly zero)
    from repro_torch.core.gcn import normalized_adjacency

    dense = torch.bmm(normalized_adjacency(tb.adj, tb.mask),
                      torch.from_numpy(hw)).numpy()
    np.testing.assert_allclose(got, dense, rtol=0, atol=AGG_ATOL)


def test_edge_aggregate_is_differentiable():
    graphs = _graphs(20, 4)
    te, _, _, _ = _both(graphs, 32, 512)
    hw = torch.randn((4, 32, 8), generator=torch.Generator().manual_seed(0),
                     requires_grad=True)
    out = tbatching.edge_aggregate(te, hw)
    (d_hw,) = torch.autograd.grad(out.sum(), hw)
    assert torch.isfinite(d_hw).all()


def test_grow_warns_once_per_distinct_growth():
    graphs = _graphs(30, 5, max_n=24, avg_degree=6.0)
    tbatching.reset_grow_warnings()
    jbatching.reset_grow_warnings()
    tb = tbatching.pad_graphs(graphs, 29, 32, device="cpu")
    jb = jbatching.pad_graphs(graphs, 29, 32)
    for mod, batch in ((tbatching, tb), (jbatching, jb)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            first = mod.to_edge_batch(batch, 8)
            again = mod.to_edge_batch(batch, 8)
        grow = [w for w in caught if issubclass(w.category, RuntimeWarning)
                and "growing the edge budget" in str(w.message)]
        assert len(grow) == 1, mod
        assert first.edge_budget == again.edge_budget > 8
        assert first.edge_budget & (first.edge_budget - 1) == 0
    assert tbatching.to_edge_batch(tb, 8).edge_budget == \
        jbatching.to_edge_batch(jb, 8).edge_budget
    tbatching.reset_grow_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tbatching.to_edge_batch(tb, 8)
    assert sum("growing the edge budget" in str(w.message)
               for w in caught) == 1
