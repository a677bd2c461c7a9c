"""Params bridge of the PyTorch port (`repro_torch.params`) against the JAX
package's parameter trees: the numpy -> tensor -> numpy round trip keeps
leaf order, shapes, dtypes and bits, bf16 included, and the port's own
initializer builds the same tree structure as `init_simgnn_params`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.simgnn import SimGNNConfig as JaxConfig
from repro.core.simgnn import init_simgnn_params as jax_init
from repro_torch.core.simgnn import SimGNNConfig, init_simgnn_params
from repro_torch.params import (params_from_numpy, params_to, params_to_numpy,
                                tree_leaves)

CONFIGS = {"aids": {}, "narrow": {"gcn_dims": (16, 8, 8, 4)}}


def _paths(tree, prefix=()):
    """(path, leaf) pairs in the tree's own order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _jax_numpy_params(config: str, dtype: str):
    p = jax_init(jax.random.PRNGKey(0), JaxConfig(**CONFIGS[config]))
    if dtype == "bfloat16":
        p = jax.tree.map(lambda x: x.astype(jnp.bfloat16), p)
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_params_round_trip_keeps_order_shape_dtype_bits(config, dtype):
    tree = _jax_numpy_params(config, dtype)
    params = params_from_numpy(tree, "cpu")
    want_torch = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert {t.dtype for t in tree_leaves(params)} == {want_torch}
    back = params_to_numpy(params)
    src, out = _paths(tree), _paths(back)
    assert [p for p, _ in src] == [p for p, _ in out]
    for (path, a), (_, b) in zip(src, out):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert a.tobytes() == b.tobytes(), path
    # JAX flattens the round-tripped tree into the same leaves, in order.
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.tobytes() == b.tobytes()


def test_params_to_moves_and_casts_every_leaf():
    params = params_from_numpy(_jax_numpy_params("aids", "bfloat16"), "cpu")
    f32 = params_to(params, "cpu", torch.float32)
    assert [p for p, _ in _paths(f32)] == [p for p, _ in _paths(params)]
    for a, b in zip(tree_leaves(params), tree_leaves(f32)):
        assert b.dtype == torch.float32
        assert torch.equal(a.float(), b)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_port_init_matches_jax_tree_structure(config):
    """Same keys, list lengths, shapes and dtype as the JAX initializer;
    the numbers differ by design (torch.Generator, not jax.random)."""
    cfg = SimGNNConfig(**CONFIGS[config])
    ours = init_simgnn_params(torch.Generator().manual_seed(0), cfg)
    ref = jax_init(jax.random.PRNGKey(0), JaxConfig(**CONFIGS[config]))
    ref_paths = sorted((p, np.shape(x)) for p, x in _paths(
        jax.tree.map(np.asarray, ref)))
    our_paths = sorted((p, tuple(t.shape)) for p, t in _paths(ours))
    assert our_paths == ref_paths
    assert all(t.dtype == torch.float32 for t in tree_leaves(ours))
    again = init_simgnn_params(torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ours),
                                                 tree_leaves(again)))
