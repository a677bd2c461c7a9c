"""What a pad pair slot of `packed_pair_score` holds, on the CPU: the plain
version and the JAX kernel (interpret mode) return score x pair_mask, and
a pad slot's value is not a function of the weights alone.

With finite weights every pad slot is +0. With a NaN in one row of W1 (the
first GCN layer's weights, gathered by node label), a tile whose nodes
carry that label gets NaN in every pad slot: the dense products A'.HW and
the pooling S.(att h) multiply its NaN rows by zeros, which leaves NaN in
every row and slot of the tile's side. A tile with no such node keeps +0.
So the pad value depends on each tile's labels, and cannot be computed
once per weight image; the CUDA kernel, which writes +0 into pad slots,
is held to the plain version on live slots only
(`tests/test_torch_cuda.py`,
`test_packed_pair_kernel_keeps_the_plain_versions_nan`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.packed_pair import packed_pair_score as jax_packed
from repro_torch.core import batching
from repro_torch.core.simgnn import SimGNNConfig, init_simgnn_params
from repro_torch.data.graphs import random_graph
from repro_torch.kernels.packed_pair import packed_pair_score_plain


def _tiles():
    rng = np.random.default_rng(107)
    pairs = [(random_graph(rng, int(rng.integers(5, 65))),
              random_graph(rng, int(rng.integers(5, 65))))
             for _ in range(7)]
    packed, _ = batching.pack_pairs(pairs, 64, slots_per_tile=16,
                                    device="cpu")
    return [packed.adj1, packed.labels1, packed.mask1, packed.seg1,
            packed.adj2, packed.labels2, packed.mask2, packed.seg2,
            packed.pair_mask]


def _weights(nan_label=None):
    p = init_simgnn_params(torch.Generator().manual_seed(0), SimGNNConfig())
    gcn = [dict(layer) for layer in p["gcn"]]
    if nan_label is not None:
        gcn[0]["w"] = gcn[0]["w"].clone()
        gcn[0]["w"][nan_label, 5] = float("nan")
    return gcn, p["att"]["w"], p["ntn"], p["fcn"]


def _labels_of(dense, t):
    return set(torch.cat([dense[1][t][dense[2][t] > 0],
                          dense[5][t][dense[6][t] > 0]]).tolist())


def test_pad_slots_are_plus_zero_under_finite_weights():
    dense = _tiles()
    out = packed_pair_score_plain(*dense, *_weights())
    pad = dense[8] == 0
    assert pad.any() and (out[pad] == 0).all()
    assert not torch.signbit(out[pad]).any()


@pytest.mark.parametrize("impl", ("plain", "jax"))
def test_pad_slot_value_depends_on_the_tiles_labels(impl):
    dense = _tiles()
    t_count = dense[2].shape[0]
    labels = [_labels_of(dense, t) for t in range(t_count)]
    # a label some tiles hold and some do not (pad nodes carry label 0)
    label = next(lab for lab in range(1, 29)
                 if 0 < sum(lab in s for s in labels) < t_count)
    weights = _weights(label)
    if impl == "plain":
        out = packed_pair_score_plain(*dense, *weights).numpy()
    else:
        def j(x):
            return jnp.asarray(x.numpy())
        gcn, att, ntn, fcn = weights
        out = np.asarray(jax_packed(
            *map(j, dense), [{k: j(v) for k, v in d.items()} for d in gcn],
            j(att), {k: j(v) for k, v in ntn.items()},
            [{k: j(v) for k, v in d.items()} for d in fcn], tile_block=1))
    pad = (dense[8] == 0).numpy()
    for t in range(t_count):
        pads = out[t][pad[t]]
        assert pads.size
        if label in labels[t]:
            assert np.isnan(pads).all(), t
        else:
            assert (pads == 0).all() and not np.signbit(pads).any(), t
