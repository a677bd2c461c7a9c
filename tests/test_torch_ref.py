"""The JAX package's jnp oracles (`repro.kernels.ref`) against the port's
plain versions on the CPU.

The port has no `ref` module: the plain PyTorch version beside each CUDA
kernel (`fused_gcn_att_plain`, `simgnn_head_plain`,
`flash_attention_plain`, `wkv6_plain`) is its oracle, the one
`chip_smoke.py` holds every kernel against on the card. These tests hold
those plain versions against the four `repro.kernels.ref` oracles on the
same inputs (numpy, from a seed), within the bounds the port's tests of
each kernel use: scores within the parity table's f32 bound
(`tests/test_parity_matrix.py`), embeddings within the kernel bodies'
(rtol 1e-5, atol 1e-6), attention within `FLASH_TOL` (the blocked softmax
sums in another order) and the wkv recurrence within `SCAN_TOL`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.simgnn import SimGNNConfig, init_simgnn_params
from repro.kernels import ref
from repro_torch.kernels.flash_attn import flash_attention_plain
from repro_torch.kernels.fused_gcn import fused_gcn_att_plain
from repro_torch.kernels.simgnn_head import simgnn_head_plain
from repro_torch.kernels.wkv6 import wkv6_plain
from repro_torch.params import params_from_numpy
from test_parity_matrix import ATOL_F32
from test_torch_flash import FLASH_TOL
from test_torch_ssm import SCAN_TOL

BODY_TOL = dict(rtol=1e-5, atol=1e-6)
CONFIGS = {"aids": SimGNNConfig(), "narrow": SimGNNConfig(
    gcn_dims=(16, 8, 8, 4))}


def _params(name: str):
    p = init_simgnn_params(jax.random.PRNGKey(0), CONFIGS[name])
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _close(got: torch.Tensor, want, tol) -> None:
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                               **tol)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fused_gcn_att_plain_matches_the_oracle(config):
    """Embeddings of 5 graphs padded to 16 nodes (a symmetric normalised
    adjacency, one-hot labels, the mask's tail empty)."""
    rng = np.random.default_rng(1)
    b, n, f0 = 5, 16, CONFIGS[config].n_node_labels
    sizes = rng.integers(3, n + 1, b)
    mask = (np.arange(n)[None, :] < sizes[:, None]).astype(np.float32)
    a = (rng.random((b, n, n)) < 0.3).astype(np.float32)
    a = np.maximum(a, a.transpose(0, 2, 1)) + np.eye(n, dtype=np.float32)
    a *= mask[:, :, None] * mask[:, None, :]
    deg = np.maximum(a.sum(-1), 1.0)
    adj = (a / np.sqrt(deg[:, :, None] * deg[:, None, :])).astype(np.float32)
    feats = np.eye(f0, dtype=np.float32)[rng.integers(0, f0, (b, n))]
    feats *= mask[..., None]
    jp, tp = _params(config)
    want = ref.fused_gcn_att_ref(jnp.asarray(adj), jnp.asarray(feats),
                                 jnp.asarray(mask), jp["gcn"], jp["att"]["w"])
    got = fused_gcn_att_plain(torch.from_numpy(adj), torch.from_numpy(feats),
                              torch.from_numpy(mask), tp["gcn"],
                              tp["att"]["w"])
    _close(got, want, BODY_TOL)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_simgnn_head_plain_matches_the_oracle(config):
    rng = np.random.default_rng(2)
    f = CONFIGS[config].gcn_dims[-1]
    h1, h2 = (rng.standard_normal((33, f)).astype(np.float32)
              for _ in range(2))
    jp, tp = _params(config)
    want = ref.simgnn_head_ref(jnp.asarray(h1), jnp.asarray(h2), jp["ntn"],
                               jp["fcn"])
    got = simgnn_head_plain(torch.from_numpy(h1), torch.from_numpy(h2),
                            tp["ntn"], tp["fcn"])
    _close(got, want, dict(rtol=0, atol=ATOL_F32["reference"]))


@pytest.mark.parametrize("case", ("causal", "window", "softcap", "dense"))
def test_flash_attention_plain_matches_the_oracle(case):
    """GQA (8 heads over 2 KV heads), T 40 against S 40."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 40, 8, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
            for _ in range(2))
    opts = {"causal": dict(causal=True), "window": dict(causal=True,
                                                         window=7),
            "softcap": dict(causal=True, softcap=5.0),
            "dense": dict(causal=False)}[case]
    want = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **opts)
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **opts)
    _close(got, want, FLASH_TOL)


def test_wkv6_plain_matches_the_oracle():
    """B 2, T 24, H 3, K = V 8; decays in (0, 1)."""
    rng = np.random.default_rng(4)
    r, k, v = (rng.standard_normal((2, 24, 3, 8)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.5, 0.99, (2, 24, 3, 8)).astype(np.float32)
    u = rng.standard_normal((3, 8)).astype(np.float32) * 0.5
    want = ref.wkv6_ref(*(jnp.asarray(x) for x in (r, k, v, w, u)))
    got = wkv6_plain(*(torch.from_numpy(x) for x in (r, k, v, w, u)))
    _close(got, want, SCAN_TOL)
