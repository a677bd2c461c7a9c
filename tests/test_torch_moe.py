"""The port's MoE layer (`repro_torch.models.moe`) and the plain version of
its expert kernel (`repro_torch.kernels.moe_experts`) against the JAX
package on the same numpy inputs.

Bounds:
  * expert FFN, float32: rtol 1e-5 / atol 1e-6, the JAX kernel sweep's
    bound (tests/test_kernels.py), against the Pallas kernel in interpret
    mode; bfloat16: both sides compute in float32 and round once, so one
    bf16 ulp of the value, plus the float32 bound for the sums taken in
    another order (it matters only where |y| < 1e-4, where one bf16 ulp is
    below 1e-6);
  * routing: expert ids, dispatch slots, keep flags, capacities and the
    slot->token map bit-equal (ties included: `jax.lax.top_k` puts the
    lower index first); top-k weights and the aux loss within 1e-6;
  * `moe_ffn`: the port's kernel branch against the JAX kernel branch and
    its einsum branch against the JAX einsum branch, float32, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.kernels.moe_experts import moe_expert_ffn as jax_expert_ffn
from repro.models import moe as jmoe
from repro_torch.configs import reduced_config as port_reduced_config
from repro_torch.kernels.moe_experts import (moe_expert_ffn,
                                             moe_expert_ffn_plain)
from repro_torch.models import moe as tmoe
from repro_torch.params import params_from_numpy

F32_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    """numpy or JAX array -> CPU tensor (bfloat16 kept, bit for bit)."""
    return params_from_numpy(np.asarray(x))


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    _, ex = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), ex - 8)


def assert_within_bf16_ulp(got: torch.Tensor, want: torch.Tensor):
    got, want = got.float(), want.float()
    bound = bf16_ulp(want) + F32_TOL["atol"] + F32_TOL["rtol"] * want.abs()
    excess = float(((got - want).abs() - bound).max())
    assert excess <= 0, excess


def _expert_inputs(seed, e, c, d, f, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (e, c, d)).astype(np.float32)
    wi = (rng.standard_normal((e, d, 2 * f)) * 0.05).astype(np.float32)
    wo = (rng.standard_normal((e, f, d)) * 0.05).astype(np.float32)
    return x, wi, wo


# ------------------------------------------------------------ expert FFN

@pytest.mark.parametrize("e,c,d,f,bc", [(4, 128, 64, 32, 64),
                                        (8, 256, 128, 64, 128),
                                        (2, 128, 256, 512, 128)])
def test_expert_ffn_plain_matches_jax_kernel(e, c, d, f, bc):
    x, wi, wo = _expert_inputs(0, e, c, d, f)
    want = jax_expert_ffn(jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wo),
                          block_c=bc, interpret=True)
    got = moe_expert_ffn_plain(_t(x), _t(wi), _t(wo))
    assert got.dtype == torch.float32 and got.shape == (e, c, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_expert_ffn_plain_bf16_within_one_ulp_of_jax_kernel():
    e, c, d, f = 4, 128, 64, 32
    x, wi, wo = (jnp.asarray(a, jnp.bfloat16)
                 for a in _expert_inputs(1, e, c, d, f))
    want = jax_expert_ffn(x, wi, wo, block_c=64, interpret=True)
    got = moe_expert_ffn_plain(*(_t(a) for a in (x, wi, wo)))
    assert got.dtype == torch.bfloat16
    assert_within_bf16_ulp(got, _t(want))


def test_expert_ffn_batch_dim_is_per_sequence_and_cpu_runs_plain():
    """[B, E, C, D] is B sequences' [E, C, D] buffers (what the JAX model
    vmaps the kernel over); on CPU tensors the wrapper is the plain
    version and counts no launch."""
    x, wi, wo = _expert_inputs(2, 3, 5, 16, 8, lead=(2,))
    before = moe_expert_ffn.launches
    got = moe_expert_ffn(_t(x), _t(wi), _t(wo))
    assert moe_expert_ffn.launches == before
    for b in range(2):
        want = jax_expert_ffn(jnp.asarray(x[b]), jnp.asarray(wi),
                              jnp.asarray(wo), block_c=5, interpret=True)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   **F32_TOL)


# --------------------------------------------------------------- routing

def _tie_inputs(seed, b=2, s=24, d=16, e=8):
    """Small integers: every logit is an exact float32 integer whatever
    the summation order, so many experts tie."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, (b, s, d)).astype(np.float32)
    w = rng.integers(-1, 2, (d, e)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("case", ("random", "ties"))
@pytest.mark.parametrize("top_k", (1, 2, 3))
def test_route_matches_jax(case, top_k):
    if case == "ties":
        x, w = _tie_inputs(3)
    else:
        rng = np.random.default_rng(4)
        x = rng.standard_normal((2, 24, 16)).astype(np.float32)
        w = (rng.standard_normal((16, 8)) * 0.1).astype(np.float32)
    jw, je, jaux = jmoe.route(jnp.asarray(w), jnp.asarray(x), top_k)
    tw, te, taux = tmoe.route(_t(w), _t(x), top_k)
    assert te.dtype == torch.int32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    if case == "ties":    # the inputs do tie across the selection boundary
        logits = x @ w
        srt = -np.sort(-logits, -1)
        assert (srt[..., top_k - 1] == srt[..., top_k]).any()


def _jax_slot_map(experts, e, cap):
    """The JAX package's per-sequence slot->token map (moe.py one_seq)."""
    s, k = experts.shape
    slot, keep = jmoe._dispatch_indices(experts, e, cap)
    flat_e = experts.reshape(s * k)
    sentinel = s * k
    assign = jnp.where(keep, jnp.arange(s * k, dtype=jnp.int32), sentinel)
    tok = jnp.full((e, cap), sentinel, jnp.int32)
    return tok.at[flat_e, slot].min(assign), slot, keep


@pytest.mark.parametrize("cf", (1.25, 0.1, 8.0), ids=("cf1.25", "drops",
                                                      "no_drops"))
def test_dispatch_and_slot_map_bit_equal(cf):
    rng = np.random.default_rng(5)
    b, s, k, e = 3, 32, 2, 4
    experts = np.stack([[rng.choice(e, k, replace=False) for _ in range(s)]
                        for _ in range(b)]).astype(np.int32)
    cap = jmoe.moe_capacity(s, e, k, cf)
    assert tmoe.moe_capacity(s, e, k, cf) == cap
    tok, slot, keep = tmoe.slot_token_map(_t(experts), e, cap)
    assert tok.dtype == slot.dtype == torch.int32 and keep.dtype == torch.bool
    dropped = 0
    for i in range(b):
        jtok, jslot, jkeep = _jax_slot_map(jnp.asarray(experts[i]), e, cap)
        np.testing.assert_array_equal(tok[i].numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(slot[i].numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jkeep))
        ps, pk = tmoe._dispatch_indices(_t(experts[i]), e, cap)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jkeep))
        dropped += int((~np.asarray(jkeep)).sum())
    assert (dropped > 0) == (cf == 0.1), dropped


@pytest.mark.parametrize("s,e,k,cf", [(1, 40, 8, 1.25), (512, 40, 8, 1.25),
                                      (64, 40, 8, 1.25), (7, 16, 2, 1.25),
                                      (100, 4, 2, 0.01)])
def test_moe_capacity_matches_jax(s, e, k, cf):
    assert tmoe.moe_capacity(s, e, k, cf) == jmoe.moe_capacity(s, e, k, cf)


def test_served_capacities():
    """The capacities of the served granite shapes (prefill of 512 tokens,
    one-token decode)."""
    assert tmoe.moe_capacity(512, 40, 8, 1.25) == 129
    assert tmoe.moe_capacity(1, 40, 8, 1.25) == 8


# ---------------------------------------------------------------- moe_ffn

def _moe_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    return {"router": (rng.standard_normal((d, e)) * 0.1).astype(np.float32),
            "w_in": (rng.standard_normal((e, d, 2 * f)) * 0.05).astype(
                np.float32),
            "w_out": (rng.standard_normal((e, f, d)) * 0.05).astype(
                np.float32)}


@pytest.mark.parametrize("kernel", (True, False), ids=("kernel", "einsum"))
@pytest.mark.parametrize("cf", (1.25, 0.3), ids=("cf1.25", "drops"))
@pytest.mark.parametrize("arch", ("granite-moe-3b-a800m",
                                  "phi3.5-moe-42b-a6.6b"))
def test_moe_ffn_matches_jax(arch, cf, kernel):
    cfg = reduced_config(arch).with_(moe_use_kernel=kernel,
                                     capacity_factor=cf)
    tcfg = port_reduced_config(arch).with_(moe_use_kernel=kernel,
                                           capacity_factor=cf)
    assert repr(cfg) == repr(tcfg)
    p = _moe_params(cfg, 6)
    x = np.random.default_rng(7).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg)
    ty, taux = tmoe.moe_ffn({k: _t(v) for k, v in p.items()}, _t(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    assert abs(float(taux) - float(jaux)) <= 1e-6
