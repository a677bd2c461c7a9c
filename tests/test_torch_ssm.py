"""The port's recurrent slice — the wkv6 and mamba_scan kernels' plain
versions, `models.rwkv6`, `models.mamba`, and rwkv6 / Jamba hybrid serving
— against the JAX package on the same numpy inputs and converted params,
on the CPU (the JAX kernels in interpret mode, as tests/test_kernels.py
runs them).

Bounds:
  * the scans against the JAX kernels and the model's scan: rtol 1e-4 /
    atol 1e-5, the JAX kernel sweeps' bound (tests/test_kernels.py);
  * the blocks (time_mix, channel_mix, mamba_block, prefill and decode):
    rtol 1e-5 / atol 1e-5, float32 sums in another order;
  * the slice as a whole (prefill + 4 decode steps, `forward`,
    `greedy_generate`) at reduced size in float32: last logits rtol 1e-5 /
    atol 1e-5, caches within 1e-5 (attention `pos` planes bit-equal),
    generated tokens equal;
  * params: the port's `init_params` builds the JAX tree's keys, order,
    shapes and dtypes for rwkv and mamba blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.distributed.sharding import Runtime
from repro.kernels.mamba_scan import mamba_selective_scan as jax_mamba_scan
from repro.kernels.wkv6 import wkv6 as jax_wkv6
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro.models import rwkv6 as jrwkv6
from repro.models.init import init_cmix, init_mamba
from repro.models.init import init_params as jax_init_params
from repro.models.init import init_rwkv
from repro.serve.step import greedy_generate as jax_greedy_generate
from repro_torch.configs import reduced_config as port_reduced_config
from repro_torch.kernels.mamba_scan import (
    mamba_selective_scan, mamba_selective_scan_plain,
    mamba_selective_scan_state_plain)
from repro_torch.kernels.wkv6 import wkv6, wkv6_plain, wkv6_state_plain
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmamba
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models.init import init_params
from repro_torch.params import params_from_numpy, tree_leaves
from repro_torch.serve.step import greedy_generate

RT = Runtime(mesh=None)
SCAN_TOL = dict(rtol=1e-4, atol=1e-5)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
SLICE_CASES = [("rwkv6-7b", False), ("jamba-1.5-large-398b", False),
               ("jamba-1.5-large-398b", True)]
SLICE_IDS = ["rwkv6-7b", "jamba-1.5-large-398b",
             "jamba-1.5-large-398b-kernel"]


def _t(x):
    """numpy or JAX array -> CPU tensor (bfloat16 kept, bit for bit)."""
    return params_from_numpy(np.asarray(x))


def _tree(jtree):
    return params_from_numpy(jax.tree.map(np.asarray, jtree))


def _configs(arch, **kw):
    cfg = reduced_config(arch).with_(**kw)
    tcfg = port_reduced_config(arch).with_(**kw)
    assert repr(cfg) == repr(tcfg)
    return cfg, tcfg


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ------------------------------------------------------------------ wkv6

def _wkv_inputs(seed, b, t, h, kd, vd):
    rng = np.random.default_rng(seed)
    r, k = _normal(rng, (b, t, h, kd), 0.5), _normal(rng, (b, t, h, kd), 0.5)
    v = _normal(rng, (b, t, h, vd), 0.5)
    w = (1 / (1 + np.exp(-_normal(rng, (b, t, h, kd))))).astype(np.float32)
    u = _normal(rng, (h, kd), 0.1)
    return r, k, v, w, u


@pytest.mark.parametrize("t,h,kd,vd,bt", [(64, 2, 16, 16, 32),
                                          (128, 4, 64, 64, 64),
                                          (32, 1, 8, 8, 32)])
def test_wkv6_plain_matches_jax_kernel(t, h, kd, vd, bt):
    arrays = _wkv_inputs(0, 2, t, h, kd, vd)
    want = jax_wkv6(*map(jnp.asarray, arrays), block_t=bt, interpret=True)
    got = wkv6_plain(*map(_t, arrays))
    _close(got, want, SCAN_TOL)
    assert torch.equal(wkv6(*map(_t, arrays)), got)   # CPU: the plain version


def test_wkv6_state_plain_matches_model_scan():
    """o and s_final of the JAX model's `wkv_scan` (bf16 r/k/v as the model
    feeds them, float32 w and u), then a carried state: two calls equal
    one over the whole sequence."""
    r, k, v, w, u = _wkv_inputs(1, 2, 40, 3, 16, 16)
    r, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in (r, k, v))
    want_o, want_s = jrwkv6.wkv_scan(r, k, v, jnp.asarray(w), jnp.asarray(u))
    tr, tk, tv, tw, tu = map(_t, (r, k, v, w, u))
    got_o, got_s = wkv6_state_plain(tr, tk, tv, tw, tu)
    assert got_o.dtype == torch.float32 and got_s.dtype == torch.float32
    _close(got_o, want_o, SCAN_TOL)
    _close(got_s, want_s, SCAN_TOL)
    o1, s1 = wkv6_state_plain(tr[:, :25], tk[:, :25], tv[:, :25], tw[:, :25],
                              tu)
    o2, s2 = wkv6_state_plain(tr[:, 25:], tk[:, 25:], tv[:, 25:], tw[:, 25:],
                              tu, s1)
    _close(torch.cat([o1, o2], 1), want_o, SCAN_TOL)
    _close(s2, want_s, SCAN_TOL)


# ------------------------------------------------------------ mamba_scan

def _mamba_inputs(seed, bsz, t, din, n):
    rng = np.random.default_rng(seed)
    dt = (np.log1p(np.exp(_normal(rng, (bsz, t, din)))) * 0.1).astype(
        np.float32)
    x = _normal(rng, (bsz, t, din))
    b, c = _normal(rng, (bsz, t, n), 0.5), _normal(rng, (bsz, t, n), 0.5)
    a = (-np.exp(_normal(rng, (din, n), 0.3))).astype(np.float32)
    d = _normal(rng, (din,))
    return dt, x, b, c, a, d


@pytest.mark.parametrize("bsz,t,din,n,bt,bd", [(2, 64, 32, 4, 32, 16),
                                               (1, 128, 64, 16, 64, 64),
                                               (2, 32, 16, 8, 32, 16)])
def test_mamba_scan_plain_matches_jax_kernel(bsz, t, din, n, bt, bd):
    arrays = _mamba_inputs(2, bsz, t, din, n)
    want = jax_mamba_scan(*map(jnp.asarray, arrays), block_t=bt, block_d=bd,
                          interpret=True)
    got = mamba_selective_scan_plain(*map(_t, arrays))
    _close(got, want, SCAN_TOL)
    assert torch.equal(mamba_selective_scan(*map(_t, arrays)), got)
    # the state variant carries: two calls equal one
    ta = list(map(_t, arrays))
    y1, h1 = mamba_selective_scan_state_plain(*(z[:, :t // 2] for z in ta[:4]),
                                              *ta[4:])
    y2, _ = mamba_selective_scan_state_plain(*(z[:, t // 2:] for z in ta[:4]),
                                             *ta[4:], h1)
    _close(torch.cat([y1, y2], 1), want, SCAN_TOL)


# ---------------------------------------------------------------- blocks

def test_time_mix_and_channel_mix_match_jax():
    """Prefill from no state, then one decode step carrying the shift and
    wkv states (the JAX block's einsum fast path; the port's T = 1 scan)."""
    cfg, tcfg = _configs("rwkv6-7b")
    jt = init_rwkv(jax.random.PRNGKey(0), cfg, jnp.float32)
    jc = init_cmix(jax.random.PRNGKey(1), cfg, jnp.float32)
    tt, tc = _tree(jt), _tree(jc)
    rng = np.random.default_rng(3)
    x, x1 = _normal(rng, (2, 9, cfg.d_model)), _normal(rng, (2, 1, cfg.d_model))
    jy, jshift, jwkv = jrwkv6.time_mix(jt, jnp.asarray(x), cfg)
    ty, tshift, twkv = trwkv6.time_mix(tt, _t(x), tcfg)
    _close(ty, jy, BLOCK_TOL)
    _close(tshift, jshift, dict(rtol=0, atol=0))
    _close(twkv, jwkv, BLOCK_TOL)
    jy, jshift2, jwkv = jrwkv6.time_mix(jt, jnp.asarray(x1), cfg,
                                        shift_state=jshift, wkv_state=jwkv)
    ty, _, twkv = trwkv6.time_mix(tt, _t(x1), tcfg, shift_state=tshift,
                                  wkv_state=twkv)
    _close(ty, jy, BLOCK_TOL)
    _close(twkv, jwkv, BLOCK_TOL)
    jy, jlast = jrwkv6.channel_mix(jc, jnp.asarray(x))
    ty, tlast = trwkv6.channel_mix(tc, _t(x))
    _close(ty, jy, BLOCK_TOL)
    jy, _ = jrwkv6.channel_mix(jc, jnp.asarray(x1), shift_state=jlast)
    ty, _ = trwkv6.channel_mix(tc, _t(x1), shift_state=tlast)
    _close(ty, jy, BLOCK_TOL)


def test_mamba_block_matches_jax():
    """Prefill, then three decode steps against the carried conv / ssm
    state: y and both states. D * x is added once (inside the port's
    scan, after the JAX block's)."""
    cfg, tcfg = _configs("jamba-1.5-large-398b")
    jp = init_mamba(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = _tree(jp)
    rng = np.random.default_rng(5)
    x = _normal(rng, (2, 11, cfg.d_model))
    jy, jst = jmamba.mamba_block(jp, jnp.asarray(x), cfg)
    ty, tst = tmamba.mamba_block(tp, _t(x), tcfg)
    for step in range(4):
        _close(ty, jy, BLOCK_TOL)
        assert sorted(tst) == sorted(jst) == ["conv", "ssm"]
        _close(tst["conv"], jst["conv"], BLOCK_TOL)
        _close(tst["ssm"], jst["ssm"], BLOCK_TOL)
        assert tst["ssm"].dtype == torch.float32
        if step == 3:
            break
        x1 = _normal(rng, (2, 1, cfg.d_model))
        jy, jst = jmamba.mamba_block(jp, jnp.asarray(x1), cfg, state=jst)
        ty, tst = tmamba.mamba_block(tp, _t(x1), tcfg, state=tst)


def test_causal_conv_and_softplus_match_jax():
    rng = np.random.default_rng(6)
    x, w, b = (_normal(rng, (2, 7, 12)), _normal(rng, (12, 4)),
               _normal(rng, (12,)))
    state = _normal(rng, (2, 3, 12))
    for st in (None, state):
        jy, jn = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b),
                                     None if st is None else jnp.asarray(st))
        ty, tn = tmamba._causal_conv(_t(x), _t(w), _t(b),
                                     None if st is None else _t(st))
        _close(ty, jy, dict(rtol=1e-6, atol=1e-6))
        _close(tn, jn, dict(rtol=0, atol=0))
    # `jax.nn.softplus` is logaddexp(x, 0); torch's softplus turns into the
    # identity above 20, logaddexp does not
    z = np.linspace(-40, 40, 4001).astype(np.float32)
    want = jax.nn.softplus(jnp.asarray(z))
    got = torch.logaddexp(_t(z), torch.zeros(z.shape))
    _close(got, want, dict(rtol=1e-6, atol=0))


# ------------------------------------------------------- the whole slice

def _caches_close(tc, jc):
    assert len(tc) == len(jc)
    for tcj, jcj in zip(tc, jc):
        assert sorted(tcj) == sorted(jcj)
        for kind in tcj:
            assert sorted(tcj[kind]) == sorted(jcj[kind])
            for key, leaf in tcj[kind].items():
                want = np.asarray(jcj[kind][key])
                assert tuple(leaf.shape) == want.shape, (kind, key)
                if key == "pos":
                    np.testing.assert_array_equal(leaf.numpy(), want)
                else:
                    _close(leaf, want, BLOCK_TOL if kind != "attn"
                           else ATTN_TOL)


@pytest.mark.parametrize("arch,kernel", SLICE_CASES, ids=SLICE_IDS)
def test_prefill_and_decode_match_jax(arch, kernel):
    cfg, tcfg = _configs(arch, moe_use_kernel=kernel)
    jp = jax_init_params(jax.random.PRNGKey(0), cfg)
    tp = _tree(jp)
    tok = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jc, jpos = jlm.prefill(jp, cfg, RT, jnp.asarray(tok), cache_len=16)
    tl, tc, tpos = tlm.prefill(tp, tcfg, _t(tok), cache_len=16)
    for step in range(5):
        _close(tl, jl, LOGIT_TOL)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        _caches_close(tc, jc)
        if step == 4:
            break
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        assert np.array_equal(torch.argmax(tl, -1).numpy(), nxt[:, 0])
        jl, jc, jpos = jlm.decode_step(jp, cfg, RT, jnp.asarray(nxt), jc,
                                       jpos)
        tl, tc, tpos = tlm.decode_step(tp, tcfg, _t(nxt), tc, tpos)


@pytest.mark.parametrize("arch,kernel", SLICE_CASES, ids=SLICE_IDS)
def test_greedy_generate_and_forward_match_jax(arch, kernel):
    cfg, tcfg = _configs(arch, moe_use_kernel=kernel)
    jp = jax_init_params(jax.random.PRNGKey(3), cfg)
    tp = _tree(jp)
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    want = np.asarray(jax_greedy_generate(jp, cfg, RT, jnp.asarray(prompt),
                                          max_new=6))
    got = greedy_generate(tp, tcfg, prompt, max_new=6, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    jlog, jaux = jlm.forward(jp, cfg, RT, jnp.asarray(prompt))
    tlog, taux = tlm.forward(tp, tcfg, _t(prompt))
    _close(tlog, jlog, LOGIT_TOL)
    assert abs(float(taux) - float(jaux)) <= 1e-6


# ---------------------------------------------------------------- params

def _layout(tree, prefix=""):
    """[(path, shape, dtype name)] in the tree's own key order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _layout(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _layout(v, f"{prefix}/{i}")]
    return [(prefix, tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]


@pytest.mark.parametrize("arch", ("rwkv6-7b", "jamba-1.5-large-398b"))
def test_port_init_matches_jax_tree_layout(arch):
    cfg, tcfg = _configs(arch, param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), cfg))
    tp = init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert _layout(tp) == _layout(jp)
    assert all(torch.isfinite(t.float()).all() for t in tree_leaves(tp))
    for grp, jgrp in zip(tp["groups"], jp["groups"]):
        for name in ("rwkv", "mamba"):
            if name not in grp:
                continue
            for key, leaf in grp[name].items():     # the constant leaves
                if key in ("w0", "a_log", "d", "conv_b") \
                        or key.startswith("mix_"):
                    np.testing.assert_array_equal(
                        leaf.float().numpy(),
                        np.asarray(jgrp[name][key], np.float32))
            if name == "mamba":                     # softplus^-1 of U[1e-3, 0.1]
                dt = torch.nn.functional.softplus(grp[name]["dt_bias"])
                assert 1e-3 <= float(dt.min()) and float(dt.max()) <= 0.1
