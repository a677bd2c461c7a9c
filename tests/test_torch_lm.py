"""The port's LM serving slice (`repro_torch.models`, `repro_torch.serve.
step`) against the JAX package on the same numpy inputs and converted
params, at reduced size in float32.

Bounds:
  * `rmsnorm` within 4 ulp (rtol 5e-7): XLA's CPU `lax.rsqrt` is not
    correctly rounded (the A' weights' 2-ulp gap, ROADMAP Queue 3), and the
    mean is summed in another order;
  * `rope` within atol 1e-6: cos/sin of angles up to ~1e3 rad from two
    libraries' float32 kernels;
  * attention (dense, chunked, decode against a ring buffer) rtol 1e-5 /
    atol 1e-6: float32 sums in another order;
  * the slice as a whole (prefill + 4 decode steps, `forward`,
    `greedy_generate`): last logits rtol 1e-5 / atol 1e-5, the caches'
    `pos` planes bit-equal, generated tokens equal;
  * params: converted trees round-trip bit for bit (bf16 too), and the
    port's `init_params` builds the JAX tree's keys, order, shapes and
    dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.distributed.sharding import Runtime
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models.init import init_params as jax_init_params
from repro.serve.step import greedy_generate as jax_greedy_generate
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs import reduced_config as port_reduced_config
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.init import init_params
from repro_torch.params import params_from_numpy, params_to_numpy, tree_leaves
from repro_torch.serve.step import greedy_generate

RT = Runtime(mesh=None)
ATTN_ARCHS = ("granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b", "gemma2-9b",
              "phi3-mini-3.8b", "h2o-danube-3-4b", "qwen1.5-4b")
SLICE_CASES = [(a, False) for a in ATTN_ARCHS] + [
    ("granite-moe-3b-a800m", True), ("phi3.5-moe-42b-a6.6b", True)]
ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    """numpy or JAX array -> CPU tensor (bfloat16 kept, bit for bit)."""
    return params_from_numpy(np.asarray(x))


def _configs(arch, **kw):
    cfg = reduced_config(arch).with_(**kw)
    tcfg = port_reduced_config(arch).with_(**kw)
    assert repr(cfg) == repr(tcfg)
    return cfg, tcfg


def _params(cfg, seed=0):
    jp = jax_init_params(jax.random.PRNGKey(seed), cfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _rng_array(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------- layers

def test_rmsnorm_within_a_few_ulp():
    x = _rng_array(0, (3, 7, 64), 3.0)
    w = _rng_array(1, (64,), 0.1)
    want = jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = tlayers.rmsnorm(_t(x), _t(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-7,
                               atol=0)


def test_rope_matches_jax():
    x = _rng_array(2, (2, 9, 4, 16))
    pos = np.stack([np.arange(9), np.arange(1000, 1009)]).astype(np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = tlayers.rope(_t(x), _t(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ("granite-moe-3b-a800m", "gemma2-9b"))
@pytest.mark.parametrize("window", (None, 5))
def test_attention_core_matches_jax(arch, window):
    """GQA (4 query heads on 2 KV heads), causal, sliding window, and the
    attention softcap (gemma2)."""
    cfg, tcfg = _configs(arch)
    b, t, hd = 2, 11, cfg.head_dim
    q = _rng_array(3, (b, t, cfg.n_heads, hd))
    k = _rng_array(4, (b, t, cfg.n_kv_heads, hd))
    v = _rng_array(5, (b, t, cfg.n_kv_heads, hd))
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    jmask = jlayers._mask(jnp.asarray(pos), jnp.asarray(pos), causal=True,
                          window=window)
    tmask = tlayers._mask(_t(pos), _t(pos), causal=True, window=window)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    want = jlayers.attention_core(*map(jnp.asarray, (q, k, v)), cfg, jmask)
    got = tlayers.attention_core(_t(q), _t(k), _t(v), tcfg, tmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("window", (None, 300))
def test_chunked_attention_core_matches_jax(window):
    """S = 1100: two KV chunks of 1024, the last one padded."""
    cfg, tcfg = _configs("gemma2-9b")
    b, s = 1, 1100
    q = _rng_array(6, (b, s, cfg.n_heads, cfg.head_dim))
    k = _rng_array(7, (b, s, cfg.n_kv_heads, cfg.head_dim))
    v = _rng_array(8, (b, s, cfg.n_kv_heads, cfg.head_dim))
    pos = np.arange(s, dtype=np.int32)[None]
    want = jlayers.chunked_attention_core(
        *map(jnp.asarray, (q, k, v)), cfg, q_pos=jnp.asarray(pos),
        kv_pos=jnp.asarray(pos), causal=True, window=window)
    got = tlayers.chunked_attention_core(
        _t(q), _t(k), _t(v), tcfg, q_pos=_t(pos), kv_pos=_t(pos),
        causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    # and it is the dense path's attention
    mask = tlayers._mask(_t(pos), _t(pos), causal=True, window=window)
    dense = tlayers.attention_core(_t(q), _t(k), _t(v), tcfg, mask)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **ATTN_TOL)


def _attn_params(cfg, seed):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": _rng_array(seed, (d, h * hd), 0.1),
         "wk": _rng_array(seed + 1, (d, kv * hd), 0.1),
         "wv": _rng_array(seed + 2, (d, kv * hd), 0.1),
         "wo": _rng_array(seed + 3, (h * hd, d), 0.1)}
    if cfg.qkv_bias:
        p.update(wq_b=_rng_array(seed + 4, (h * hd,), 0.1),
                 wk_b=_rng_array(seed + 5, (kv * hd,), 0.1),
                 wv_b=_rng_array(seed + 6, (kv * hd,), 0.1))
    return p


@pytest.mark.parametrize("case", ("full_ring", "sliding_window", "int8_kv"))
def test_self_attention_decode_ring_buffer_matches_jax(case):
    """One decode step against a ring buffer whose every slot is taken and
    which has wrapped (cache_pos > W): the write slot, the `pos` plane and
    the masks must be the JAX package's bit for bit."""
    arch = "h2o-danube-3-4b" if case == "sliding_window" else "qwen1.5-4b"
    kw = {"kv_cache_dtype": "int8"} if case == "int8_kv" else {}
    cfg, tcfg = _configs(arch, **kw)
    local = case == "sliding_window"
    b, w = 2, (cfg.sliding_window if local else 12)
    p = _attn_params(cfg, 10)
    x = _rng_array(20, (b, 1, cfg.d_model))
    cache_pos = np.array([w + 3, 2 * w + 5], np.int32)
    # slot i holds the latest position p < cache_pos with p % w == i
    pos_buf = np.stack([[cp - 1 - ((cp - 1 - i) % w) for i in range(w)]
                        for cp in cache_pos]).astype(np.int32)
    shape = (b, w, cfg.n_kv_heads, cfg.head_dim)
    if case == "int8_kv":
        rng = np.random.default_rng(21)
        cache = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                 "v": rng.integers(-127, 128, shape).astype(np.int8),
                 "k_scale": np.abs(_rng_array(22, shape[:-1], 0.01)),
                 "v_scale": np.abs(_rng_array(23, shape[:-1], 0.01))}
    else:
        cache = {"k": _rng_array(21, shape), "v": _rng_array(22, shape)}
    cache["pos"] = pos_buf
    jy, jc = jlayers.self_attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg,
        positions=jnp.asarray(cache_pos[:, None]), local=local,
        cache=jax.tree.map(jnp.asarray, cache),
        cache_pos=jnp.asarray(cache_pos))
    ty, tc = tlayers.self_attention(
        {k: _t(v) for k, v in p.items()}, _t(x), tcfg,
        positions=_t(cache_pos[:, None]), local=local,
        cache={k: _t(v) for k, v in cache.items()}, cache_pos=_t(cache_pos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **ATTN_TOL)
    assert sorted(tc) == sorted(jc)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in tc:
        if tc[key].dtype == torch.int8:
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]))
        else:
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **ATTN_TOL)


# ------------------------------------------------------- the whole slice

@pytest.mark.parametrize("arch,kernel", SLICE_CASES,
                         ids=[f"{a}{'-kernel' if k else ''}"
                              for a, k in SLICE_CASES])
def test_prefill_and_decode_match_jax(arch, kernel):
    cfg, tcfg = _configs(arch, moe_use_kernel=kernel)
    jp, tp = _params(cfg)
    tok = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jc, jpos = jlm.prefill(jp, cfg, RT, jnp.asarray(tok), cache_len=16)
    tl, tc, tpos = tlm.prefill(tp, tcfg, _t(tok), cache_len=16)
    for step in range(5):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        assert len(tc) == len(jc)
        for tcj, jcj in zip(tc, jc):
            np.testing.assert_array_equal(tcj["attn"]["pos"].numpy(),
                                          np.asarray(jcj["attn"]["pos"]))
            for key in ("k", "v"):
                np.testing.assert_allclose(tcj["attn"][key].numpy(),
                                           np.asarray(jcj["attn"][key]),
                                           **ATTN_TOL)
        if step == 4:
            break
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        assert np.array_equal(torch.argmax(tl, -1).numpy(), nxt[:, 0])
        jl, jc, jpos = jlm.decode_step(jp, cfg, RT, jnp.asarray(nxt), jc,
                                       jpos)
        tl, tc, tpos = tlm.decode_step(tp, tcfg, _t(nxt), tc, tpos)


@pytest.mark.parametrize("arch,kernel", SLICE_CASES,
                         ids=[f"{a}{'-kernel' if k else ''}"
                              for a, k in SLICE_CASES])
def test_greedy_generate_and_forward_match_jax(arch, kernel):
    cfg, tcfg = _configs(arch, moe_use_kernel=kernel)
    jp, tp = _params(cfg, seed=3)
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    want = np.asarray(jax_greedy_generate(jp, cfg, RT, jnp.asarray(prompt),
                                          max_new=6))
    got = greedy_generate(tp, tcfg, prompt, max_new=6, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got < cfg.vocab_size).all()
    jlog, jaux = jlm.forward(jp, cfg, RT, jnp.asarray(prompt))
    tlog, taux = tlm.forward(tp, tcfg, _t(prompt))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_decode_matches_the_full_forward():
    """prefill(S-1) + decode(1) is the full forward's last two positions
    (ample capacity: no routing drop can differ)."""
    cfg, tcfg = _configs("granite-moe-3b-a800m", capacity_factor=16.0,
                         moe_use_kernel=True)
    _, tp = _params(cfg)
    tok = _t(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))
             .astype(np.int32))
    full, _ = tlm.forward(tp, tcfg, tok)
    last, caches, pos = tlm.prefill(tp, tcfg, tok[:, :-1], cache_len=16)
    dec, _, pos2 = tlm.decode_step(tp, tcfg, tok[:, -1:], caches, pos)
    np.testing.assert_allclose(last.numpy(), full[:, -2].numpy(), **LOGIT_TOL)
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), **LOGIT_TOL)
    assert pos2.tolist() == [16, 16]


# ---------------------------------------------------------------- params

@pytest.mark.parametrize("dtype", ("bfloat16", "float32"))
def test_lm_params_round_trip_bit_for_bit(dtype):
    cfg = reduced_config("granite-moe-3b-a800m").with_(param_dtype=dtype)
    jp = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), cfg))
    back = params_to_numpy(params_from_numpy(jp))
    jl, bl = jax.tree.leaves(jp), jax.tree.leaves(back)
    assert jax.tree.structure(jp) == jax.tree.structure(back)
    assert len(jl) == len(bl) and len(jl) > 10
    for a, b in zip(jl, bl):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert {a.dtype.name for a in jl} == ({dtype, "float32"})


def _layout(tree, prefix=""):
    """[(path, shape, dtype name)] in the tree's own key order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _layout(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _layout(v, f"{prefix}/{i}")]
    name = str(tree.dtype).replace("torch.", "")
    return [(prefix, tuple(tree.shape), name)]


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_port_init_matches_jax_tree_layout(arch):
    cfg, tcfg = _configs(arch, param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), cfg))
    tp = init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert _layout(tp) == _layout(jp)
    leaves = tree_leaves(tp)
    assert all(torch.isfinite(t.float()).all() for t in leaves)
    # truncated normal x 0.02: |w| <= 0.04 before the bf16 rounding;
    # depth-scaled output projections
    bf16_round = 1 + 2.0 ** -8
    table = tp["embed"]["table"].float()
    assert float(table.abs().max()) <= 0.04 * bf16_round
    assert 0.015 < float(table.std()) < 0.02
    wo = tp["groups"][0]["attn"]["wo"].float()
    assert float(wo.abs().max()) <= 0.04 / cfg.n_layers ** 0.5 * bf16_round
    again = init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves, tree_leaves(again)))


def test_full_granite_layout_without_drawing():
    """The served model's tree: 32 groups of one MoE attention block."""
    cfg = port_get_config("granite-moe-3b-a800m")
    assert (cfg.n_groups, cfg.group_size, cfg.vocab_padded) == (32, 1, 49664)
    assert cfg.layer_kinds() == ["attn"] and cfg.layer_is_moe() == [True]


# ------------------------------------------------------- device policy

def test_no_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    _, tcfg = _configs("qwen1.5-4b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(torch.Generator().manual_seed(0), tcfg)
    tp = init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        greedy_generate(tp, tcfg, prompt, max_new=2)
    assert greedy_generate(tp, tcfg, prompt, max_new=2,
                           device="cpu").shape == (1, 2)


@pytest.mark.parametrize("arch", ("seamless-m4t-large-v2",))
def test_unported_blocks_raise_not_implemented(arch):
    """The blocks that once raised (enc-dec) are ported: seamless now
    initialises and prefills through its enc-dec prefill step
    (`tests/test_torch_encdec.py` holds it against the JAX package)."""
    from repro_torch.serve.step import build_prefill_step

    _, tcfg = _configs(arch)
    tp = init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert {"enc_groups", "enc_final_norm"} <= set(tp)
    frames = torch.zeros((1, 6, tcfg.d_model))
    last, enc_out, caches, pos = build_prefill_step(tcfg)(
        tp, frames, torch.zeros((1, 4), dtype=torch.int32))
    assert last.shape == (1, tcfg.vocab_padded) and torch.isfinite(
        last[:, :tcfg.vocab_size]).all()
    assert enc_out.shape == (1, 6, tcfg.d_model) and pos.tolist() == [4]
    assert caches[0]["attn"]["pos"][:, 0].tolist() == [[0, 1, 2, 3]] * 2
