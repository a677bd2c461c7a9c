"""The port's encoder-decoder slice (`repro_torch.models.encdec`,
`layers.cross_attention`, the enc-dec branches of `lm`, `init` and
`serve.step`) against the JAX package on the same numpy inputs and params
converted from the JAX tree, at reduced seamless size.

Bounds: 1e-6 in float32 (sums in another order), 2e-2 in bfloat16 (the
parity matrix's bf16 band, `tests/test_parity_matrix.py`); cache `pos`
planes, int8 caches and `cache_pos` bit-equal; the params tree's key
paths, shapes and dtypes equal to the JAX tree's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.distributed.sharding import Runtime
from repro.models import encdec as jenc
from repro.models import layers as jlayers
from repro.models.init import init_params as jax_init_params
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs import reduced_config as port_reduced_config
from repro_torch.models import encdec as tenc
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.init import init_params
from repro_torch.params import (params_from_numpy, params_to_numpy,
                                tree_leaves)
from repro_torch.serve.step import (build_decode_step, build_prefill_step,
                                    greedy_generate)

RT = Runtime(mesh=None)
ARCH = "seamless-m4t-large-v2"
TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
       "bfloat16": dict(rtol=0, atol=2e-2)}
DTYPES = ("float32", "bfloat16")


def _t(x):
    """numpy or JAX array -> CPU tensor (bfloat16 kept, bit for bit)."""
    return params_from_numpy(np.asarray(x))


def _configs(**kw):
    cfg = reduced_config(ARCH).with_(**kw)
    tcfg = port_reduced_config(ARCH).with_(**kw)
    assert repr(cfg) == repr(tcfg)
    return cfg, tcfg


def _params(cfg, seed=0):
    jp = jax_init_params(jax.random.PRNGKey(seed), cfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _inputs(cfg, seed, b=2, s_enc=24, s_dec=10):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab_size, (b, s_dec)).astype(np.int32)
    return frames, tok


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def _dtypes(dtype):
    return dict(dtype=dtype, param_dtype=dtype)


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("masked", (False, True))
def test_cross_attention_matches_jax(masked):
    cfg, tcfg = _configs()
    rng = np.random.default_rng(3)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": rng.standard_normal((d, h * hd)), "wk":
         rng.standard_normal((d, kv * hd)), "wv":
         rng.standard_normal((d, kv * hd)), "wo":
         rng.standard_normal((h * hd, d))}
    p = {k: (0.1 * v).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    enc = rng.standard_normal((2, 9, d)).astype(np.float32)
    mask = (np.arange(9)[None] < np.array([[9], [4]])) if masked else None
    want = jlayers.cross_attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(enc), cfg,
        None if mask is None else jnp.asarray(mask))
    got = tlayers.cross_attention({k: _t(v) for k, v in p.items()}, _t(x),
                                  _t(enc), tcfg,
                                  None if mask is None else _t(mask))
    _close(got, want, "float32")


def test_encoder_attention_is_dense_at_every_length(monkeypatch):
    """The encoder never takes the chunked path or the kernel, even past
    the threshold at which decoder prefill does (as in the JAX package)."""
    cfg, tcfg = _configs()
    jp, tp = _params(cfg)
    frames, _ = _inputs(cfg, 4, s_enc=12)

    def refuse(*args, **kwargs):
        raise AssertionError("the encoder took the long-sequence path")

    monkeypatch.setattr(tlayers, "CHUNK_THRESHOLD", 4)
    monkeypatch.setattr(tlayers, "chunked_attention_core", refuse)
    monkeypatch.setattr(tlayers, "flash_attention", refuse)
    got = tenc.encode(tp, tcfg, _t(frames))
    _close(got, jenc.encode(jp, cfg, RT, jnp.asarray(frames)), "float32")


# ---------------------------------------------------------------- params

def _layout(tree, prefix=""):
    """[(path, shape, dtype name)] in the tree's own key order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _layout(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _layout(v, f"{prefix}/{i}")]
    name = str(tree.dtype).replace("torch.", "")
    return [(prefix, tuple(tree.shape), name)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_encdec_init_matches_jax_tree_layout(dtype):
    cfg, tcfg = _configs(param_dtype=dtype)
    jp = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), cfg))
    tp = init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert _layout(tp) == _layout(jp)
    assert {"enc_groups", "enc_final_norm"} <= set(tp)
    assert {"ln_x", "xattn"} <= set(tp["groups"][0])
    assert "xattn" not in tp["enc_groups"][0]
    assert tp["enc_groups"][0]["attn"]["wq"].shape[0] == cfg.n_enc_layers
    assert all(torch.isfinite(t.float()).all() for t in tree_leaves(tp))


@pytest.mark.parametrize("dtype", DTYPES)
def test_encdec_params_round_trip_bit_for_bit(dtype):
    cfg, _ = _configs(param_dtype=dtype)
    jp = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(1), cfg))
    back = params_to_numpy(params_from_numpy(jp))
    assert jax.tree.structure(jp) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_full_seamless_layout_without_drawing():
    """The served model: 24 encoder and 24 decoder layers, d 1024, vocab
    256206 padded to 256512, every attention block MHA."""
    cfg = port_get_config(ARCH)
    assert (cfg.n_groups, cfg.n_enc_layers, cfg.d_model) == (24, 24, 1024)
    assert cfg.vocab_padded == 256512
    assert cfg.layer_kinds() == ["attn"] and cfg.n_kv_heads == cfg.n_heads


# ------------------------------------------------------- the whole slice

@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_and_forward_encdec_match_jax(dtype):
    cfg, tcfg = _configs(**_dtypes(dtype))
    jp, tp = _params(cfg)
    frames, tok = _inputs(cfg, 5)
    _close(tenc.encode(tp, tcfg, _t(frames)),
           jenc.encode(jp, cfg, RT, jnp.asarray(frames)), dtype)
    jlog, jaux = jenc.forward_encdec(jp, cfg, RT, jnp.asarray(frames),
                                     jnp.asarray(tok))
    tlog, taux = tenc.forward_encdec(tp, tcfg, _t(frames), _t(tok))
    assert tlog.dtype == torch.float32 and tlog.shape == jlog.shape
    _close(tlog, jlog, dtype)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("case", ("float32", "bfloat16", "int8_kv"))
def test_prefill_and_decode_encdec_match_jax(case):
    """Prefill into a 16-slot cache, then 4 greedy decode steps: logits,
    the caches (k, v within the bound; `pos` bit-equal) and `cache_pos`
    after each. The int8 KV config casts the prompt's keys and values
    without scales, as the JAX function does: its caches are bit-equal."""
    dtype = "float32" if case == "int8_kv" else case
    kw = _dtypes(dtype)
    if case == "int8_kv":
        kw["kv_cache_dtype"] = "int8"
    cfg, tcfg = _configs(**kw)
    jp, tp = _params(cfg, seed=2)
    frames, tok = _inputs(cfg, 6)
    jl, jeo, jc, jpos = jenc.prefill_encdec(jp, cfg, RT, jnp.asarray(frames),
                                            jnp.asarray(tok), cache_len=16)
    tl, teo, tc, tpos = tenc.prefill_encdec(tp, tcfg, _t(frames), _t(tok),
                                            cache_len=16)
    _close(teo, jeo, dtype)
    for step in range(5):
        _close(tl, jl, dtype)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        assert len(tc) == len(jc)
        for tcj, jcj in zip(tc, jc):
            assert sorted(tcj["attn"]) == sorted(jcj["attn"])
            for key, val in tcj["attn"].items():
                if val.dtype in (torch.int32, torch.int8):
                    np.testing.assert_array_equal(
                        val.numpy(), np.asarray(jcj["attn"][key]))
                else:
                    _close(val, jcj["attn"][key], dtype)
        if step == 4:
            break
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        assert np.array_equal(torch.argmax(tl, -1).numpy(), nxt[:, 0])
        jl, jc, jpos = jenc.decode_step_encdec(jp, cfg, RT, jnp.asarray(nxt),
                                               jeo, jc, jpos)
        tl, tc, tpos = tenc.decode_step_encdec(tp, tcfg, _t(nxt), teo, tc,
                                               tpos)


def test_decode_matches_the_full_forward():
    """prefill(S-1) + decode(1) is the full forward's last two positions."""
    cfg, tcfg = _configs()
    _, tp = _params(cfg, seed=3)
    frames, tok = _inputs(cfg, 7, s_dec=16)
    full, _ = tenc.forward_encdec(tp, tcfg, _t(frames), _t(tok))
    last, enc_out, caches, pos = tenc.prefill_encdec(
        tp, tcfg, _t(frames), _t(tok[:, :-1]), cache_len=16)
    dec, _, pos2 = tenc.decode_step_encdec(tp, tcfg, _t(tok[:, -1:]),
                                           enc_out, caches, pos)
    np.testing.assert_allclose(last.numpy(), full[:, -2].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert pos2.tolist() == [16, 16]


def test_serve_steps_drive_the_encdec_model():
    """`build_prefill_step(cfg)(params, frames, tokens)` and
    `build_decode_step(cfg)(params, token, enc_out, caches, cache_pos)`
    are the enc-dec functions; `greedy_generate` raises as the JAX one."""
    cfg, tcfg = _configs()
    _, tp = _params(cfg, seed=4)
    frames, tok = _inputs(cfg, 8)
    want = tenc.prefill_encdec(tp, tcfg, _t(frames), _t(tok), cache_len=12)
    got = build_prefill_step(tcfg)(tp, _t(frames), _t(tok), cache_len=12)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    nxt = torch.argmax(got[0], -1)[:, None]
    logits, caches, pos = build_decode_step(tcfg)(tp, nxt, got[1], got[2],
                                                  got[3])
    ref = tenc.decode_step_encdec(tp, tcfg, nxt, want[1], want[2], want[3])
    assert torch.equal(logits, ref[0]) and pos.tolist() == [11, 11]
    with pytest.raises(NotImplementedError, match="encdec steps directly"):
        greedy_generate(tp, tcfg, tok, max_new=2, device="cpu")
    with pytest.raises(ValueError, match="forward_encdec"):
        tlm.forward(tp, tcfg, _t(tok))
