"""Parameter initialization for every block kind, enc-dec included — port
of `repro.models.init`.

Init is truncated-normal(±2σ) × 0.02 with depth-scaled output projections,
drawn in float32 and cast to `param_dtype`; the router stays float32. Leaves
are stacked over layer groups on axis 0 ([G, ...]) with the JAX tree's
keys, key order (sorted, as JAX returns a vmapped dict), shapes and dtypes.

`torch.Generator` and `jax.random` draw different numbers from one seed, so
the parity tests convert the JAX package's params (`params.
params_from_numpy`) instead of re-initializing. Every leaf is drawn on the
target device from a device generator seeded by the caller's generator, so
a 3B-parameter tree is never copied from the host. An enc-dec config
(seamless) adds `ln_x` and `xattn` to every decoder block, and
`enc_groups` (one stack of `n_enc_layers` attention blocks) and
`enc_final_norm` to the tree, as the JAX package does.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_LO, _HI = (0.5 * (1 + math.erf(v / math.sqrt(2))) for v in (-2.0, 2.0))


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


class _Draw:
    """Leaf drawer: float32 truncated normals on one device, one leaf after
    another from a single device generator; a stacked leaf is drawn one
    group slice at a time so the float32 temporary stays one slice."""

    def __init__(self, gen: torch.Generator, device: torch.device):
        seed = int(torch.randint(2**62, (1,), generator=gen,
                                 device=gen.device))
        self.gen = (None if device.type == "meta" else
                    torch.Generator(device=device).manual_seed(seed))
        self.device = device

    def dense(self, shape, dtype, scale=0.02, stack: int | None = None):
        full = (stack,) + tuple(shape) if stack is not None else tuple(shape)
        out = torch.empty(full, dtype=dtype, device=self.device)
        if self.gen is None:                    # "meta": shapes only
            return out
        for sl in (range(stack) if stack is not None else (None,)):
            u = torch.empty(shape, dtype=torch.float32, device=self.device)
            u.uniform_(_LO, _HI, generator=self.gen)
            z = torch.erfinv(u * 2 - 1) * math.sqrt(2.0)
            z = torch.clamp(z, -2.0, 2.0) * scale
            if sl is None:
                out.copy_(z)
            else:
                out[sl].copy_(z)
        return out


def _norm(d, dtype, device, stack=None):
    shape = (d,) if stack is None else (stack, d)
    return {"scale": torch.zeros(shape, dtype=dtype, device=device)}


def _out_scale(cfg: ModelConfig) -> float:
    return 0.02 / max(1, cfg.n_layers) ** 0.5


def init_attn(draw: _Draw, cfg: ModelConfig, dtype, stack=None):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": draw.dense((d, h * hd), dtype, stack=stack),
         "wk": draw.dense((d, kv * hd), dtype, stack=stack),
         "wv": draw.dense((d, kv * hd), dtype, stack=stack),
         "wo": draw.dense((h * hd, d), dtype, _out_scale(cfg), stack=stack)}
    if cfg.qkv_bias:
        lead = () if stack is None else (stack,)
        for name, width in (("wq_b", h * hd), ("wk_b", kv * hd),
                            ("wv_b", kv * hd)):
            p[name] = torch.zeros(lead + (width,), dtype=dtype,
                                  device=draw.device)
    return p


def init_mlp(draw: _Draw, cfg: ModelConfig, dtype, stack=None):
    return {"w_in": draw.dense((cfg.d_model, 2 * cfg.d_ff), dtype,
                               stack=stack),
            "w_out": draw.dense((cfg.d_ff, cfg.d_model), dtype,
                                _out_scale(cfg), stack=stack)}


def init_moe(draw: _Draw, cfg: ModelConfig, dtype, stack=None):
    e, f = cfg.n_experts, cfg.d_ff_expert
    return {"router": draw.dense((cfg.d_model, e), torch.float32,
                                 stack=stack),
            "w_in": draw.dense((e, cfg.d_model, 2 * f), dtype, stack=stack),
            "w_out": draw.dense((e, f, cfg.d_model), dtype, _out_scale(cfg),
                                stack=stack)}


def _full(draw: _Draw, shape, value, dtype, stack=None):
    lead = () if stack is None else (stack,)
    return torch.full(lead + tuple(shape), value, dtype=dtype,
                      device=draw.device)


def init_mamba(draw: _Draw, cfg: ModelConfig, dtype, stack=None):
    d, din, n, r = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state, \
        cfg.dt_rank
    lead = () if stack is None else (stack,)
    # softplus^-1 of uniform [1e-3, 1e-1]
    dt = torch.empty(lead + (din,), dtype=torch.float32, device=draw.device)
    dt.uniform_(1e-3, 1e-1, generator=draw.gen)
    # S4D-real A init: A[:, j] = -(j+1) -> a_log = log(j+1)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=draw.device)
    return {
        "in_proj": draw.dense((d, 2 * din), dtype, stack=stack),
        "conv_w": draw.dense((din, cfg.mamba_d_conv), dtype, 0.3,
                             stack=stack),
        "conv_b": _full(draw, (din,), 0.0, dtype, stack),
        "x_proj": draw.dense((din, r + 2 * n), dtype, stack=stack),
        "dt_proj": draw.dense((r, din), dtype, r ** -0.5, stack=stack),
        "dt_bias": torch.log(torch.expm1(dt)),
        "a_log": torch.log(a).expand(lead + (din, n)).contiguous(),
        "d": _full(draw, (din,), 1.0, torch.float32, stack),
        "out_proj": draw.dense((din, d), dtype, _out_scale(cfg),
                               stack=stack),
    }


def init_rwkv(draw: _Draw, cfg: ModelConfig, dtype, stack=None):
    d, lora_rank = cfg.d_model, 32
    h, hk = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    p = {name: draw.dense((d, d), dtype, stack=stack)
         for name in ("wr", "wk", "wv", "wg")}
    p.update({
        "wo": draw.dense((d, d), dtype, _out_scale(cfg), stack=stack),
        "lora_a_w": draw.dense((d, lora_rank), dtype, stack=stack),
        "lora_b_w": draw.dense((lora_rank, d), dtype, 0.01, stack=stack),
        "w0": _full(draw, (h, hk), -6.0, torch.float32, stack),
        "u": draw.dense((h, hk), torch.float32, 0.5, stack=stack),
    })
    for name in ("r", "k", "v", "g", "w"):
        p[f"mix_{name}"] = _full(draw, (d,), 0.5, dtype, stack)
    return p


def init_cmix(draw: _Draw, cfg: ModelConfig, dtype, stack=None):
    d = cfg.d_model
    return {"w_in": draw.dense((d, cfg.d_ff), dtype, stack=stack),
            "w_out": draw.dense((cfg.d_ff, d), dtype, _out_scale(cfg),
                                stack=stack),
            "wr": draw.dense((d, d), dtype, stack=stack),
            "mix_ck": _full(draw, (d,), 0.5, dtype, stack),
            "mix_cr": _full(draw, (d,), 0.5, dtype, stack)}


_MIXERS = {"attn": ("attn", init_attn), "attn_local": ("attn", init_attn),
           "mamba": ("mamba", init_mamba), "rwkv": ("rwkv", init_rwkv)}


def init_block(draw: _Draw, cfg: ModelConfig, kind: str, is_moe: bool,
               dtype, stack=None, cross_attn: bool = False):
    """One layer's params for a block kind (leaves [stack, ...] when
    `stack` is given); `cross_attn` adds the decoder's `ln_x` and
    `xattn`."""
    if kind not in _MIXERS:
        raise ValueError(kind)
    d, dev = cfg.d_model, draw.device
    name, init_mixer = _MIXERS[kind]
    p = {"ln1": _norm(d, dtype, dev, stack),
         name: init_mixer(draw, cfg, dtype, stack)}
    if cfg.post_block_norm:
        p["post_ln1"] = _norm(d, dtype, dev, stack)
    if cross_attn:
        p["ln_x"] = _norm(d, dtype, dev, stack)
        p["xattn"] = init_attn(draw, cfg, dtype, stack)
    p["ln2"] = _norm(d, dtype, dev, stack)
    if kind == "rwkv":
        p["cmix"] = init_cmix(draw, cfg, dtype, stack)
    elif is_moe:
        p["moe"] = init_moe(draw, cfg, dtype, stack)
    else:
        p["mlp"] = init_mlp(draw, cfg, dtype, stack)
    if cfg.post_block_norm:
        p["post_ln2"] = _norm(d, dtype, dev, stack)
    return _sorted(p)


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device=None):
    """Full parameter tree, group-stacked leaves on axis 0, drawn on
    `device` (None = the card; raises without CUDA unless "cpu").
    `device="meta"` gives the tree's shapes and dtypes without data (the
    counterpart of `jax.eval_shape`), for any config's full size."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    draw = _Draw(gen, dev)
    params = {
        "embed": {"table": draw.dense((cfg.vocab_padded, cfg.d_model),
                                      dtype)},
        "final_norm": _norm(cfg.d_model, dtype, dev),
        "groups": [init_block(draw, cfg, kind, moe, dtype, stack=cfg.n_groups,
                              cross_attn=cfg.is_enc_dec)
                   for kind, moe in zip(cfg.layer_kinds(),
                                        cfg.layer_is_moe())],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": draw.dense((cfg.d_model, cfg.vocab_padded),
                                             dtype)}
    if cfg.is_enc_dec:
        params["enc_groups"] = [init_block(draw, cfg, "attn", False, dtype,
                                           stack=cfg.n_enc_layers)]
        params["enc_final_norm"] = _norm(cfg.d_model, dtype, dev)
    return _sorted(params)
