"""LM assembly for decoder LMs: block dispatch, the group stack, forward /
prefill / decode — port of `repro.models.lm`.

The layer stack is a plain loop over groups (the JAX package runs it under
`lax.scan`; serving needs no remat). Params and caches keep the JAX
layout: a list over group positions whose leaves are stacked [G, ...];
  attn  -> {"k","v" [G,B,W,KV,hd], "pos" [G,B,W]}   (W = window for local)
  mamba -> {"conv" [G,B,K-1,Din], "ssm" [G,B,Din,N] float32}
  rwkv  -> {"shift_t","shift_c" [G,B,1,D], "wkv" [G,B,H,K,V] float32}

Not ported yet, and raising `NotImplementedError`: enc-dec and
cross-attention (ROADMAP Queue 1, enc-dec/VLM) and `lm_loss` (Queue 1,
training).
"""

from __future__ import annotations

import torch

from repro_torch.models import layers, rwkv6
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import torch_dtype
from repro_torch.models.mamba import mamba_block
from repro_torch.models.moe import moe_ffn
from repro_torch.params import tree_map

_ATTN = ("attn", "attn_local")


# ------------------------------------------------------------------ blocks

def _mixer(p, h, cfg, kind: str, positions, cache, cache_pos):
    """The block's sequence mixer: (y, its new cache entry). Prefill
    (cache None) gives {"attn_kv": (k, v)} for attention and the final
    state for mamba / rwkv; decode gives the updated cache entry."""
    if kind in _ATTN:
        y, c = layers.self_attention(
            p["attn"], h, cfg, positions=positions,
            local=(kind == "attn_local"),
            cache=None if cache is None else cache["attn"],
            cache_pos=cache_pos)
        return y, ({"attn_kv": c} if cache is None else {"attn": c})
    if kind == "mamba":
        y, c = mamba_block(p["mamba"], h, cfg,
                           state=None if cache is None else cache["mamba"])
        return y, {"mamba": c}
    if kind == "rwkv":
        st = None if cache is None else cache["rwkv"]
        y, shift_t, wkv = rwkv6.time_mix(
            p["rwkv"], h, cfg,
            shift_state=None if st is None else st["shift_t"],
            wkv_state=None if st is None else st["wkv"])
        return y, {"rwkv": {"shift_t": shift_t, "wkv": wkv}}
    raise ValueError(kind)


def apply_block(p, x: torch.Tensor, cfg, kind: str, is_moe: bool, *,
                positions: torch.Tensor, cache=None, cache_pos=None):
    """One layer: (mixer + residual) then (FFN + residual). Returns
    (x, new_cache, aux_loss)."""
    h = layers.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
    y, new_cache = _mixer(p, h, cfg, kind, positions, cache, cache_pos)
    if cfg.post_block_norm:
        y = layers.rmsnorm(y, p["post_ln1"]["scale"], cfg.norm_eps)
    x = x + y

    h = layers.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps)
    aux = 0.0
    if kind == "rwkv":
        y, new_cache["rwkv"]["shift_c"] = rwkv6.channel_mix(
            p["cmix"], h,
            shift_state=None if cache is None else cache["rwkv"]["shift_c"])
    elif is_moe:
        y, aux = moe_ffn(p["moe"], h, cfg)
    else:
        y = layers.swiglu_mlp(p["mlp"], h)
    if cfg.post_block_norm:
        y = layers.rmsnorm(y, p["post_ln2"]["scale"], cfg.norm_eps)
    return x + y, new_cache, aux


# ------------------------------------------------------------ group stack

def _stack(trees: list):
    """List over groups of same-shaped trees -> one tree of [G, ...]."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def _run_groups(params, cfg, x: torch.Tensor, *, positions, caches=None,
                cache_pos=None):
    """Every layer in order: group g, then position j within the group.
    Returns (x, per-position new caches stacked [G, ...], aux sum)."""
    kinds, moes = cfg.layer_kinds(), cfg.layer_is_moe()
    outs = [[] for _ in kinds]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.n_groups):
        for j, kind in enumerate(kinds):
            grp = tree_map(lambda t: t[g], params["groups"][j])
            cache = (None if caches is None
                     else tree_map(lambda t: t[g], caches[j]))
            x, nc, aux = apply_block(grp, x, cfg, kind, moes[j],
                                     positions=positions, cache=cache,
                                     cache_pos=cache_pos)
            outs[j].append(nc)
            aux_total = aux_total + aux
    return x, [_stack(o) for o in outs], aux_total


# ---------------------------------------------------------------- forward

def embed_tokens(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["table"][tokens.long()]


def logits_from_hidden(params, cfg, x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].T
    else:
        logits = x @ params["lm_head"]["w"]
    logits = logits.float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.vocab_padded != cfg.vocab_size:   # mask Megatron-style pad ids
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab_size
        logits = torch.where(pad, -1e9, logits)
    return logits


def _embed_inputs(params, cfg, tokens, embeds):
    if cfg.is_enc_dec:
        raise NotImplementedError("enc-dec models are not ported yet "
                                  "(ROADMAP Queue 1, enc-dec/VLM)")
    x = embed_tokens(params, cfg, tokens)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    return x, positions


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            embeds: torch.Tensor | None = None):
    """Scoring forward. tokens [B,S_tok]; embeds [B,P,D] prepended (VLM
    patches). Returns (logits [B,S,V] float32, aux_loss)."""
    x, positions = _embed_inputs(params, cfg, tokens, embeds)
    x, _, aux = _run_groups(params, cfg, x, positions=positions)
    return logits_from_hidden(params, cfg, x), aux


# ------------------------------------------------------------------ serve

def _attn_alloc(cfg, kind: str, cache_len: int) -> int:
    if kind == "attn_local" and cfg.sliding_window:
        return min(cache_len, cfg.sliding_window)
    return cache_len


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device="cpu") -> list:
    """Empty decode cache (list over group positions, leaves [G, ...])."""
    dtype = dtype or torch_dtype(cfg.dtype)
    g = cfg.n_groups
    quant = cfg.kv_cache_dtype == "int8"
    kv_dtype = torch.int8 if quant else dtype

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    caches = []
    for kind in cfg.layer_kinds():
        if kind in _ATTN:
            w = _attn_alloc(cfg, kind, cache_len)
            shape = (g, batch, w, cfg.n_kv_heads, cfg.head_dim)
            c = {"k": zeros(shape, kv_dtype), "v": zeros(shape, kv_dtype),
                 "pos": torch.full((g, batch, w), -1, dtype=torch.int32,
                                   device=device)}
            if quant:
                c["k_scale"] = zeros(shape[:-1], torch.float32)
                c["v_scale"] = zeros(shape[:-1], torch.float32)
            caches.append({"attn": c})
        elif kind == "mamba":
            caches.append({"mamba": {
                "conv": zeros((g, batch, cfg.mamba_d_conv - 1,
                               cfg.mamba_d_inner)),
                "ssm": zeros((g, batch, cfg.mamba_d_inner,
                              cfg.mamba_d_state), torch.float32)}})
        elif kind == "rwkv":
            h, hk = cfg.n_rwkv_heads, cfg.rwkv_head_dim
            caches.append({"rwkv": {
                "shift_t": zeros((g, batch, 1, cfg.d_model)),
                "shift_c": zeros((g, batch, 1, cfg.d_model)),
                "wkv": zeros((g, batch, h, hk, hk), torch.float32)}})
        else:
            raise ValueError(kind)
    return caches


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            embeds: torch.Tensor | None = None, cache_len: int | None = None):
    """Process the prompt; return (last_logits [B,V], cache, cache_pos [B])."""
    x, positions = _embed_inputs(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    cache_len = cache_len or s
    x, kv_stacks, _ = _run_groups(params, cfg, x, positions=positions)

    # Build the decode cache from the per-layer (k, v) stacks; mamba and
    # rwkv layers hand over their final states as they are.
    caches = init_cache(cfg, b, cache_len, device=x.device)
    quant = cfg.kv_cache_dtype == "int8"
    for j, c in enumerate(caches):
        if "attn" not in c:
            caches[j] = kv_stacks[j]
            continue
        c = c["attn"]
        k_all, v_all = kv_stacks[j]["attn_kv"]                # [G,B,S,KV,hd]
        w = c["k"].shape[2]
        tail = torch.arange(s - min(s, w), s, device=x.device)  # last W
        slots = tail % w
        k_tail, v_tail = k_all[:, :, tail], v_all[:, :, tail]
        if quant:
            k_tail, k_s = layers.quantize_kv(k_tail)
            v_tail, v_s = layers.quantize_kv(v_tail)
            c["k_scale"][:, :, slots] = k_s
            c["v_scale"][:, :, slots] = v_s
        c["k"][:, :, slots] = k_tail.to(c["k"].dtype)
        c["v"][:, :, slots] = v_tail.to(c["v"].dtype)
        c["pos"][:, :, slots] = tail.to(torch.int32)
    last = logits_from_hidden(params, cfg, x[:, -1:])[:, 0]
    cache_pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return last, caches, cache_pos


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, caches,
                cache_pos: torch.Tensor):
    """One decode step. token [B,1] int, cache_pos [B] = current length.
    Returns (logits [B,V], new_caches, cache_pos+1)."""
    x = embed_tokens(params, cfg, token)
    positions = cache_pos[:, None]
    x, new_caches, _ = _run_groups(params, cfg, x, positions=positions,
                                   caches=caches, cache_pos=cache_pos)
    logits = logits_from_hidden(params, cfg, x)[:, 0]
    return logits, new_caches, cache_pos + 1


def lm_loss(*args, **kwargs):
    raise NotImplementedError("LM training is not ported yet (ROADMAP "
                              "Queue 1, training)")
