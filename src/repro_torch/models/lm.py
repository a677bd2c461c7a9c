"""LM assembly: block dispatch, the group stack, forward / prefill / decode
and the training loss — port of `repro.models.lm`.

The layer stack is a plain loop over groups (the JAX package runs it under
`lax.scan`). Training runs each group under `torch.utils.checkpoint`
(`remat=True`, as the JAX package wraps the scan body in
`jax.checkpoint`): only the group's input is kept, and the group's
activations are recomputed in the backward pass. Params and caches keep
the JAX layout: a list over group positions whose leaves are stacked
[G, ...];
  attn  -> {"k","v" [G,B,W,KV,hd], "pos" [G,B,W]}   (W = window for local)
  mamba -> {"conv" [G,B,K-1,Din], "ssm" [G,B,Din,N] float32}
  rwkv  -> {"shift_t","shift_c" [G,B,1,D], "wkv" [G,B,H,K,V] float32}

The enc-dec model (`models/encdec.py`) runs its encoder through
`_run_groups` with `groups_key="enc_groups"` and `causal=False`, and its
decoder with `enc_out` (cross-attention in every block).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers, rwkv6
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import torch_dtype
from repro_torch.models.mamba import mamba_block
from repro_torch.models.moe import AUX_WEIGHT, moe_ffn
from repro_torch.params import tree_leaves, tree_map

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


def _encoder_attention(p, h, cfg, positions):
    """The encoder's bidirectional self-attention: dense at every length,
    as in the JAX package (never the chunked path or the kernel)."""
    mask = layers._mask(positions, positions, causal=False, window=None)
    q, k, v = layers._qkv(p, h, cfg, positions)
    return layers._out_proj(p, layers.attention_core(q, k, v, cfg, mask))


def apply_block(p, x: torch.Tensor, cfg, kind: str, is_moe: bool, *,
                positions: torch.Tensor, cache=None, cache_pos=None,
                enc_out=None, causal: bool = True):
    """One layer: (mixer + residual), then cross-attention + residual when
    `enc_out` is given (the enc-dec decoder), then (FFN + residual).
    `causal=False` is the encoder's attention block. Returns (x,
    new_cache, aux_loss)."""
    h = layers.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
    if kind in _ATTN and not causal:
        y, new_cache = _encoder_attention(p["attn"], h, cfg, positions), {}
    else:
        y, new_cache = _mixer(p, h, cfg, kind, positions, cache, cache_pos)
    if cfg.post_block_norm:
        y = layers.rmsnorm(y, p["post_ln1"]["scale"], cfg.norm_eps)
    x = x + y

    if enc_out is not None:                     # decoder cross-attention
        h = layers.rmsnorm(x, p["ln_x"]["scale"], cfg.norm_eps)
        x = x + layers.cross_attention(p["xattn"], h, enc_out, cfg)

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
                cache_pos=None, enc_out=None, causal: bool = True,
                remat: bool = False, groups_key: str = "groups",
                kinds=None, moes=None):
    """Every layer in order: group g, then position j within the group
    (JAX `_scan_groups`). `groups_key`, `kinds` and `moes` pick the stack
    (the encoder's is `"enc_groups"`, `["attn"]`, `[False]`); with
    `remat` each group runs under `torch.utils.checkpoint`, which changes
    memory, never values. Returns (x, per-position new caches stacked
    [G, ...], aux sum)."""
    kinds = kinds or cfg.layer_kinds()
    moes = moes if moes is not None else cfg.layer_is_moe()
    stacks = params[groups_key]
    n_groups = tree_leaves(stacks[0])[0].shape[0]

    def group(x, g):
        new_caches, aux_total = [], 0.0
        for j, kind in enumerate(kinds):
            grp = tree_map(lambda t: t[g], stacks[j])
            cache = (None if caches is None
                     else tree_map(lambda t: t[g], caches[j]))
            x, nc, aux = apply_block(grp, x, cfg, kind, moes[j],
                                     positions=positions, cache=cache,
                                     cache_pos=cache_pos, enc_out=enc_out,
                                     causal=causal)
            new_caches.append(nc)
            aux_total = aux_total + aux
        return x, new_caches, aux_total

    outs = [[] for _ in kinds]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(n_groups):
        if remat:
            x, ncs, aux = checkpoint(group, x, g, use_reentrant=False)
        else:
            x, ncs, aux = group(x, g)
        for j, nc in enumerate(ncs):
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


def _positions(x: torch.Tensor) -> torch.Tensor:
    """arange(S) for every row of x [B, S, D], int32."""
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def _embed_inputs(params, cfg, tokens, embeds):
    x = embed_tokens(params, cfg, tokens)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x, _positions(x)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            embeds: torch.Tensor | None = None, remat: bool = False):
    """Training/scoring forward. tokens [B,S_tok]; embeds [B,P,D]
    prepended (VLM patches). Returns (logits [B,S,V] float32, aux_loss)."""
    if cfg.is_enc_dec:
        raise ValueError("use encdec.forward_encdec for enc-dec models")
    x, positions = _embed_inputs(params, cfg, tokens, embeds)
    x, _, aux = _run_groups(params, cfg, x, positions=positions,
                            remat=remat)
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


# ------------------------------------------------------------------- loss

def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor):
    """Mean next-token cross-entropy: logits [B,T,V] at the positions that
    predict tokens[:, 1:] (T = S_tok - 1)."""
    tgt = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    return torch.mean(logz - gold)


def lm_loss(params, cfg: ModelConfig, batch, *, remat: bool = True,
            aux_weight: float = AUX_WEIGHT):
    """Next-token cross-entropy (+ MoE aux). batch: {"tokens" [B,S],
    optional "embeds" [B,P,D]} — targets are tokens shifted by one; with
    embeds the logits from position P on predict them."""
    tokens = batch["tokens"]
    embeds = batch.get("embeds")
    logits, aux = forward(params, cfg, tokens, embeds=embeds, remat=remat)
    p = 0 if embeds is None else embeds.shape[1]
    return next_token_nll(logits[:, p:-1], tokens) + aux_weight * aux
