"""Encoder-decoder assembly (the seamless-m4t backbone) — port of
`repro.models.encdec`.

The audio frontend is a stub: callers feed precomputed fbank-frame
*embeddings* [B, S_enc, D] straight into the encoder. The encoder is a
bidirectional attention stack (`lm._run_groups` over `enc_groups` with
`causal=False`, dense attention at every length); the decoder is the
`lm` stack with cross-attention in every block (`ln_x` / `xattn`). As in
the JAX package, decode recomputes the cross-attention K and V from
`enc_out` at every step: the cache holds only the decoder's
self-attention.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers, lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import torch_dtype
from repro_torch.models.moe import AUX_WEIGHT


def encode(params, cfg: ModelConfig, frames: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """frames [B, S_enc, D] (precomputed frame embeddings) -> enc_out."""
    x = frames.to(torch_dtype(cfg.dtype))
    x, _, _ = lm._run_groups(params, cfg, x, positions=lm._positions(x),
                             causal=False, remat=remat,
                             groups_key="enc_groups", kinds=["attn"],
                             moes=[False])
    return layers.rmsnorm(x, params["enc_final_norm"]["scale"], cfg.norm_eps)


def forward_encdec(params, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor, *, remat: bool = False):
    """Training forward: the encoder over frames, the decoder over target
    tokens with cross-attention. Returns (logits [B,S_dec,V], aux)."""
    enc_out = encode(params, cfg, frames, remat=remat)
    x = lm.embed_tokens(params, cfg, tokens)
    x, _, aux = lm._run_groups(params, cfg, x, positions=lm._positions(x),
                               enc_out=enc_out, remat=remat)
    return lm.logits_from_hidden(params, cfg, x), aux


def encdec_loss(params, cfg: ModelConfig, batch, *, remat: bool = True,
                aux_weight: float = AUX_WEIGHT):
    """Next-token cross-entropy of the decoder (+ aux). batch: {"frames"
    [B,S_enc,D], "tokens" [B,S_dec]}."""
    logits, aux = forward_encdec(params, cfg, batch["frames"],
                                 batch["tokens"], remat=remat)
    return lm.next_token_nll(logits[:, :-1], batch["tokens"]) \
        + aux_weight * aux


def prefill_encdec(params, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor, *, cache_len: int | None = None):
    """Encoder pass + decoder prompt prefill. Returns (last_logits [B,V],
    enc_out, caches, cache_pos [B]).

    The cache is built as the JAX package builds it: the prompt's last W
    keys and values cast to the cache's dtype. An int8 KV config casts
    them without scales (the JAX function does the same)."""
    enc_out = encode(params, cfg, frames)
    x = lm.embed_tokens(params, cfg, tokens)
    b, s, _ = x.shape
    cache_len = cache_len or s
    x, kv_stacks, _ = lm._run_groups(params, cfg, x,
                                     positions=lm._positions(x),
                                     enc_out=enc_out)
    caches = lm.init_cache(cfg, b, cache_len, device=x.device)
    for j, c in enumerate(caches):
        c = c["attn"]
        k_all, v_all = kv_stacks[j]["attn_kv"]                # [G,B,S,KV,hd]
        w = c["k"].shape[2]
        tail = torch.arange(s - min(s, w), s, device=x.device)
        slots = tail % w
        c["k"][:, :, slots] = k_all[:, :, tail].to(c["k"].dtype)
        c["v"][:, :, slots] = v_all[:, :, tail].to(c["v"].dtype)
        c["pos"][:, :, slots] = tail.to(torch.int32)
    last = lm.logits_from_hidden(params, cfg, x[:, -1:])[:, 0]
    return last, enc_out, caches, torch.full((b,), s, dtype=torch.int32,
                                             device=x.device)


def decode_step_encdec(params, cfg: ModelConfig, token: torch.Tensor,
                       enc_out: torch.Tensor, caches, cache_pos: torch.Tensor):
    """One decoder step against the self-attention cache, cross-attending
    to enc_out. token [B,1]. Returns (logits [B,V], new_caches,
    cache_pos+1)."""
    x = lm.embed_tokens(params, cfg, token)
    x, new_caches, _ = lm._run_groups(params, cfg, x,
                                      positions=cache_pos[:, None],
                                      caches=caches, cache_pos=cache_pos,
                                      enc_out=enc_out)
    logits = lm.logits_from_hidden(params, cfg, x)[:, 0]
    return logits, new_caches, cache_pos + 1
