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

Tensor parallelism. `prefill_encdec` and `decode_step_encdec` take a
runtime (`rt`, as the JAX functions do); on an LM mesh they serve
tensor-parallel over its `model` axis as `lm.prefill` / `lm.decode_step`
serve a decoder (`distributed.tensor_parallel`). The batch is split over
the data-parallel replicas, and each replica's frames go to every member
of its model row. A member computes its heads and FFN units of every
encoder layer (the partial sums reduced across the row), then
`enc_final_norm` over the whole `enc_out`, which every member holds.
The decoder embeds and projects to logits vocab-parallel, and a member
computes its heads of the self-attention, its `xattn` heads of the
cross-attention (their K and V from the whole `enc_out`) and its FFN
units. The self-attention cache is a `tensor_parallel.TPCache` of the
members' heads. Prefill returns `enc_out` whole on the caller's device,
the replicas joined along the batch, and decode hands each replica's
rows of it to its members. With `rt` None, or a runtime whose mesh is
not an LM mesh, both run the single-device path.

`forward_encdec` and `encdec_loss` take a runtime too, and train on an
LM mesh of one data-parallel replica as `lm.forward` / `lm.lm_loss` do
(`lm._tp_train`; the train step splits a batch over the replicas and
hands each its row): the members' slices are cut from the whole params
by differentiable operations, each member runs its shard of every
encoder layer and then of every decoder layer, both stacks under remat,
and the loss is vocab-parallel (`lm.vocab_parallel_nll`) on a row of
more than one member. The members' `enc_out` copies go to their
cross-attention as they are (never taken to the caller and put back),
so the backward of the last encoder layer's row sum adds up the
members' partial gradients of `enc_out`, and the replicated
`enc_final_norm` gets the sum over the members that read it.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers, lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import torch_dtype
from repro_torch.models.moe import AUX_WEIGHT


def _row_encode(row, trees, cfg, frames, *, remat: bool = False) -> list:
    """`encode` on a model row (`tensor_parallel.Row`, or `SOLO`):
    `frames` are the members' copies, `trees` their params; returns the
    members' enc_out, the same on each."""
    xs = row.map(lambda k, f: f.to(torch_dtype(cfg.dtype)), frames)
    xs, _, _ = lm._row_groups(
        row, trees, cfg, xs, positions=row.map(
            lambda k, x: lm._positions(x), xs), causal=False, remat=remat,
        groups_key="enc_groups", kinds=["attn"], moes=[False])
    return row.map(lambda k, tr, x: layers.rmsnorm(
        x, tr["enc_final_norm"]["scale"], cfg.norm_eps), trees, xs)


def encode(params, cfg: ModelConfig, frames: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """frames [B, S_enc, D] (precomputed frame embeddings) -> enc_out."""
    return _row_encode(tp.SOLO, [params], cfg, [frames], remat=remat)[0]


def _tp_train(params, cfg, rt, frames, tokens, remat, head):
    """`lm._tp_train` with the encoder: every member encodes its copy of
    `frames` on the row, and the decoder reads the members' enc_out."""
    def encoder(row, trees):
        return _row_encode(row, trees, cfg, row.put(frames), remat=remat)

    return lm._tp_train(params, cfg, rt, tokens, None, remat, head,
                        encoder=encoder)


def forward_encdec(params, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor, *, remat: bool = False, rt=None):
    """Training forward: the encoder over frames, the decoder over target
    tokens with cross-attention. Returns (logits [B,S_dec,V], aux). On an
    LM mesh (`rt`, one model row) tensor-parallel (module docstring), the
    logits gathered along V."""
    if rt is not None and rt.lm_mesh is not None:
        return _tp_train(params, cfg, rt, frames, tokens, remat,
                         lm._logits_head(cfg))
    enc_out = encode(params, cfg, frames, remat=remat)
    x = lm.embed_tokens(params, cfg, tokens)
    x, _, aux = lm._run_groups(params, cfg, x, positions=lm._positions(x),
                               enc_out=enc_out, remat=remat)
    return lm.logits_from_hidden(params, cfg, x), aux


def encdec_loss(params, cfg: ModelConfig, batch, *, remat: bool = True,
                aux_weight: float = AUX_WEIGHT, rt=None):
    """Next-token cross-entropy of the decoder (+ aux). batch: {"frames"
    [B,S_enc,D], "tokens" [B,S_dec]}. On an LM mesh (`rt`, one model row)
    tensor-parallel with the vocab-parallel cross-entropy (module
    docstring)."""
    if rt is not None and rt.lm_mesh is not None:
        nll, aux = _tp_train(params, cfg, rt, batch["frames"],
                             batch["tokens"], remat, lm._nll_head(cfg, 0))
        return nll + aux_weight * aux
    logits, aux = forward_encdec(params, cfg, batch["frames"],
                                 batch["tokens"], remat=remat)
    return lm.next_token_nll(logits[:, :-1], batch["tokens"]) \
        + aux_weight * aux


def _prefill_cache(cfg, kv_stacks: list, s: int, cache_len: int) -> list:
    """The decoder's self-attention cache from prefill's per-layer (k, v)
    stacks [G,B,S,KV,hd], built as the JAX package builds it: the prompt's
    last W keys and values cast to the cache's dtype, in a ring buffer of
    the heads the stacks hold. An int8 KV config casts them without scales
    (the JAX function does the same)."""
    caches = []
    for kind, st in zip(cfg.layer_kinds(), kv_stacks):
        k_all, v_all = st["attn_kv"]
        g, b, _, kv, _ = k_all.shape
        device = k_all.device
        c = lm._attn_cache(cfg, g, b, lm._attn_alloc(cfg, kind, cache_len),
                           kv, torch_dtype(cfg.dtype), device)
        w = c["k"].shape[2]
        tail = torch.arange(s - min(s, w), s, device=device)
        slots = tail % w
        c["k"][:, :, slots] = k_all[:, :, tail].to(c["k"].dtype)
        c["v"][:, :, slots] = v_all[:, :, tail].to(c["v"].dtype)
        c["pos"][:, :, slots] = tail.to(torch.int32)
        caches.append({"attn": c})
    return caches


def prefill_encdec(params, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor, *, cache_len: int | None = None,
                   rt=None):
    """Encoder pass + decoder prompt prefill. Returns (last_logits [B,V],
    enc_out [B,S_enc,D], caches, cache_pos [B]); the cache as
    `_prefill_cache` builds it. On an LM mesh (`rt`) `params` may also be
    a `tensor_parallel.TPLayout` of it, and the cache is a
    `tensor_parallel.TPCache` (module docstring)."""
    layout = tp.serving_layout(params, cfg, rt)
    if layout is not None:
        return _tp_prefill(layout, cfg, frames, tokens, cache_len)
    enc_out = encode(params, cfg, frames)
    x = lm.embed_tokens(params, cfg, tokens)
    b, s, _ = x.shape
    x, kv_stacks, _ = lm._run_groups(params, cfg, x,
                                     positions=lm._positions(x),
                                     enc_out=enc_out)
    caches = _prefill_cache(cfg, kv_stacks, s, cache_len or s)
    last = lm.logits_from_hidden(params, cfg, x[:, -1:])[:, 0]
    return last, enc_out, caches, torch.full((b,), s, dtype=torch.int32,
                                             device=x.device)


def _tp_prefill(layout, cfg, frames, tokens, cache_len):
    """`prefill_encdec` tensor-parallel: each replica's frames and prompt
    through its model row; the last logits and enc_out joined on the
    caller's device."""
    b = tokens.shape[0]
    rows = lm._tp_rows(layout, b, tokens.device)
    last, enc, blocks = [], [], []
    for row, trees, sl in rows:
        es = _row_encode(row, trees, cfg, row.put(frames[sl]))
        xs = lm._tp_embed(row, trees, cfg, row.put(tokens[sl]))
        s = xs[0].shape[1]
        xs, kv_stacks, _ = lm._row_groups(
            row, trees, cfg, xs, positions=row.map(
                lambda k, x: lm._positions(x), xs), enc_out=es)
        blocks.append(row.map(lambda k, kv: _prefill_cache(
            cfg, kv, s, cache_len or s), kv_stacks))
        out = lm._tp_logits(row, trees, cfg, [x[:, -1:] for x in xs])
        last.append(row.take(out[:, 0]))
        enc.append(row.take(es[0]))
    for row, _, _ in rows:
        row.close()
    cache_pos = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return (torch.cat(last), torch.cat(enc),
            tp.TPCache(blocks, layout.rows(b)), cache_pos)


def decode_step_encdec(params, cfg: ModelConfig, token: torch.Tensor,
                       enc_out: torch.Tensor, caches, cache_pos: torch.Tensor,
                       rt=None):
    """One decoder step against the self-attention cache, cross-attending
    to enc_out. token [B,1]. Returns (logits [B,V], new_caches,
    cache_pos+1). On an LM mesh (`rt`) as `prefill_encdec`, on the
    `TPCache` of a prefill on the same rows."""
    layout = tp.serving_layout(params, cfg, rt)
    if layout is not None:
        return lm._tp_decode(layout, cfg, token, caches, cache_pos,
                             enc_out=enc_out)
    x = lm.embed_tokens(params, cfg, token)
    x, new_caches, _ = lm._run_groups(params, cfg, x,
                                      positions=cache_pos[:, None],
                                      caches=caches, cache_pos=cache_pos,
                                      enc_out=enc_out)
    logits = lm.logits_from_hidden(params, cfg, x)[:, 0]
    return logits, new_caches, cache_pos + 1
