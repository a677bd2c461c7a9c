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
decoder with `enc_out` (cross-attention in every block); its
tensor-parallel serving runs both through `_row_groups`, `enc_out` whole
on every member.

Tensor parallelism. `prefill` and `decode_step` take a runtime (`rt`, as
the JAX functions do); on an LM mesh they serve tensor-parallel over its
`model` axis (`distributed.tensor_parallel`: the layout, the rows, the
row collectives): every member of a replica's model row computes its
shard of each layer (`tp_apply_block`, the one definition of a block's
order, which `apply_block` runs on a row of one member; the mixer's and
the FFN's partial sums reduced before `post_block_norm` and the residual
add), the embedding is vocab-parallel (a member looks up the
ids in its range, zeros elsewhere, then a row sum) and so are the logits
(a member's float32 columns with the softcap and the pad mask, gathered
along V; the argmax runs on the whole logits). With `rt` None, or a
runtime whose mesh is not an LM mesh, they run the single-device path.

`forward` and `lm_loss` take a runtime too: on an LM mesh of one
data-parallel replica (the train step splits a batch over replicas and
hands each its row, `tensor_parallel.row_runtime`) the rows go through
the model row (`tensor_parallel.train_row_size` members; one where the
config does not split) with the members' slices cut from
the whole params by differentiable operations, so autograd returns whole
gradients; the layers run under remat as on one device. The loss is
vocab-parallel: each member's float32 logits slice (pad ids masked,
softcap applied) gives its max and sum of exponentials and the gold
logits of the ids it owns; member 0 combines them into the logsumexp
(`vocab_parallel_nll`), and the [B, T, V] logits are never gathered.
Every member routes the MoE layers redundantly; only member 0's routing
statistics and aux term count, so the aux gradient reaches the router
once a replica. `encdec.forward_encdec` / `encdec_loss` train the enc-dec
model on the same row (`_tp_train` with its `encoder`): the members'
`enc_out` copies feed their cross-attention as they stand, so the
backward sums the members' partial gradients of `enc_out`.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import placement
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import replica_positions
from repro_torch.models import layers, moe, rwkv6
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import torch_dtype
from repro_torch.models.mamba import mamba_in, mamba_out
from repro_torch.models.moe import AUX_WEIGHT, moe_ffn
from repro_torch.params import tree_leaves, tree_map

_ATTN = ("attn", "attn_local")


# ------------------------------------------------------------------ blocks

def _mixer(p, h, cfg, kind: str, positions, cache, cache_pos, cols=None):
    """The attention or rwkv block's sequence mixer (`tp_apply_block` runs
    mamba's in two halves around its row sum): (y, its new cache entry).
    Prefill (cache None) gives {"attn_kv": (k, v)} for attention and the
    final state for rwkv; decode gives the updated cache entry. `cols` is
    a tensor-parallel member's columns of D (rwkv's decay LoRA)."""
    if kind in _ATTN:
        y, c = layers.self_attention(
            p["attn"], h, cfg, positions=positions,
            local=(kind == "attn_local"),
            cache=None if cache is None else cache["attn"],
            cache_pos=cache_pos)
        return y, ({"attn_kv": c} if cache is None else {"attn": c})
    if kind == "rwkv":
        st = None if cache is None else cache["rwkv"]
        y, shift_t, wkv = rwkv6.time_mix(
            p["rwkv"], h, cfg,
            shift_state=None if st is None else st["shift_t"],
            wkv_state=None if st is None else st["wkv"], cols=cols)
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
    new_cache, aux_loss). It is `tp_apply_block` on a row of one member,
    whose row sums add nothing."""
    xs, new, aux = tp_apply_block(
        tp.SOLO, [p], [x], cfg, kind, is_moe, positions=[positions],
        caches=[cache], cache_pos=[cache_pos],
        enc_out=None if enc_out is None else [enc_out], causal=causal)
    return xs[0], new[0], aux[0]


def tp_apply_block(row, ps, xs, cfg, kind: str, is_moe: bool, *,
                   positions, caches=None, cache_pos=None, enc_out=None,
                   causal: bool = True):
    """One layer on a model row (`tensor_parallel.Row`, or `SOLO` for one
    device): `ps` are the members' slices of the block's params, and `xs`,
    `positions`, `caches`, `cache_pos` and `enc_out` lists over the
    members (the same activations on every member). Each member computes
    its shard of the mixer, the cross-attention (the enc-dec decoder's,
    over its `xattn` heads and the whole `enc_out`) and the FFN; the
    partial sums are reduced across the row before `post_block_norm`'s
    rmsnorm and before the residual add. `causal=False` is the encoder's
    block: dense bidirectional attention over the member's heads. Returns
    (xs, the members' new cache entries, the members' aux losses)."""
    m, eps = row.size, cfg.norm_eps
    caches = caches or [None] * m
    cache_pos = cache_pos or [None] * m

    def norm(name):
        return lambda k, p, x: layers.rmsnorm(x, p[name]["scale"], eps)

    def add(k, x, y):
        return x + y

    hs = row.map(norm("ln1"), ps, xs)
    if kind == "mamba":
        ins = row.map(lambda k, p, h, c: mamba_in(
            p["mamba"], h, cfg, state=None if c is None else c["mamba"]),
            ps, hs, caches)
        projs = tp.row_sum(row, [i[3] for i in ins])
        outs = row.map(lambda k, p, i, proj, c: mamba_out(
            p["mamba"], *i[:3], proj, cfg,
            state=None if c is None else c["mamba"]), ps, ins, projs, caches)
        ys, new = [o[0] for o in outs], [{"mamba": o[1]} for o in outs]
    elif kind in _ATTN and not causal:
        ys = row.map(lambda k, p, h, pos: _encoder_attention(
            p["attn"], h, cfg, pos), ps, hs, positions)
        new = [{} for _ in ys]
    else:
        d = cfg.d_model

        def mixer(k, p, h, pos, c, cp):
            cols = None if m == 1 else slice(k * d // m, (k + 1) * d // m)
            return _mixer(p, h, cfg, kind, pos, c, cp, cols=cols)

        outs = row.map(mixer, ps, hs, positions, caches, cache_pos)
        ys, new = [o[0] for o in outs], [o[1] for o in outs]
    ys = tp.row_sum(row, ys)
    if cfg.post_block_norm:
        ys = row.map(norm("post_ln1"), ps, ys)
    xs = row.map(add, xs, ys)

    if enc_out is not None:                     # decoder cross-attention
        ys = tp.row_sum(row, row.map(
            lambda k, p, x, e: layers.cross_attention(
                p["xattn"], layers.rmsnorm(x, p["ln_x"]["scale"], eps), e,
                cfg), ps, xs, enc_out))
        xs = row.map(add, xs, ys)

    hs = row.map(norm("ln2"), ps, xs)
    aux = [0.0] * m
    if kind == "rwkv":
        parts = row.map(lambda k, p, h, c: rwkv6.channel_mix_parts(
            p["cmix"], h,
            shift_state=None if c is None else c["rwkv"]["shift_c"]),
            ps, hs, caches)
        outs = tp.row_sum(row, [q[1] for q in parts])
        rrs = tp.row_gather(row, [q[0] for q in parts], -1)
        ys = row.map(lambda k, rr, out: rr * out, rrs, outs)
        for nc, q in zip(new, parts):
            nc["rwkv"]["shift_c"] = q[2]
    elif is_moe:
        outs = row.map(lambda k, p, h: moe_ffn(p["moe"], h, cfg,
                                                record=k == 0), ps, hs)
        ys, aux = tp.row_sum(row, [o[0] for o in outs]), [o[1] for o in outs]
    else:
        ys = tp.row_sum(row, row.map(
            lambda k, p, h: layers.swiglu_mlp(p["mlp"], h), ps, hs))
    if cfg.post_block_norm:
        ys = row.map(norm("post_ln2"), ps, ys)
    return row.map(add, xs, ys), new, aux


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
    [G, ...], aux sum). It is `_row_groups` on a row of one member."""
    xs, new, aux = _row_groups(
        tp.SOLO, [params], cfg, [x], positions=[positions],
        caches=None if caches is None else [caches], cache_pos=[cache_pos],
        enc_out=None if enc_out is None else [enc_out], causal=causal,
        remat=remat, groups_key=groups_key, kinds=kinds, moes=moes)
    return xs[0], new[0], aux[0]


def _row_groups(row, trees, cfg, xs, *, positions, caches=None,
                cache_pos=None, enc_out=None, causal: bool = True,
                remat: bool = False, groups_key: str = "groups",
                kinds=None, moes=None):
    """`_run_groups` on a model row: every layer in order through
    `tp_apply_block`; `trees` are the members' params (or slices),
    `caches` the members' caches, and `positions`, `cache_pos` and
    `enc_out` lists over the members. Returns (xs, the members' new
    caches stacked [G, ...], the members' aux sums)."""
    kinds = kinds or cfg.layer_kinds()
    moes = moes if moes is not None else cfg.layer_is_moe()
    n_groups = tree_leaves(trees[0][groups_key][0])[0].shape[0]

    def group(xs, g):
        row.enter()
        new_caches, aux_total = [[] for _ in trees], [0.0] * row.size
        for j, kind in enumerate(kinds):
            ps = [tree_map(lambda t: t[g], tr[groups_key][j])
                  for tr in trees]
            cs = None if caches is None else [
                tree_map(lambda t: t[g], c[j]) for c in caches]
            xs, ncs, aux = tp_apply_block(
                row, ps, xs, cfg, kind, moes[j], positions=positions,
                caches=cs, cache_pos=cache_pos, enc_out=enc_out,
                causal=causal)
            for k, nc in enumerate(ncs):
                new_caches[k].append(nc)
            aux_total = row.map(lambda k, a, b: a + b, aux_total, aux)
        return xs, new_caches, aux_total

    outs = [[[] for _ in kinds] for _ in trees]
    aux_total = row.map(lambda k, x: torch.zeros(
        (), dtype=torch.float32, device=x.device), xs)
    for g in range(n_groups):
        if remat:
            xs, ncs, aux = checkpoint(group, xs, g, use_reentrant=False)
        else:
            xs, ncs, aux = group(xs, g)
        for k, per in enumerate(ncs):
            for j, nc in enumerate(per):
                outs[k][j].append(nc)
        aux_total = row.map(lambda k, a, b: a + b, aux_total, aux)
    return (xs, row.map(lambda k, o: [_stack(p) for p in o], outs),
            aux_total)


# ---------------------------------------------------------------- forward

def embed_tokens(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["table"][tokens.long()]


def logits_from_hidden(params, cfg, x: torch.Tensor, *,
                       first_id: int = 0) -> torch.Tensor:
    """float32 logits of the vocabulary columns `params` holds: all of
    them, or a tensor-parallel member's, whose first id is `first_id`."""
    x = layers.rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].T
    else:
        logits = x @ params["lm_head"]["w"]
    logits = logits.float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.vocab_padded != cfg.vocab_size:   # mask Megatron-style pad ids
        ids = torch.arange(first_id, first_id + logits.shape[-1],
                           device=x.device)
        logits = torch.where(ids >= cfg.vocab_size, -1e9, logits)
    return logits


def _tp_embed(row, trees, cfg, tokens) -> list:
    """Vocab-parallel `embed_tokens`: a member looks up the ids in its
    rows of the table (zeros elsewhere), then a row sum."""

    def part(k, tr, tok):
        table = tr["embed"]["table"]
        n = table.shape[0]
        local = tok.long() - k * n
        inside = (local >= 0) & (local < n)
        return torch.where(inside[..., None], table[local.clamp(0, n - 1)],
                           0)

    return tp.row_sum(row, row.map(part, trees, tokens))


def _tp_logits(row, trees, cfg, xs) -> torch.Tensor:
    """Vocab-parallel `logits_from_hidden`: each member's columns, gathered
    along V on the row's first member."""
    def part(k, tr, x):
        w = tr["embed"]["table"] if cfg.tie_embeddings else tr["lm_head"]["w"].T
        return logits_from_hidden(tr, cfg, x, first_id=k * w.shape[0])

    return tp.row_gather(row, row.map(part, trees, xs), -1,
                         first_only=True)[0]


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
            embeds: torch.Tensor | None = None, remat: bool = False,
            rt=None):
    """Training/scoring forward. tokens [B,S_tok]; embeds [B,P,D]
    prepended (VLM patches). Returns (logits [B,S,V] float32, aux_loss).
    On an LM mesh (`rt`) tensor-parallel (module docstring), the logits
    gathered along V."""
    if cfg.is_enc_dec:
        raise ValueError("use encdec.forward_encdec for enc-dec models")
    if rt is not None and rt.lm_mesh is not None:
        return _tp_train(params, cfg, rt, tokens, embeds, remat,
                         _logits_head(cfg))
    x, positions = _embed_inputs(params, cfg, tokens, embeds)
    x, _, aux = _run_groups(params, cfg, x, positions=positions,
                            remat=remat)
    return logits_from_hidden(params, cfg, x), aux


# ------------------------------------------------------------------ serve

def _attn_alloc(cfg, kind: str, cache_len: int) -> int:
    if kind == "attn_local" and cfg.sliding_window:
        return min(cache_len, cfg.sliding_window)
    return cache_len


def _attn_cache(cfg, g: int, batch: int, w: int, kv: int, dtype, device):
    """An empty attention ring buffer of `kv` heads ({"k", "v" [G,B,W,KV,
    hd], "pos" [G,B,W] = -1}, int8 K/V with their scales under
    `kv_cache_dtype` "int8")."""
    quant = cfg.kv_cache_dtype == "int8"
    kv_dtype = torch.int8 if quant else dtype
    shape = (g, batch, w, kv, cfg.head_dim)
    c = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
         "v": torch.zeros(shape, dtype=kv_dtype, device=device),
         "pos": torch.full((g, batch, w), -1, dtype=torch.int32,
                           device=device)}
    if quant:
        c["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device)
        c["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device="cpu") -> list:
    """Empty decode cache (list over group positions, leaves [G, ...])."""
    dtype = dtype or torch_dtype(cfg.dtype)
    g = cfg.n_groups

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    caches = []
    for kind in cfg.layer_kinds():
        if kind in _ATTN:
            caches.append({"attn": _attn_cache(
                cfg, g, batch, _attn_alloc(cfg, kind, cache_len),
                cfg.n_kv_heads, dtype, device)})
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


def _prefill_caches(cfg, kv_stacks: list, s: int, cache_len: int) -> list:
    """The decode cache from prefill's per-layer stacks: each attention
    layer's last W (k, v) in a ring buffer of W slots with the heads its
    stack holds; mamba and rwkv layers hand over their final states as
    they are."""
    quant = cfg.kv_cache_dtype == "int8"
    caches = []
    for kind, st in zip(cfg.layer_kinds(), kv_stacks):
        if kind not in _ATTN:
            caches.append(st)
            continue
        k_all, v_all = st["attn_kv"]                          # [G,B,S,KV,hd]
        g, b, _, kv, _ = k_all.shape
        device = k_all.device
        c = _attn_cache(cfg, g, b, _attn_alloc(cfg, kind, cache_len), kv,
                        torch_dtype(cfg.dtype), device)
        w = c["k"].shape[2]
        tail = torch.arange(s - min(s, w), s, device=device)  # last W
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
        caches.append({"attn": c})
    return caches


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            embeds: torch.Tensor | None = None, cache_len: int | None = None,
            rt=None):
    """Process the prompt; return (last_logits [B,V], cache, cache_pos [B]).
    On an LM mesh (`rt`) `params` may also be a `tensor_parallel.TPLayout`
    of it, and the cache is a `tensor_parallel.TPCache`."""
    layout = tp.serving_layout(params, cfg, rt)
    if layout is not None:
        return _tp_prefill(layout, cfg, tokens, embeds, cache_len)
    x, positions = _embed_inputs(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    cache_len = cache_len or s
    x, kv_stacks, _ = _run_groups(params, cfg, x, positions=positions)
    caches = _prefill_caches(cfg, kv_stacks, s, cache_len)
    last = logits_from_hidden(params, cfg, x[:, -1:])[:, 0]
    cache_pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return last, caches, cache_pos


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, caches,
                cache_pos: torch.Tensor, rt=None):
    """One decode step. token [B,1] int, cache_pos [B] = current length.
    Returns (logits [B,V], new_caches, cache_pos+1). On an LM mesh (`rt`)
    as `prefill`."""
    layout = tp.serving_layout(params, cfg, rt)
    if layout is not None:
        return _tp_decode(layout, cfg, token, caches, cache_pos)
    x = embed_tokens(params, cfg, token)
    positions = cache_pos[:, None]
    x, new_caches, _ = _run_groups(params, cfg, x, positions=positions,
                                   caches=caches, cache_pos=cache_pos)
    logits = logits_from_hidden(params, cfg, x)[:, 0]
    return logits, new_caches, cache_pos + 1


def _tp_rows(layout, batch: int, device) -> list:
    """Every replica's `Row`, made before any work is launched (so no
    replica waits for another's), with its trees and its batch rows."""
    rows = layout.rows(batch)
    per = batch // len(rows)
    return [(tp.Row(layout.mesh, pos, device),
             [layout.members[p] for p in pos],
             slice(r * per, (r + 1) * per)) for r, pos in enumerate(rows)]


def _tp_prefill(layout, cfg, tokens, embeds, cache_len):
    """`prefill` tensor-parallel: each replica's rows through its model
    row; the last logits gathered on the caller's device."""
    rows = _tp_rows(layout, tokens.shape[0], tokens.device)
    last, blocks = [], []
    for row, trees, sl in rows:
        xs = _tp_embed(row, trees, cfg, row.put(tokens[sl]))
        if embeds is not None:
            xs = row.map(lambda k, e, x: torch.cat([e.to(x.dtype), x], 1),
                         row.put(embeds[sl]), xs)
        s = xs[0].shape[1]
        xs, kv_stacks, _ = _row_groups(
            row, trees, cfg, xs, positions=row.map(
                lambda k, x: _positions(x), xs))
        blocks.append(row.map(lambda k, kv: _prefill_caches(
            cfg, kv, s, cache_len or s), kv_stacks))
        out = _tp_logits(row, trees, cfg, [x[:, -1:] for x in xs])
        last.append(row.take(out[:, 0]))
    for row, _, _ in rows:
        row.close()
    cache_pos = torch.full((tokens.shape[0],), s, dtype=torch.int32,
                           device=tokens.device)
    return (torch.cat(last), tp.TPCache(blocks, layout.rows(tokens.shape[0])),
            cache_pos)


def _tp_decode(layout, cfg, token, caches, cache_pos, enc_out=None):
    """`decode_step` tensor-parallel on a `TPCache` of the same rows (the
    enc-dec decoder's too: each replica's rows of `enc_out` go to its
    members)."""
    if not isinstance(caches, tp.TPCache) or \
            caches.rows != layout.rows(token.shape[0]):
        raise ValueError("decode on a mesh takes the TPCache of a prefill "
                         "on the same rows")
    rows = _tp_rows(layout, token.shape[0], token.device)
    logits, blocks = [], []
    for (row, trees, sl), cache in zip(rows, caches.blocks):
        cps = row.put(cache_pos[sl])
        xs = _tp_embed(row, trees, cfg, row.put(token[sl]))
        xs, new, _ = _row_groups(
            row, trees, cfg, xs, positions=[cp[:, None] for cp in cps],
            caches=cache, cache_pos=cps,
            enc_out=None if enc_out is None else row.put(enc_out[sl]))
        blocks.append(new)
        logits.append(row.take(_tp_logits(row, trees, cfg, xs)[:, 0]))
    for row, _, _ in rows:
        row.close()
    return torch.cat(logits), tp.TPCache(blocks, caches.rows), cache_pos + 1


# ------------------------------------------------------------------- loss

def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor):
    """Mean next-token cross-entropy: logits [B,T,V] at the positions that
    predict tokens[:, 1:] (T = S_tok - 1)."""
    tgt = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    return torch.mean(logz - gold)


def vocab_parallel_nll(row, trees, cfg, xs, tokens) -> torch.Tensor:
    """`next_token_nll(logits_from_hidden(params, cfg, x), tokens)` on a
    model row, on its first member, without gathering the logits: `xs`
    are the members' hidden states at the positions that predict
    tokens[:, 1:] (the same on every member), `tokens` the members'
    copies. Each member's float32 logits slice gives its max (detached:
    it only keeps the exponentials finite), its sum of exponentials and
    the gold logits of the ids it owns (zero elsewhere); member 0 forms
    the logsumexp from the members' parts and the mean of logsumexp -
    gold."""
    def part(k, tr, x, tok):
        w = tr["embed"]["table"] if cfg.tie_embeddings else tr["lm_head"]["w"].T
        n = w.shape[0]
        logits = logits_from_hidden(tr, cfg, x, first_id=k * n)
        top = logits.detach().amax(-1)
        sumexp = torch.exp(logits - top[..., None]).sum(-1)
        local = tok[:, 1:].long() - k * n
        inside = (local >= 0) & (local < n)
        gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])
        gold = torch.where(inside, gold[..., 0], 0.0)
        return torch.stack([top, sumexp, gold], -1)[..., None, :]

    parts = tp.row_gather(row, row.map(part, trees, xs, tokens), -2,
                          first_only=True)[0]             # [B, T, m, 3]
    with torch.cuda.stream(row.streams[0]):
        top, sumexp, gold = parts.unbind(-1)
        big = top.amax(-1)
        logz = big + torch.log(torch.sum(
            sumexp * torch.exp(top - big[..., None]), -1))
        return torch.mean(logz - gold.sum(-1))


def _tp_train(params, cfg, rt, tokens, embeds, remat, head, encoder=None):
    """The training forward on `rt`'s LM mesh, one model row: (`head(row,
    trees, xs, tokens)` on the caller, the aux loss). The members' slices
    are cut from the whole `params` on their streams before any layer
    runs. `encoder(row, trees)` (the enc-dec model's) gives the members'
    `enc_out`, which the decoder's cross-attention reads. A mesh of
    several data-parallel replicas raises: the train step splits the
    batch over them (`train.step`) and hands each replica's loss its row
    (`tensor_parallel.row_runtime`)."""
    mesh = rt.lm_mesh
    firsts = replica_positions(mesh, [a for a in rt.batch_axes
                                      if a in mesh.shape])
    if len(firsts) > 1:
        raise ValueError(
            f"the training loss and forward on a mesh run one model row; "
            f"this mesh has {len(firsts)} replicas over "
            f"{tuple(rt.batch_axes)}: train through "
            f"train.step.build_train_step, which splits the batch over them")
    m, _ = tp.train_row_size(cfg, mesh)
    whole = tree_map(placement.gather, params)
    row = tp.Row(mesh, tp.row_positions(mesh, firsts[0], m), tokens.device)
    trees = tp.row_params(row, whole, m)
    with moe.route_stats() as seen:
        enc_out = None if encoder is None else encoder(row, trees)
        xs = _tp_embed(row, trees, cfg, row.put(tokens))
        if embeds is not None:
            xs = row.map(lambda k, e, x: torch.cat([e.to(x.dtype), x], 1),
                         row.put(embeds), xs)
        xs, _, aux = _row_groups(
            row, trees, cfg, xs, positions=row.map(
                lambda k, x: _positions(x), xs), enc_out=enc_out,
            remat=remat)
    out = row.take(head(row, trees, xs, row.put(tokens)))
    aux = row.take(aux[0])
    row.close([t for pair in seen for t in pair])
    return out, aux


def _nll_head(cfg, p: int):
    """`_tp_train`'s head of the training loss: the next-token
    cross-entropy of the hidden states from position `p` on; on a row of
    one member the single-device loss's bits, else vocab-parallel."""
    def head(row, trees, xs, tok):
        if row.size == 1:
            return next_token_nll(logits_from_hidden(
                trees[0], cfg, xs[0])[:, p:-1], tok[0])
        return vocab_parallel_nll(row, trees, cfg, [x[:, p:-1] for x in xs],
                                  tok)

    return head


def _logits_head(cfg):
    """`_tp_train`'s head of the training forward: the logits gathered
    along V on the row's first member."""
    return lambda row, trees, xs, tok: _tp_logits(row, trees, cfg, xs)


def lm_loss(params, cfg: ModelConfig, batch, *, remat: bool = True,
            aux_weight: float = AUX_WEIGHT, rt=None):
    """Next-token cross-entropy (+ MoE aux). batch: {"tokens" [B,S],
    optional "embeds" [B,P,D]} — targets are tokens shifted by one; with
    embeds the logits from position P on predict them. On an LM mesh
    (`rt`, one model row) tensor-parallel with the vocab-parallel
    cross-entropy (module docstring)."""
    tokens = batch["tokens"]
    embeds = batch.get("embeds")
    p = 0 if embeds is None else embeds.shape[1]
    if rt is not None and rt.lm_mesh is not None:
        nll, aux = _tp_train(params, cfg, rt, tokens, embeds, remat,
                             _nll_head(cfg, p))
        return nll + aux_weight * aux
    logits, aux = forward(params, cfg, tokens, embeds=embeds, remat=remat)
    return next_token_nll(logits[:, p:-1], tokens) + aux_weight * aux
