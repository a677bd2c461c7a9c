"""Shared LM layers: norms, RoPE, attention (prefill/decode), MLP — port of
`repro.models.layers`.

Attention has two exact paths, as in the JAX package:
  * dense — score matrix materialized; used for short sequences and for
    single-token decode against a KV cache (scores are [B,H,1,S] — tiny);
  * chunked — online softmax over KV blocks, so the [T,S] score matrix
    never materializes; used for prompts of `CHUNK_THRESHOLD` tokens or
    more. On CUDA tensors it is the kernel `kernels.flash_attn.
    flash_attention` (`csrc/flash_attn.cu`, the realization the JAX package
    names for this recurrence), one launch per layer; on CPU tensors the
    plain loop `chunked_attention_core`. The kernel masks by index from 0,
    which equals the positions' masks because prefill positions are
    arange(S).

The rest is plain PyTorch, as the JAX package computes it with XLA
outside any Pallas kernel. Masks follow the JAX package's causal,
sliding-window and softcap semantics. `cross_attention` (the enc-dec
decoder's) is always dense, as in the JAX package.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn import flash_attention

NEG_INF = -1e30
CHUNK_THRESHOLD = 2048
KV_CHUNK = 1024


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rms * (1.0 + w.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x [B, T, H, hd], positions [B, T] -> rotated x."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs                # [B,T,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), as `jax.nn.silu`."""
    return x * torch.sigmoid(x)


def swiglu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    gate, up = (x @ p["w_in"]).chunk(2, dim=-1)
    return (silu(gate) * up) @ p["w_out"]


# ---------------------------------------------------------------- attention

def _qkv(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    """q, k, v [B, T, heads, hd]. The head counts come from the weights'
    widths, so a tensor-parallel member's slice of whole heads (and whole
    GQA groups) runs unchanged; `_out_proj` then gives its partial sum."""
    b, t, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["wq_b"], k + p["wk_b"], v + p["wv_b"]
    q = q.reshape(b, t, -1, cfg.head_dim)
    k = k.reshape(b, t, -1, cfg.head_dim)
    v = v.reshape(b, t, -1, cfg.head_dim)
    if cfg.rope_theta is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scores(q: torch.Tensor, k: torch.Tensor, cfg) -> torch.Tensor:
    """[B,T,H,hd] x [B,S,KV,hd] -> [B,H,T,S] float32, GQA via reshape."""
    b, t, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, t, kv, g, hd)
    sc = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) \
        * (hd ** -0.5)
    sc = sc.reshape(b, kv * g, t, s)
    if cfg.attn_softcap is not None:
        sc = cfg.attn_softcap * torch.tanh(sc / cfg.attn_softcap)
    return sc


def _apply_probs(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B,H,T,S] x [B,S,KV,hd] -> [B,T,H,hd] float32."""
    b, h, t, s = p.shape
    kv = v.shape[2]
    pg = p.reshape(b, kv, h // kv, t, s)
    out = torch.einsum("bkgts,bskd->btkgd", pg, v.float())
    return out.reshape(b, t, h, v.shape[-1])


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
          window: int | None, kv_len_mask: torch.Tensor | None = None):
    """q_pos [B,T], kv_pos [B,S] -> bool [B,1,T,S]."""
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    m = torch.ones((qp.shape[0], qp.shape[1], kp.shape[2]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & ((qp - kp) < window)
    if kv_len_mask is not None:
        m = m & kv_len_mask[:, None, :]
    return m[:, None, :, :]


def attention_core(q, k, v, cfg, mask) -> torch.Tensor:
    """Exact masked attention, dense scores. mask [B,1,T,S] bool."""
    sc = _scores(q, k, cfg)
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    p = torch.where(mask, p, 0.0)
    return _apply_probs(p, v).to(q.dtype)


def chunked_attention_core(q, k, v, cfg, *, q_pos, kv_pos, causal,
                           window) -> torch.Tensor:
    """Online softmax over KV chunks of `KV_CHUNK` (the flash recurrence);
    the last chunk is padded with positions that every mask drops."""
    b, t, h, hd = q.shape
    s = k.shape[1]
    n_chunks = -(-s // KV_CHUNK)
    pad = n_chunks * KV_CHUNK - s
    if pad:
        k = torch.cat([k, k.new_zeros((b, pad) + k.shape[2:])], 1)
        v = torch.cat([v, v.new_zeros((b, pad) + v.shape[2:])], 1)
        kv_pos = torch.cat([kv_pos, kv_pos.new_full((b, pad), 2**30)], 1)
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, t, hd), dtype=torch.float32, device=q.device)
    for i in range(n_chunks):
        cols = slice(i * KV_CHUNK, (i + 1) * KV_CHUNK)
        sc = _scores(q, k[:, cols], cfg)                           # [B,H,T,C]
        msk = _mask(q_pos, kv_pos[:, cols], causal=causal, window=window)
        sc = torch.where(msk, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        pr = torch.exp(sc - m_new[..., None])
        pr = torch.where(msk, pr, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + pr.sum(-1)
        acc = acc * alpha[..., None] + _apply_probs(
            pr, v[:, cols]).transpose(1, 2)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                         # [B,T,H,hd]


def _out_proj(p, out: torch.Tensor) -> torch.Tensor:
    b, t = out.shape[:2]
    return out.reshape(b, t, -1) @ p["wo"]


def self_attention(p, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                   local: bool, cache=None, cache_pos=None):
    """Self-attention. Prefill (cache=None): returns (y, (k, v)) so the
    caller can build a KV cache. Decode (cache given): x is [B,1,D]; the
    cache is a *ring buffer* {"k","v" [B,W,KV,hd], "pos" [B,W] int32
    (-1 = empty)}, written at `cache_pos % W`; for sliding-window layers
    W == window. The returned cache holds new tensors (the JAX update is
    functional, and so is this one)."""
    window = cfg.sliding_window if local else None
    q, k, v = _qkv(p, x, cfg, positions)

    if cache is None:
        if x.shape[1] >= CHUNK_THRESHOLD and q.is_cuda:
            # prefill positions are arange(S) (`lm._embed_inputs`), which is
            # what the kernel's index-based masks assume
            out = flash_attention(q, k, v, causal=True, window=window,
                                  softcap=cfg.attn_softcap)
        elif x.shape[1] >= CHUNK_THRESHOLD:
            out = chunked_attention_core(q, k, v, cfg, q_pos=positions,
                                         kv_pos=positions, causal=True,
                                         window=window)
        else:
            mask = _mask(positions, positions, causal=True, window=window)
            out = attention_core(q, k, v, cfg, mask)
        return _out_proj(p, out), (k, v)

    k_cache, v_cache, pos_buf = cache["k"], cache["v"], cache["pos"]
    w_alloc = k_cache.shape[1]
    slot = cache_pos % w_alloc                                      # [B]
    onehot = (torch.arange(w_alloc, device=x.device)[None, :]
              == slot[:, None])                                     # [B, W]
    sel = onehot[:, :, None, None]
    quant = "k_scale" in cache
    if quant:     # int8 KV (per token x head absmax scale)
        k_q, k_s = quantize_kv(k)
        v_q, v_s = quantize_kv(v)
        k_cache = torch.where(sel, k_q, k_cache)
        v_cache = torch.where(sel, v_q, v_cache)
        k_scale = torch.where(onehot[:, :, None], k_s, cache["k_scale"])
        v_scale = torch.where(onehot[:, :, None], v_s, cache["v_scale"])
        k_use = k_cache.float() * k_scale[..., None]
        v_use = v_cache.float() * v_scale[..., None]
    else:
        k_cache = torch.where(sel, k.to(k_cache.dtype), k_cache)
        v_cache = torch.where(sel, v.to(v_cache.dtype), v_cache)
        k_use, v_use = k_cache, v_cache
    pos_buf = torch.where(onehot, cache_pos[:, None], pos_buf)
    valid = (pos_buf >= 0) & (pos_buf <= cache_pos[:, None])
    mask = _mask(positions, pos_buf, causal=False, window=window,
                 kv_len_mask=valid)
    out = attention_core(q, k_use, v_use, cfg, mask)
    new_cache = {"k": k_cache, "v": v_cache, "pos": pos_buf}
    if quant:
        new_cache["k_scale"] = k_scale
        new_cache["v_scale"] = v_scale
    return _out_proj(p, out), new_cache


def quantize_kv(x: torch.Tensor):
    """[..., hd] -> (int8 values, per-row absmax/127 scale [...])."""
    x32 = x.float()
    s = torch.clamp(x32.abs().amax(-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def cross_attention(p, x: torch.Tensor, enc_out: torch.Tensor, cfg,
                    enc_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Decoder cross-attention (seamless), dense — port of `repro.models.
    layers.cross_attention`. x [B,T,D], enc_out [B,S,D], enc_mask [B,S]
    bool or None (every frame seen). No RoPE, no bias, no causal mask:
    queries and keys all sit at position 0. The head counts come from the
    weights' widths, as in `_qkv`, so a tensor-parallel member's slice of
    whole heads gives its partial sum through `_out_proj`."""
    b, t, _ = x.shape
    s = enc_out.shape[1]
    q = (x @ p["wq"]).reshape(b, t, -1, cfg.head_dim)
    k = (enc_out @ p["wk"]).reshape(b, s, -1, cfg.head_dim)
    v = (enc_out @ p["wv"]).reshape(b, s, -1, cfg.head_dim)
    q_pos = torch.zeros((b, t), dtype=torch.int32, device=x.device)
    kv_pos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    mask = _mask(q_pos, kv_pos, causal=False, window=None,
                 kv_len_mask=enc_mask)
    return _out_proj(p, attention_core(q, k, v, cfg, mask))
