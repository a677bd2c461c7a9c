"""Serving steps: prefill, decode and greedy generation for every family,
enc-dec included — port of `repro.serve.step`.

The JAX package jits each step; the port runs them eagerly under
`torch.inference_mode`. On the card the model's kernels launch from the
layers: with `cfg.moe_use_kernel` every MoE layer's expert FFN is one
launch of `csrc/moe_experts.cu`; every rwkv layer runs `csrc/wkv6.cu` and
every mamba layer `csrc/mamba_scan.cu` once per step; prompts of 2048
tokens or more run `csrc/flash_attn.cu` once per (decoder) attention layer
in prefill. The enc-dec steps (seamless) take the encoder's frames in
prefill and its output in decode, as the JAX package's do.

Each `build_*_step` takes a runtime, as the JAX package's do (`rt`,
default None). On an LM mesh a model serves tensor-parallel over the
mesh's `model` axis and data-parallel over its `rt.batch_axes`
(`distributed.tensor_parallel`), each member of a model row launching its
shard's kernels on its own stream: the steps take whole params, sharded
params or a `tensor_parallel.tp_layout` of them (build it once to serve
many calls without slicing again), and their cache is a
`tensor_parallel.TPCache`. The enc-dec steps cut the encoder, the
decoder's self- and cross-attention and both FFNs the same way
(`models/encdec.py`); prefill returns `enc_out` whole, and decode takes
it back. With `rt` None, or a runtime whose mesh is not an LM mesh, every
step runs the single-device path.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig
from repro_torch.params import params_to


def build_prefill_step(cfg: ModelConfig, rt=None):
    """step(params, tokens, embeds=None, cache_len=None) -> (last_logits,
    caches, cache_pos); for enc-dec step(params, frames, tokens,
    cache_len=None) -> (last_logits, enc_out, caches, cache_pos)."""
    if cfg.is_enc_dec:
        @torch.inference_mode()
        def encdec_step(params, frames, tokens, cache_len=None):
            return encdec.prefill_encdec(params, cfg, frames, tokens,
                                         cache_len=cache_len, rt=rt)
        return encdec_step

    @torch.inference_mode()
    def step(params, tokens, embeds=None, cache_len=None):
        return lm.prefill(params, cfg, tokens, embeds=embeds,
                          cache_len=cache_len, rt=rt)
    return step


def build_decode_step(cfg: ModelConfig, rt=None):
    """step(params, token, caches, cache_pos) -> (logits, caches,
    cache_pos); for enc-dec step(params, token, enc_out, caches,
    cache_pos)."""
    if cfg.is_enc_dec:
        @torch.inference_mode()
        def encdec_step(params, token, enc_out, caches, cache_pos):
            return encdec.decode_step_encdec(params, cfg, token, enc_out,
                                             caches, cache_pos, rt=rt)
        return encdec_step

    @torch.inference_mode()
    def step(params, token, caches, cache_pos):
        return lm.decode_step(params, cfg, token, caches, cache_pos, rt=rt)
    return step


def greedy_generate(params, cfg: ModelConfig, prompt, *, max_new: int = 16,
                    embeds=None, device=None, rt=None) -> torch.Tensor:
    """Greedy decoding of `max_new` tokens after `prompt` [B, S] (tensor or
    array): prefill, then `max_new - 1` decode steps against a cache of the
    prompt's length, as the JAX package's host loop. Runs on `device`
    (None = the card; raises without CUDA unless "cpu"); params and inputs
    are moved there (a no-op for tensors already there). On an LM mesh
    (`rt`) it runs on the mesh's devices (a `device` of another kind
    raises ValueError) and builds the `tp_layout` once a call, unless
    `params` is one already. The argmax runs on the whole logits. Returns
    [B, max_new] int32 token ids. Enc-dec models raise
    NotImplementedError, as in the JAX package: their steps are driven
    directly."""
    if cfg.is_enc_dec:
        raise NotImplementedError("use encdec steps directly")
    mesh = None if rt is None else rt.lm_mesh
    if mesh is None:
        dev = resolve_device(device)
        params = params_to(params, dev)
    else:
        dev = mesh.devices[0]
        if device is not None and resolve_device(device).type != dev.type:
            raise ValueError(f"greedy_generate on a mesh of {dev.type} "
                             f"devices was asked for {device}")
        params = tp.serving_layout(params, cfg, rt)
    prompt = torch.as_tensor(np.asarray(prompt) if not isinstance(
        prompt, torch.Tensor) else prompt).to(dev)
    if embeds is not None:
        embeds = torch.as_tensor(embeds).to(dev)
    prefill, decode = build_prefill_step(cfg, rt), build_decode_step(cfg, rt)
    last, caches, pos = prefill(params, prompt, embeds)
    toks = [torch.argmax(last, -1)]
    for _ in range(max_new - 1):
        logits, caches, pos = decode(params, toks[-1][:, None], caches, pos)
        toks.append(torch.argmax(logits, -1))
    return torch.stack(toks, dim=1).to(torch.int32)
