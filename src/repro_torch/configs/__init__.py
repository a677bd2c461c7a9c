"""Architecture registry: the 10 assigned configs + the paper's own SimGNN —
a copy of `repro.configs` (the configs are data; each file here is the JAX
package's, importing the port's `ModelConfig`).

`get_config(name)` accepts the dashed public ids (e.g. "gemma2-9b").
`SHAPES` defines the four assigned input-shape cells; `cells()` enumerates the
runnable (arch x shape) grid with the skip rules from DESIGN.md §5.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "granite-moe-3b-a800m",
    "phi3.5-moe-42b-a6.6b",
    "gemma2-9b",
    "phi3-mini-3.8b",
    "h2o-danube-3-4b",
    "qwen1.5-4b",
    "seamless-m4t-large-v2",
    "rwkv6-7b",
    "jamba-1.5-large-398b",
    "internvl2-2b",
]

_MODULES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a66b",
    "gemma2-9b": "gemma2_9b",
    "phi3-mini-3.8b": "phi3_mini_38b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "qwen1.5-4b": "qwen15_4b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "rwkv6-7b": "rwkv6_7b",
    "jamba-1.5-large-398b": "jamba_15_large_398b",
    "internvl2-2b": "internvl2_2b",
}

SHAPES = {
    "train_4k":    dict(kind="train",   seq_len=4_096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32_768,  global_batch=32),
    "decode_32k":  dict(kind="decode",  seq_len=32_768,  global_batch=128),
    "long_500k":   dict(kind="decode",  seq_len=524_288, global_batch=1),
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def reduced_config(name: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
    cfg = get_config(name)
    kw = dict(
        n_layers=cfg.group_size * min(2, cfg.n_groups),
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=256, param_dtype="float32", dtype="float32",
        sliding_window=8 if cfg.sliding_window else None,
        rwkv_head_dim=16, mamba_dt_rank=8, mamba_d_state=4,
    )
    if cfg.n_kv_heads == cfg.n_heads:
        kw["n_kv_heads"] = 4                     # keep MHA archs MHA
    if cfg.moe_period:
        kw.update(n_experts=4, top_k=min(2, cfg.top_k), d_ff_expert=32)
    if cfg.is_enc_dec:
        kw.update(n_enc_layers=2)
    if cfg.frontend == "vision":
        kw.update(frontend_len=4)
    return cfg.with_(**kw)


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per the DESIGN.md §5 skip rules."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode cache/compute is quadratic-class; skipped per spec (DESIGN.md §5)"
    return True, ""


def cells():
    """All (arch, shape, runnable, note) cells — the 40-cell grid."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, note = shape_applicable(cfg, shape)
            out.append((arch, shape, ok, note))
    return out
