"""Model configuration for the LM substrate (all 10 assigned architectures) —
a copy of `repro.models.config` (pure Python; the port keeps its own).

One frozen dataclass describes every family: dense / MoE / SSM / hybrid /
enc-dec / VLM. The per-layer structure is a repeating `layer_pattern` of block
kinds ("attn", "attn_local", "mamba", "rwkv"); MoE replaces the dense FFN on
every `moe_period`-th layer. Layers are *stacked by repeating group*
(leaves [G, ...]); the JAX package applies them under `lax.scan`, the port
in a plain loop over groups.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    rope_theta: float | None = 10_000.0     # None -> no RoPE (Jamba attn)
    qkv_bias: bool = False
    attn_softcap: float | None = None       # Gemma-2 attention logit softcap
    final_softcap: float | None = None      # Gemma-2 final logit softcap
    sliding_window: int | None = None       # SWA window for "attn_local"
    post_block_norm: bool = False           # Gemma-2 sandwich norms
    # block structure
    layer_pattern: tuple = ("attn",)        # repeating unit of block kinds
    moe_period: int = 0                     # 0: never; k: every k-th layer
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_use_kernel: bool = False     # fused expert kernel (TPU runtime path)
    # mamba
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    mamba_dt_rank: int = 0                  # 0 -> ceil(d_model / 16)
    mamba_scan_unroll: int = 1              # steps fused per while iteration
    mamba_naive_disc: bool = False          # §Perf B-it0: materialize a_bar/bx
    # rwkv
    rwkv_head_dim: int = 64
    # enc-dec / frontends
    is_enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: str | None = None             # None | "audio" | "vision"
    frontend_len: int = 0                   # prepended embed positions (vlm)
    dec_seq_divisor: int = 1                # enc-dec: S_dec = S // divisor
    # numerics
    norm_eps: float = 1e-6
    kv_cache_dtype: str = "bfloat16"        # "int8": quantized KV cache
    no_seq_shard: bool = False              # disable Megatron-SP residual
    tie_embeddings: bool = True
    dtype: str = "bfloat16"                 # activations
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"        # bf16 for the 398B config
    # long-context applicability (which shapes run; see DESIGN.md §5)
    subquadratic: bool = False              # eligible for long_500k

    # ---- derived ----
    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to 512 (Megatron-style) so the vocab dim
        shards evenly over any mesh axis; logits at padded ids are masked."""
        return -(-self.vocab_size // 512) * 512

    @property
    def group_size(self) -> int:
        return _lcm(len(self.layer_pattern), self.moe_period or 1)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_size == 0, (self.name, self.n_layers,
                                                      self.group_size)
        return self.n_layers // self.group_size

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def layer_kinds(self) -> list[str]:
        """Block kind for each position inside one scan group."""
        return [self.layer_pattern[i % len(self.layer_pattern)]
                for i in range(self.group_size)]

    def layer_is_moe(self) -> list[bool]:
        if not self.moe_period:
            return [False] * self.group_size
        return [(i % self.moe_period) == self.moe_period - 1
                for i in range(self.group_size)]

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- analytic parameter / FLOP model (for roofline MODEL_FLOPS) ----
    def param_count(self) -> int:
        d, hd = self.d_model, self.head_dim
        n = 0
        per_kind = {}
        per_kind["attn"] = per_kind["attn_local"] = (
            d * (self.n_heads + 2 * self.n_kv_heads) * hd
            + self.n_heads * hd * d)
        din, st, rk = self.mamba_d_inner, self.mamba_d_state, self.dt_rank
        per_kind["mamba"] = (d * 2 * din + din * self.mamba_d_conv
                             + din * (rk + 2 * st) + rk * din + 2 * din
                             + din * d)
        hk = self.rwkv_head_dim
        per_kind["rwkv"] = (4 * d * d + d * d            # r,k,v,g,o
                            + 2 * (d * 32 + 32 * d)      # w/x loras (approx)
                            + 2 * self.n_rwkv_heads * hk  # w0, u
                            + d * self.d_ff + self.d_ff * d + d * d)  # chan mix
        dense_ffn = 3 * d * self.d_ff
        moe_ffn = self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
        kinds, moes = self.layer_kinds(), self.layer_is_moe()
        for k, m in zip(kinds, moes):
            n += per_kind[k]
            if k in ("attn", "attn_local") or k in ("mamba", "rwkv"):
                if k == "rwkv":
                    pass                                  # rwkv has its own ffn
                else:
                    n += moe_ffn if m else dense_ffn
        n *= self.n_groups
        if self.is_enc_dec:  # encoder layers: attn + ffn; decoder adds cross
            enc = per_kind["attn"] + dense_ffn
            n += self.n_enc_layers * enc + self.n_layers * per_kind["attn"]
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(n)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.moe_period:
            return self.param_count()
        full_moe = self.n_experts * 3 * self.d_model * self.d_ff_expert
        active_moe = self.top_k * 3 * self.d_model * self.d_ff_expert
        n_moe_layers = sum(self.layer_is_moe()) * self.n_groups
        return int(self.param_count() - n_moe_layers * (full_moe - active_moe))


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)
