"""AI21 Jamba-1.5-large 398B: Mamba+attention 7:1 interleave, 16-expert top-2
MoE every other layer. [arXiv:2403.19887]
Training note: optimizer moments are kept in bf16 (opt_state_dtype) so the
fully-sharded state fits 16 GB/chip on a single v5e-256 pod (DESIGN.md §6)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    layer_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    moe_period=2, n_experts=16, top_k=2, d_ff_expert=24576,
    mamba_d_state=16, mamba_expand=2, mamba_d_conv=4,
    rope_theta=None, tie_embeddings=False, subquadratic=True,
    opt_state_dtype="bfloat16",
)
