"""Microsoft Phi-3.5-MoE: 16-expert top-2, 42B total / 6.6B active.
[hf:microsoft/Phi-3.5-MoE-instruct; hf-verified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064,
    moe_period=1, n_experts=16, top_k=2, d_ff_expert=6400,
    rope_theta=10_000.0, tie_embeddings=False,
)
