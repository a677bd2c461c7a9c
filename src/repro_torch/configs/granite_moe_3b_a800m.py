"""IBM Granite-3.0 3B-A800M: 40-expert top-8 fine-grained MoE.
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf-verified family]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    moe_period=1, n_experts=40, top_k=8, d_ff_expert=512,
    rope_theta=10_000.0, tie_embeddings=True,
)
