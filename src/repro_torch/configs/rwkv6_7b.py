"""RWKV-6 (Finch) 7B: attention-free, data-dependent per-channel decay.
[arXiv:2404.05892; hf-verified family] O(1) decode state -> long_500k runs."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=14336, vocab_size=65536,
    layer_pattern=("rwkv",), rwkv_head_dim=64,
    rope_theta=None, tie_embeddings=False, subquadratic=True,
)
