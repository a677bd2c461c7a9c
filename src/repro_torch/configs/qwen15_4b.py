"""Qwen1.5 4B: MHA with QKV bias. [hf:Qwen/Qwen1.5-4B; hf-verified family]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=151936,
    qkv_bias=True, rope_theta=10_000.0, tie_embeddings=False,
)
