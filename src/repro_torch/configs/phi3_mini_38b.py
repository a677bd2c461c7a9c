"""Microsoft Phi-3-mini 3.8B: MHA (kv=32), RoPE, SwiGLU.
[arXiv:2404.14219]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
    rope_theta=10_000.0, tie_embeddings=False,
)
