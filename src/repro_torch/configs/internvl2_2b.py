"""InternVL2-2B: InternViT frontend (stub) + InternLM2-1.8B backbone.
[arXiv:2404.16821; hf-verified family] input_specs() provides 256 precomputed
patch embeddings per image (pixel-shuffled InternViT output)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92553,
    frontend="vision", frontend_len=256,
    rope_theta=10_000.0, tie_embeddings=True,
)
