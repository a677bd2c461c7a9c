"""H2O Danube-3 4B: llama+mistral mix with sliding-window attention.
[arXiv:2401.16818] SWA(4096) on all layers -> ring KV cache makes the
long_500k decode cell constant-memory per layer."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000,
    layer_pattern=("attn_local",), sliding_window=4096,
    rope_theta=10_000.0, tie_embeddings=True, subquadratic=True,
)
