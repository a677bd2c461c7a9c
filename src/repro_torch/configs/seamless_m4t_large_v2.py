"""SeamlessM4T-large-v2 backbone: 24L encoder + 24L decoder, d=1024.
[arXiv:2308.11596] Audio frontend is a stub: input_specs() provides
precomputed fbank-frame embeddings (assignment spec)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206,
    is_enc_dec=True, n_enc_layers=24, frontend="audio", dec_seq_divisor=8,
    rope_theta=10_000.0, tie_embeddings=True,
)
