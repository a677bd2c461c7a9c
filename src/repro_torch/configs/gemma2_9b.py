"""Gemma-2 9B: local(4096)+global alternating attention, logit softcaps,
sandwich norms. [arXiv:2408.00118; hf-verified]
Marked subquadratic-eligible for long_500k: half the layers are
sliding-window (ring cache); global layers decode against the full (sharded)
cache -- O(S) per token. See DESIGN.md §5."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    layer_pattern=("attn_local", "attn"), sliding_window=4096,
    attn_softcap=50.0, final_softcap=30.0, post_block_norm=True,
    rope_theta=10_000.0, tie_embeddings=True, subquadratic=True,
)
