"""phi4-mini-3.8b — dense RoPE + SwiGLU + GQA.

[arXiv:2412.08905] 32L, d_model=3072, 24 heads (GQA kv=8, head_dim=128),
d_ff=8192, vocab=200064.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    rope_theta=10_000.0,
    source="arXiv:2412.08905",
)


def reduced() -> ModelConfig:
    return CONFIG.with_updates(
        name="phi4-mini-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        layer_pattern=None)
