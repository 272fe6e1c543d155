"""qwen3-0.6b — dense GQA with per-head qk RMSNorm.

[hf:Qwen/Qwen3-8B family] 28L, d_model=1024, 16 heads (GQA kv=8,
head_dim=128), d_ff=3072, vocab=151936, qk_norm, tied embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    arch_type="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
)


def reduced() -> ModelConfig:
    return CONFIG.with_updates(
        name="qwen3-0.6b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        layer_pattern=None)
