"""h2o-danube-1.8b — dense llama+mistral mix with sliding-window attention.

[arXiv:2401.16818] 24L, d_model=2560, 32 heads (GQA kv=8), d_ff=6912,
vocab=32000; Mistral-style SWA (window 4096).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    arch_type="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10_000.0,
    source="arXiv:2401.16818",
)


def reduced() -> ModelConfig:
    """2-layer smoke variant of the same family (SWA + GQA)."""
    return CONFIG.with_updates(
        name="h2o-danube-reduced", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, head_dim=0, d_ff=512, vocab_size=512,
        sliding_window=64, layer_pattern=None)
