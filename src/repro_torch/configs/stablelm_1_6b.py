"""stablelm-1.6b — dense MHA with partial rotary and LayerNorm.

[hf:stabilityai/stablelm-2-1_6b] 24L, d_model=2048, 32 heads (kv=32, MHA),
d_ff=5632, vocab=100352; rotary_pct=0.25, LayerNorm.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    rotary_pct=0.25,
    norm_type="layernorm",
    source="hf:stabilityai/stablelm-2-1_6b",
)


def reduced() -> ModelConfig:
    return CONFIG.with_updates(
        name="stablelm-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=4, head_dim=0, d_ff=512, vocab_size=512,
        layer_pattern=None)
