"""hubert-xlarge — encoder-only audio transformer (wav2vec2 family).

[arXiv:2106.07447] 48L, d_model=1280, 16 heads (MHA), d_ff=5120,
vocab=504 (masked-prediction cluster targets).  The conv feature extractor
is STUBBED per the assignment carve-out: inputs are precomputed frame
embeddings (frontend_dim=512) projected into the residual stream.
Bidirectional attention, GELU MLP, LayerNorm.  RoPE stands in for HuBERT's
convolutional relative positional encoding (documented simplification).
Encoder-only => no decode shapes (DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    modality="audio",
    frontend_dim=512,
    norm_type="layernorm",
    mlp_activation="gelu",
    source="arXiv:2106.07447",
)


def reduced() -> ModelConfig:
    return CONFIG.with_updates(
        name="hubert-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=4, head_dim=0, d_ff=512, vocab_size=64,
        frontend_dim=32, layer_pattern=None)
