"""mamba2-780m — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060] 48L, d_model=1536, ssm_state=128, head_dim=64,
expand=2, vocab=50280.  No attention layers; decode is an O(1) recurrent
state update.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)


def reduced() -> ModelConfig:
    return CONFIG.with_updates(
        name="mamba2-reduced", num_layers=2, d_model=256, vocab_size=512,
        ssm_state=16, ssm_head_dim=32, layer_pattern=None)
