"""grok-1-314b — 8-expert top-2 MoE at 314B parameters.

[hf:xai-org/grok-1] 64L, d_model=6144, 48 heads (GQA kv=8, head_dim=128),
per-expert d_ff=32768, vocab=131072, 8 experts top-2, attention logit
soft-capping (30.0).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    attn_logit_softcap=30.0,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=32768,
    router_norm_topk=False,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
    source="hf:xai-org/grok-1",
)


def reduced() -> ModelConfig:
    return CONFIG.with_updates(
        name="grok-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        num_experts=4, experts_per_token=2, moe_d_ff=512,
        moe_group_size=64, param_dtype="float32",
        activation_dtype="float32", capacity_factor=4.0,
        layer_pattern=None)
