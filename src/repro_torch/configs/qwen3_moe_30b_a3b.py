"""qwen3-moe-30b-a3b — 128-expert top-8 MoE.

[hf:Qwen/Qwen3-30B-A3B] 48L, d_model=2048, 32 heads (GQA kv=4,
head_dim=128), per-expert d_ff=768, vocab=151936, 128 experts top-8 with
renormalised top-k router probs; qk_norm per the qwen3 family.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                    # kept for reference; experts use moe_d_ff
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    router_norm_topk=True,
    source="hf:Qwen/Qwen3-30B-A3B",
)


def reduced() -> ModelConfig:
    return CONFIG.with_updates(
        name="qwen3-moe-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=128, vocab_size=512,
        num_experts=4, experts_per_token=2, moe_d_ff=128,
        moe_group_size=64, capacity_factor=4.0,
        layer_pattern=None)
