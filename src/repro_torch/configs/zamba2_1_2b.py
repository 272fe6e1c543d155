"""zamba2-1.2b — hybrid: Mamba2 backbone + one SHARED attention block.

[arXiv:2411.15242] 38L, d_model=2048, shared attn block with 32 heads
(kv=32, MHA) and d_ff=8192, vocab=32000, ssm_state=64.  The shared block's
weights are reused at every 6th position (zamba2's parameter-sharing trick;
we share the full block incl. norms — the per-invocation LoRA deltas of the
released model are omitted, documented in DESIGN.md).
"""

from repro_torch.models.config import ModelConfig

# 38 layers: a shared attention block every 6th position.
_PATTERN = ("SSSSSG" * 7)[:38]

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    layer_pattern=_PATTERN,
    source="arXiv:2411.15242",
)


def reduced() -> ModelConfig:
    return CONFIG.with_updates(
        name="zamba2-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=4, head_dim=0, d_ff=512, vocab_size=512,
        ssm_state=16, ssm_head_dim=32, layer_pattern="SG")
