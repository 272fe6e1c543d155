"""paligemma-3b — VLM: SigLIP vision prefix + gemma decoder.

[arXiv:2407.07726] decoder: 18L, d_model=2048, 8 heads (MQA kv=1,
head_dim=256), d_ff=16384, vocab=257216; prefix-LM masking over the image
tokens; GeGLU; tied embeddings.  The SigLIP encoder + projector input is
STUBBED per the carve-out: inputs are 256 patch embeddings (dim 1152)
projected into the stream.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    arch_type="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    modality="vlm",
    frontend_dim=1152,
    num_patches=256,
    prefix_lm=True,
    mlp_activation="geglu",
    tie_embeddings=True,
    source="arXiv:2407.07726",
)


def reduced() -> ModelConfig:
    return CONFIG.with_updates(
        name="paligemma-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=1, head_dim=64, d_ff=512, vocab_size=512,
        frontend_dim=64, num_patches=16, layer_pattern=None)
