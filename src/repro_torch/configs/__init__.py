"""Architecture registry of the port: the configurations ported so far."""

from __future__ import annotations

from repro_torch.configs import (grok_1_314b, h2o_danube_1_8b,
                                 hubert_xlarge, mamba2_780m, paligemma_3b,
                                 phi4_mini_3_8b, qwen3_0_6b,
                                 qwen3_moe_30b_a3b, stablelm_1_6b,
                                 zamba2_1_2b)
from repro_torch.models.config import ModelConfig

_MODULES = {"qwen3-0.6b": qwen3_0_6b, "mamba2-780m": mamba2_780m,
            "h2o-danube-1.8b": h2o_danube_1_8b,
            "phi4-mini-3.8b": phi4_mini_3_8b,
            "stablelm-1.6b": stablelm_1_6b,
            "zamba2-1.2b": zamba2_1_2b,
            "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
            "grok-1-314b": grok_1_314b,
            "paligemma-3b": paligemma_3b,
            "hubert-xlarge": hubert_xlarge}


def list_archs() -> list:
    return list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has {list_archs()}")
    return _MODULES[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()


# Which serving shapes each arch supports (DESIGN.md §4 skip policy).
def supported_shapes(name: str) -> list:
    cfg = get_config(name)
    shapes = ["train_4k", "prefill_32k"]
    if cfg.causal:                      # encoder-only has no decode step
        shapes += ["decode_32k", "long_500k"]
    return shapes


def shape_config_for(name: str, shape: str) -> ModelConfig:
    """Arch config specialised for a shape (SWA variant for long_500k)."""
    cfg = get_config(name)
    if shape == "long_500k" and cfg.arch_type not in ("ssm",):
        # sub-quadratic requirement: sliding-window variant (window 4096)
        cfg = cfg.sliding_variant(4096)
    return cfg
