"""Architecture registry of the port: the configurations ported so far."""

from __future__ import annotations

from repro_torch.configs import mamba2_780m, qwen3_0_6b
from repro_torch.models.config import ModelConfig

_MODULES = {"qwen3-0.6b": qwen3_0_6b, "mamba2-780m": mamba2_780m}


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
