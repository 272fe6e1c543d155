"""Stand-ins for every step signature: tensors on the meta device, with
the shapes and dtypes of the real inputs and nothing allocated (port of
``repro.launch.specs``, whose ``jax.ShapeDtypeStruct`` leaves these
replace).  A dry run reads its shapes from these.  Audio and VLM
frontends are stubs: the specs are the precomputed frame and patch
embeddings.
"""

from __future__ import annotations

import torch

from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.berrut import CodingConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import abstract_params, init_caches
from repro_torch.optim import abstract_opt_state

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.modality == "audio":
        return {"frames": _spec((b, s, cfg.frontend_dim), torch.float32),
                "targets": _spec((b, s), torch.int32)}
    return prefill_input_specs(cfg, shape)


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Real-query inputs for coded_prefill (batch = G*K real queries)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.modality == "audio":
        return {"frames": _spec((b, s, cfg.frontend_dim), torch.float32)}
    if cfg.modality == "vlm":
        return {"patches": _spec((b, cfg.num_patches, cfg.frontend_dim),
                                 torch.float32),
                "tokens": _spec((b, s - cfg.num_patches), torch.int32)}
    return {"tokens": _spec((b, s), torch.int32)}


def coded_stream_count(shape: ShapeConfig, coding: CodingConfig) -> int:
    return (shape.global_batch // coding.k) * coding.num_workers


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig,
                       coding: CodingConfig):
    """(state_spec, tokens_spec) for coded_decode_step.

    The caches belong to the coded streams (G*(N+1), padded to the
    active mesh) and span the shape's context length, ring-bounded by
    the SWA window where the config has one.  ``pos`` is the reference's
    int32 scalar, where the port's state carries a Python int.
    """
    from repro_torch.serving.coded_serving import (CodedServingState,
                                                   num_padded_streams)
    cb = num_padded_streams(coding, shape.global_batch // coding.k)
    caches = init_caches(cfg, cb, shape.seq_len, getattr(torch,
                                                         cfg.param_dtype),
                         META)
    state = CodedServingState(caches=caches, pos=_spec((), torch.int32))
    return state, _spec((shape.global_batch, 1), torch.int32)


def model_state_specs(cfg: ModelConfig):
    """(params_spec, opt_state_spec) for the training step."""
    params = abstract_params(cfg)
    return params, abstract_opt_state(params)
