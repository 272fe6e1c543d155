"""On-device token sampling (port of ``repro.serving.sampling``).

Greedy selection is argmax with ties to the lowest index, as the
reference's; the top k are selected in ``lax.top_k``'s order (value
descending, then index ascending: ``top_k_stable``), and the draw comes
from an explicit ``torch.Generator``, so it differs from the reference's
``jax.random`` one by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """top_k == 1 is greedy decoding (no randomness, generator unused);
    top_k > 1 samples from the temperature-scaled top-k logits."""

    top_k: int = 1
    temperature: float = 1.0

    def __post_init__(self):
        if self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.temperature <= 0.0:
            raise ValueError(
                f"temperature must be > 0, got {self.temperature}")


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries along the last
    dimension in ``jax.lax.top_k``'s order: value descending, and among
    equal values the lower index first.  ``torch.topk`` does not promise
    that order, and bf16 logits tie often."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sample_tokens(logits: torch.Tensor, config: SampleConfig,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """(..., V) logits -> (...,) int32 token ids, on the logits' device."""
    if config.top_k <= 1:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("top_k > 1 sampling needs a generator")
    vals, idx = top_k_stable(logits.to(torch.float32), config.top_k)
    probs = torch.softmax(vals / config.temperature, dim=-1)
    choice = torch.multinomial(probs.reshape(-1, config.top_k), 1,
                               generator=generator)
    choice = choice.reshape(*vals.shape[:-1], 1)
    return torch.gather(idx, -1, choice)[..., 0].to(torch.int32)
