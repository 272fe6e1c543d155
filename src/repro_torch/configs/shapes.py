"""Assigned input shapes and the coded-serving shape arithmetic (copy of
``repro.configs.shapes`` on the port's ``CodingConfig``)."""

from __future__ import annotations

import dataclasses

from repro_torch.core.berrut import CodingConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def serving_coding(shape: ShapeConfig, k: int = 8, s: int = 1,
                   e: int = 0) -> CodingConfig:
    """Coding config for a serving shape.

    K is capped by the batch (long_500k: batch=1 -> K=1, which degenerates
    to (S+1)-replication exactly as the paper's baseline — DESIGN.md §4).
    """
    k = min(k, shape.global_batch)
    return CodingConfig(k=k, s=s, e=e)


def coded_batch(shape: ShapeConfig, coding: CodingConfig) -> int:
    """Workers (coded streams) in flight for a serving shape."""
    groups = shape.global_batch // coding.k
    return groups * coding.num_workers
