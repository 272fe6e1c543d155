"""Synthetic data sources (a copy of ``repro.data.synthetic``, numpy only,
so that both packages draw the same batches from a seed; the port may not
import the reference, whose ``repro.data`` package imports JAX).

Two families:
  * SyntheticLMDataset — Zipf-distributed token streams with a planted
    bigram structure, so a trained LM has signal to learn (loss decreases
    measurably within a few hundred steps — used by examples/train_100m).
  * SyntheticClassification — Gaussian-mixture image-like classification
    whose Bayes accuracy is high; stands in for MNIST/CIFAR in the paper's
    accuracy experiments (EXPERIMENTS.md documents this substitution).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        v = self.vocab_size
        # planted deterministic-ish bigram table over the head of the vocab
        self._next = rng.randint(0, v, size=(v,))
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** -self.zipf_a
        self._probs = probs / probs.sum()

    def batch(self, batch_size: int, rng: np.random.RandomState
              ) -> dict:
        """Returns {"tokens": (B, S) int32} with 70% bigram continuation."""
        b, s, v = batch_size, self.seq_len, self.vocab_size
        out = np.empty((b, s), np.int32)
        out[:, 0] = rng.choice(v, size=b, p=self._probs)
        follow = rng.rand(b, s) < 0.7
        fresh = rng.choice(v, size=(b, s), p=self._probs)
        for t in range(1, s):
            out[:, t] = np.where(follow[:, t], self._next[out[:, t - 1]],
                                 fresh[:, t])
        return {"tokens": out}

    def stream(self, batch_size: int, seed: int = 1) -> Iterator[dict]:
        rng = np.random.RandomState(seed)
        while True:
            yield self.batch(batch_size, rng)


@dataclasses.dataclass
class SyntheticClassification:
    """Gaussian clusters in input space; one cluster center per class with
    within-class scatter — a high-Bayes-accuracy stand-in for MNIST."""

    num_classes: int = 10
    dim: int = 64
    scatter: float = 0.45
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.centers = rng.randn(self.num_classes, self.dim).astype(
            np.float32)

    def sample(self, n: int, rng: np.random.RandomState
               ) -> Tuple[np.ndarray, np.ndarray]:
        labels = rng.randint(0, self.num_classes, size=n)
        x = self.centers[labels] + self.scatter * rng.randn(
            n, self.dim).astype(np.float32)
        return x.astype(np.float32), labels.astype(np.int32)

    def train_test(self, n_train: int, n_test: int, seed: int = 1):
        rng = np.random.RandomState(seed)
        return self.sample(n_train, rng), self.sample(n_test, rng)


def synthetic_batch(cfg, shape_cfg, rng: np.random.RandomState) -> dict:
    """A training batch with the modality of ``cfg`` at ``shape_cfg`` size.

    Used by smoke benchmarks; the dry-run uses ShapeDtypeStructs instead.
    """
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    if cfg.modality == "audio":
        return {"frames": rng.randn(b, s, cfg.frontend_dim).astype(
                    np.float32),
                "targets": rng.randint(0, cfg.vocab_size, (b, s)).astype(
                    np.int32)}
    if cfg.modality == "vlm":
        text = s - cfg.num_patches
        return {"patches": rng.randn(b, cfg.num_patches,
                                     cfg.frontend_dim).astype(np.float32),
                "tokens": rng.randint(0, cfg.vocab_size, (b, text)).astype(
                    np.int32)}
    return {"tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
