"""data of the PyTorch port (mirrors repro.data)."""

from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import (SyntheticClassification,
                                        SyntheticLMDataset, synthetic_batch)

__all__ = ["SyntheticLMDataset", "SyntheticClassification",
           "synthetic_batch", "ShardedLoader"]
