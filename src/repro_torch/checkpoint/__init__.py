"""checkpoint of the PyTorch port (mirrors repro.checkpoint)."""

from repro_torch.checkpoint.ckpt import (latest_step, load, load_metadata,
                                         save, step_path)

__all__ = ["save", "load", "load_metadata", "latest_step", "step_path"]
