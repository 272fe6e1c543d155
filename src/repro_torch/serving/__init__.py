"""serving of the PyTorch port (mirrors repro.serving)."""
