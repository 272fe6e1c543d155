"""training of the PyTorch port (mirrors repro.training)."""

from repro_torch.training.train import (TrainConfig, loss_and_grads,
                                        make_train_step, train_step)

__all__ = ["TrainConfig", "train_step", "make_train_step", "loss_and_grads"]
