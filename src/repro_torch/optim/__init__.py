"""optim of the PyTorch port (mirrors repro.optim)."""

from repro_torch.optim.adamw import (OptimizerConfig, OptState,
                                     abstract_opt_state, adamw_update,
                                     clip_by_global_norm,
                                     global_norm, init_opt_state,
                                     learning_rate, opt_state_axes)

__all__ = ["OptimizerConfig", "OptState", "abstract_opt_state",
           "adamw_update", "init_opt_state",
           "learning_rate", "global_norm", "clip_by_global_norm",
           "opt_state_axes"]
