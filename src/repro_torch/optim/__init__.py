"""Optimizers as plain functions over parameter trees (no torch.optim),
the LR schedules, and error-feedback gradient compression
(`optim.compression`)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_schedule", "global_norm",
           "linear_warmup"]
