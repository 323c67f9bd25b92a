"""Atomic, asynchronous checkpoints of logical arrays."""
from repro_torch.checkpoint.ckpt import (CheckpointManager,  # noqa: F401
                                         host_tree, latest_step,
                                         load_checkpoint, place_like,
                                         save_checkpoint)

__all__ = ["CheckpointManager", "host_tree", "latest_step",
           "load_checkpoint", "place_like", "save_checkpoint"]
