"""repro_torch.ckpt — atomic, asynchronous checkpoints of tensor trees."""
from repro_torch.ckpt.checkpointer import (Checkpointer, checkpoint_extra,
                                           committed_steps, latest_step,
                                           restore_checkpoint,
                                           save_checkpoint)

__all__ = ["Checkpointer", "save_checkpoint", "restore_checkpoint",
           "latest_step", "committed_steps", "checkpoint_extra"]
