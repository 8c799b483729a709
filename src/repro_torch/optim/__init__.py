"""repro_torch.optim — AdamW with the reference's update, over nested
dicts of tensors."""
from repro_torch.optim.optimizer import (AdamWState, Optimizer, adamw,
                                         apply_updates)

__all__ = ["Optimizer", "AdamWState", "adamw", "apply_updates"]
