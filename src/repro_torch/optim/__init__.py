"""repro_torch.optim — AdamW and SGD with the reference's updates, global
norm clipping, learning-rate schedules and int8 error-feedback gradient
compression, over nested dicts of tensors."""
from repro_torch.optim.compression import (ErrorFeedbackState,
                                           ef_compress_update, ef_init,
                                           int8_compress, int8_decompress)
from repro_torch.optim.optimizer import (AdamWState, Optimizer, SGDState,
                                         adamw, apply_updates,
                                         clip_by_global_norm, global_norm,
                                         sgd)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         linear_warmup, warmup_cosine)

__all__ = ["Optimizer", "AdamWState", "SGDState", "adamw", "sgd",
           "apply_updates", "global_norm", "clip_by_global_norm",
           "constant", "cosine_decay", "linear_warmup", "warmup_cosine",
           "int8_compress", "int8_decompress", "ErrorFeedbackState",
           "ef_init", "ef_compress_update"]
