from .optimizers import (Optimizer, adamw, adafactor, make_optimizer,
                         clip_by_global_norm, global_norm)
from .schedules import wsd, cosine, constant

__all__ = ["Optimizer", "adamw", "adafactor", "make_optimizer",
           "clip_by_global_norm", "global_norm", "wsd", "cosine", "constant"]
