"""AdamW with global-norm clipping and a cosine schedule (the counterpart
of ``repro.optim``)."""

from .adamw import (AdamWState, adamw_init, adamw_update, clip_by_global_norm,
                    cosine_schedule)

__all__ = ["AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_schedule"]
