"""repro_torch.optim: AdamW on the port's nested dicts of tensors."""
from repro_torch.optim.adamw import (OptState, adamw_init, adamw_update,
                                     global_norm, lr_schedule)

__all__ = ["OptState", "adamw_init", "adamw_update", "lr_schedule",
           "global_norm"]
