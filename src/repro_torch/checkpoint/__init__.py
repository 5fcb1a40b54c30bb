"""repro_torch.checkpoint"""
from repro_torch.checkpoint.checkpoint import (all_steps, latest_step, prune,
                                               restore, save, wait_pending)

__all__ = ["save", "restore", "latest_step", "all_steps", "wait_pending",
           "prune"]
