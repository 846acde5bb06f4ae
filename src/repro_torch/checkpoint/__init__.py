"""Checkpoints of the port's training state (counterpart of
``repro.checkpoint``)."""
from .store import (AsyncCheckpointer, latest_step, load_checkpoint,
                    save_checkpoint)

__all__ = ["AsyncCheckpointer", "latest_step", "load_checkpoint",
           "save_checkpoint"]
