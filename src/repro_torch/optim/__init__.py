"""The training substrate's optimizer (port of ``repro.optim``): AdamW with
LR schedules and global-norm clipping, and int8 gradient compression with
error feedback."""
from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import AdamWConfig, OptState

__all__ = ["adamw", "compression", "AdamWConfig", "OptState"]
