from repro_torch.checkpoint.checkpoint import (
    committed_steps, latest_step, manifest_names, restore, save,
)

__all__ = ["committed_steps", "latest_step", "manifest_names", "restore",
           "save"]
