"""Launch helpers: ``steps`` binds (arch, shape) cells to the port's step
functions; ``train`` is the training driver (``python -m
repro_torch.launch.train``); ``mesh`` names meshes of ranks over
``torch.distributed`` and spawns them."""
