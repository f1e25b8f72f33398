"""Launch helpers: ``steps`` binds (arch, shape) cells to the port's step
functions; ``mesh`` names meshes of ranks over ``torch.distributed`` and
spawns them."""
