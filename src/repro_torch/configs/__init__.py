"""Architecture registry of the port: ``get(arch_id)`` for the four recsys
architectures and the paper's own ``rnnd-ann``; the reference's LM and GNN
ids are not ported yet."""
from repro_torch.configs import deepfm, fm, rnnd_ann, wide_deep, xdeepfm
from repro_torch.configs.base import Arch, ShapeSpec

REGISTRY: dict[str, Arch] = {m.ARCH.arch_id: m.ARCH
                             for m in (wide_deep, deepfm, fm, xdeepfm, rnnd_ann)}
# ids of the reference's registry that later slices port
NOT_PORTED = ("dbrx-132b", "deepseek-moe-16b", "yi-34b", "granite-20b", "minitron-4b",
              "dimenet")

# the assigned architectures the port has (rnnd-ann is the paper's own,
# supplementary, as in the reference)
ASSIGNED = [a for a in REGISTRY if a != "rnnd-ann"]


def get(arch_id: str) -> Arch:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(f"arch {arch_id!r} is not ported yet; the port has "
                                  f"{sorted(REGISTRY)}")
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def all_cells(include_ann: bool = False) -> list[tuple[str, str]]:
    """Every (arch_id, shape_name) pair of the port's architectures."""
    out = []
    for aid in (list(REGISTRY) if include_ann else ASSIGNED):
        for s in REGISTRY[aid].shapes:
            out.append((aid, s.name))
    return out


__all__ = ["Arch", "ShapeSpec", "REGISTRY", "ASSIGNED", "get", "all_cells"]
