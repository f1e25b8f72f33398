"""Architecture registry of the port: ``get(arch_id)`` for the five LM
architectures, DimeNet, the four recsys ones and the paper's own
``rnnd-ann``, in the reference's order."""
from repro_torch.configs import (
    dbrx_132b, deepfm, deepseek_moe_16b, dimenet, fm, granite_20b, minitron_4b, rnnd_ann,
    wide_deep, xdeepfm, yi_34b,
)
from repro_torch.configs.base import Arch, ShapeSpec

REGISTRY: dict[str, Arch] = {m.ARCH.arch_id: m.ARCH for m in (
    dbrx_132b, deepseek_moe_16b, yi_34b, granite_20b, minitron_4b,
    dimenet, wide_deep, deepfm, fm, xdeepfm, rnnd_ann)}
# ids of the reference's registry that a later slice ports
NOT_PORTED = ()

# the 10 assigned architectures (rnnd-ann is the paper's own, supplementary,
# as in the reference)
ASSIGNED = [a for a in REGISTRY if a != "rnnd-ann"]


def get(arch_id: str) -> Arch:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def all_cells(include_ann: bool = False) -> list[tuple[str, str]]:
    """Every (arch_id, shape_name) pair: the dry run's grid (40 cells, 43
    with the paper's own)."""
    out = []
    for aid in (list(REGISTRY) if include_ann else ASSIGNED):
        for s in REGISTRY[aid].shapes:
            out.append((aid, s.name))
    return out


__all__ = ["Arch", "ShapeSpec", "REGISTRY", "ASSIGNED", "NOT_PORTED", "get", "all_cells"]
