"""Architecture registry of the port: ``get(arch_id)`` for the four recsys
architectures; the reference's other ids are not ported yet."""
from repro_torch.configs import deepfm, fm, wide_deep, xdeepfm
from repro_torch.configs.base import Arch, ShapeSpec

REGISTRY: dict[str, Arch] = {m.ARCH.arch_id: m.ARCH for m in (wide_deep, deepfm, fm, xdeepfm)}
# ids of the reference's registry that later slices port
NOT_PORTED = ("dbrx-132b", "deepseek-moe-16b", "yi-34b", "granite-20b", "minitron-4b",
              "dimenet", "rnnd-ann")


def get(arch_id: str) -> Arch:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(f"arch {arch_id!r} is not ported yet; the port has "
                                  f"{sorted(REGISTRY)}")
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


__all__ = ["Arch", "ShapeSpec", "REGISTRY", "get"]
