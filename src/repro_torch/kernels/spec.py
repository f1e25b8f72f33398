"""Launch shapes of the hand kernels, as functions of the problem (the port's
counterpart of ``repro.kernels.spec``).

Each kernel package's ``ops.py`` exports ``kernel_spec(...)``, the launch its
wrapper makes for one problem — grid, threads a block, dynamic shared
bytes, whether the launcher opts in above 48 KiB, the template instance it
picks — and ``default_specs()``, the registered problems (the main path's
shapes and their edges) covering every instance. The CUDA side has one
source of truth: each ``csrc/*.cu`` launcher gets its shape from a function
that its ``<entry>_launch_shape`` export also calls, and
``repro_torch.analysis.kernel_check`` holds every Python spec to that
export on the card. On the CPU the checker evaluates the specs alone:
shared memory against the sm_90a budget and the opt-in, threads a block,
grid bounds.

The Python side mirrors the launchers' arithmetic; a persistent grid
(``rng_prune``'s) is sized by the card's SM count and the blocks an SM the
spec claims (``blocks_per_sm``), which the card check compares with the
occupancy the runtime reports.
"""
from __future__ import annotations

import dataclasses

SMEM_BLOCK_MAX = 232_448      # sm_90: shared bytes a block may use (opted in)
SMEM_NO_OPT_IN = 49_152       # dynamic shared bytes a block gets without opting in
REGS_PER_SM = 65_536
MAX_THREADS = 1_024
GRID_X_MAX = 2**31 - 1
GRID_YZ_MAX = 65_535
H100_SMS = 132                # SMs of the H100 SXM the specs are written for


@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """One launch of one template instance.

    ``problem`` is the argument tuple of the source's
    ``<entry>_launch_shape`` export (without the output pointer);
    ``instance`` the index its ``<source>_func_attrs`` query takes;
    ``static_smem`` the instance's ``__shared__`` bytes, which the card
    reads back as ``sharedSizeBytes``; ``blocks_per_sm`` the residency the
    launch shape relies on (``__launch_bounds__``' minimum, or the
    persistent grid's sizing)."""

    name: str
    entry: str
    source: str
    instance: int
    instance_name: str
    problem: tuple[int, ...]
    grid: tuple[int, int, int]
    threads: int
    dyn_smem: int = 0
    opt_in: bool = False
    static_smem: int = 0
    blocks_per_sm: int = 1
    persistent: bool = False

    def export(self) -> tuple[int, ...]:
        """What ``<entry>_launch_shape`` must write (launch_shape.cuh's
        out[8]); out[7] is the residency a persistent grid was sized by, 0
        for a grid that covers the problem."""
        return (*self.grid, self.threads, self.dyn_smem, int(self.opt_in), self.instance,
                self.blocks_per_sm if self.persistent else 0)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
