"""A sweep's bucketed merge: wrapper of ``csrc/bucket_merge.cu`` (two
kernels, ``bucket_scatter`` then ``bucket_row_merge``) and its plain
version :func:`bucket_merge_ref`.

``bucket_scatter`` fills an (n, B) uint64 bucket table with the sentinel
and scatters each real candidate edge (w -> v) of the prune's redirects into
w's row with one packed 64-bit ``atomicMin``; ``bucket_row_merge`` merges
each row's kept entries with its buckets. The two give the plain version's
graph bit for bit, and the number of real candidates from the scatter's own
count. The table lives for the call (2 GB at n = 1M, B = 256).

One input separates the plain version on the card from the same on the
CPU: ``torch.sort`` on CUDA orders a NaN distance whose sign bit is set
before -inf (the CPU's sort puts every NaN last), which shifts the row's
live entries. The kernels give the CPU's rows there; a NaN is never live.
"""
from __future__ import annotations

import torch

from repro_torch.core import graph as G
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels import spec as K
from repro_torch.kernels.bucket_merge.ref import bucket_merge_ref

MAX_M = 256          # row width csrc/bucket_merge.cu takes
MAX_B = 2048         # buckets a row: 4 warps of B + 2B words fit a block's shared memory
MAX_N = 2**30        # a sort word keeps the id in 30 bits


def _pow2(b: int) -> bool:
    return b >= 1 and b & (b - 1) == 0


def kernel_takes(n: int, m: int, n_buckets: int, cap: int) -> bool:
    """Whether the kernels take this merge's shape."""
    return 1 <= n < MAX_N and 1 <= cap <= m <= MAX_M and _pow2(n_buckets) \
        and n_buckets <= MAX_B


def _check(ids, dists, keep, red_w, red_d, n_buckets, cap):
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be (n, m) int32, got {tuple(ids.shape)} {ids.dtype}")
    for name, t, dtype in (("dists", dists, torch.float32), ("keep", keep, torch.bool),
                           ("red_w", red_w, torch.int32), ("red_d", red_d, torch.float32)):
        if t.shape != ids.shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} with the shape of ids, got "
                             f"{tuple(t.shape)} {t.dtype}")
    devs = {t.device for t in (ids, dists, keep, red_w, red_d)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must share one device, got {devs}")
    if not _pow2(n_buckets):
        raise ValueError(f"n_buckets={n_buckets} must be a power of two")
    if not 1 <= cap <= ids.shape[1]:
        raise ValueError(f"cap={cap} outside 1..m={ids.shape[1]}")


def bucket_merge(ids: torch.Tensor, dists: torch.Tensor, keep: torch.Tensor,
                 red_w: torch.Tensor, red_d: torch.Tensor, n_buckets: int,
                 cap: int | None = None):
    """Paper Algorithm 4's merge of one sweep's prune output. ``ids``/
    ``dists`` (n, m) are the rows that went into the prune, ``keep`` (bool)
    its survivors, ``red_w``/``red_d`` the replacement w (and its distance
    to v = ids[u, j]) of each dropped slot, -1 where none. Returns (Graph,
    cands_scattered): each row's ``cap`` (default m) nearest entries of its
    survivors (OLD) and its real candidates (NEW) in ``n_buckets`` hashed
    buckets, and the number of real candidates (a 0-d int64 tensor). CPU
    tensors run :func:`bucket_merge_ref`; CUDA tensors the kernels, which
    take ids in [-1, n) with each id at most once a row, and raise outside
    their limits (:func:`kernel_takes`)."""
    cap = ids.shape[1] if cap is None else cap
    _check(ids, dists, keep, red_w, red_d, n_buckets, cap)
    if ids.device.type == "cpu":
        return bucket_merge_ref(ids, dists, keep, red_w, red_d, n_buckets, cap)
    return _launch(ids, dists, keep, red_w, red_d, n_buckets, cap)


def _launch(ids, dists, keep, red_w, red_d, b, cap):
    n, m = ids.shape
    dev = ids.device
    out = G.Graph(torch.empty((n, m), dtype=torch.int32, device=dev),
                  torch.empty((n, m), dtype=torch.float32, device=dev),
                  torch.empty((n, m), dtype=torch.uint8, device=dev))
    if n == 0:
        return out, torch.zeros((), dtype=torch.int64, device=dev)
    if not kernel_takes(n, m, b, cap):
        raise ValueError(f"n={n}, m={m}, n_buckets={b} outside the kernels' limits "
                         f"(n < 2^30, m <= {MAX_M}, n_buckets <= {MAX_B})")
    ids, dists, keep, red_w, red_d = (t.contiguous() for t in (ids, dists, keep, red_w, red_d))
    table = torch.empty((n, b), dtype=torch.int64, device=dev)   # uint64 words
    counter = torch.empty(1, dtype=torch.int64, device=dev)      # both filled by the launch
    stream = _build.stream_handle(dev)
    rc = _build.load("bucket_scatter", "pppiiippp", source="bucket_merge")(
        ids.data_ptr(), red_w.data_ptr(), red_d.data_ptr(), n, m, b, table.data_ptr(),
        counter.data_ptr(), stream)
    _build.check(rc, "bucket_scatter")
    LAUNCHES["bucket_scatter"] += 1
    rc = _build.load("bucket_row_merge", "ppppiiiipppp", source="bucket_merge")(
        ids.data_ptr(), dists.data_ptr(), keep.data_ptr(), table.data_ptr(), n, m, b, cap,
        out.neighbors.data_ptr(), out.dists.data_ptr(), out.flags.data_ptr(), stream)
    _build.check(rc, "bucket_row_merge")
    LAUNCHES["bucket_row_merge"] += 1
    return out, counter[0]


# ------------------------------------------------------------ launch shapes
# csrc/bucket_merge.cu: the scatter's blocks of 256 threads take 16 slots a
# thread; the merge's blocks of 4 warps take a row a warp, each warp's shared
# region holding the row's B bucket words and a sort buffer of the next
# power of two >= m + B words (at least 32).
_SCATTER_THREADS, _SCATTER_ITEMS, _MERGE_WARPS = 256, 16, 4


def _sort_words(m: int, b: int) -> int:
    p = 32
    while p < m + b:
        p *= 2
    return p


def kernel_spec(entry: str, n: int, m: int, n_buckets: int = 256,
                label: str = "") -> K.LaunchSpec:
    """The launch of ``entry`` ("bucket_scatter" or "bucket_row_merge") that
    :func:`bucket_merge` makes for n rows of m slots and ``n_buckets``
    buckets a row."""
    if not kernel_takes(n, m, n_buckets, m):
        raise ValueError(f"n={n}, m={m}, n_buckets={n_buckets} outside the kernels' limits")
    if entry == "bucket_scatter":
        return K.LaunchSpec(
            name=f"bucket_scatter@{label or f'{n}x{m}'}", entry=entry, source="bucket_merge",
            instance=0, instance_name=f"bucket_scatter_kernel<{_SCATTER_ITEMS}>",
            problem=(n, m), grid=(K.cdiv(n * m, _SCATTER_THREADS * _SCATTER_ITEMS), 1, 1),
            threads=_SCATTER_THREADS, static_smem=16)
    if entry != "bucket_row_merge":
        raise ValueError(f"unknown entry {entry!r}")
    smem = _MERGE_WARPS * (n_buckets + _sort_words(m, n_buckets)) * 8
    return K.LaunchSpec(
        name=f"bucket_row_merge@{label or f'{n}x{m},B={n_buckets}'}", entry=entry,
        source="bucket_merge", instance=1,
        instance_name=f"bucket_row_merge_kernel<{_MERGE_WARPS}>", problem=(n, m, n_buckets),
        grid=(K.cdiv(n, _MERGE_WARPS), 1, 1), threads=32 * _MERGE_WARPS, dyn_smem=smem,
        opt_in=smem > K.SMEM_NO_OPT_IN)


def default_specs() -> list[K.LaunchSpec]:
    """A 1M build's sweeps (m = 128, B = 256), rows of 256 at their default
    B = 512, the largest row and buckets (m = 256, B = 2048, opting in to
    192 KiB), one row, and the n = 2^30 - 1 edge."""
    edge = MAX_N - 1
    return [kernel_spec("bucket_scatter", 1_000_000, 128, label="1M x 128"),
            kernel_spec("bucket_scatter", 1, 1, label="one slot"),
            kernel_spec("bucket_scatter", edge, MAX_M, label="n = 2^30 - 1 edge"),
            kernel_spec("bucket_row_merge", 1_000_000, 128, 256, "1M x 128, B=256"),
            kernel_spec("bucket_row_merge", 1_000_000, 256, 512, "1M x 256, B=512"),
            kernel_spec("bucket_row_merge", 1_000_000, MAX_M, MAX_B, "m=256, B=2048 edge"),
            kernel_spec("bucket_row_merge", 1, 1, 1, "one row"),
            kernel_spec("bucket_row_merge", edge, 128, 256, "n = 2^30 - 1 edge")]
