"""Fused gather + candidate Gram + RNG prune: wrapper of
``csrc/rng_prune.cu`` and its plain version.

The kernel reads ``x`` by id itself, so one launch covers all rows: the
(rows, M, d) gathered block never exists (64 GiB at n = 1M, M = d = 128).
The plain version gathers ``cfg.chunk`` rows at a time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build, metric_code
from repro_torch.kernels.rng_prune.ref import rng_prune_ref

MAX_M = 128          # candidate tile of the kernel (csrc/rng_prune.cu)


def _check(x, ids, dists, flags):
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be (n, d) float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be (R, M) int32, got {tuple(ids.shape)} {ids.dtype}")
    if dists.shape != ids.shape or dists.dtype != torch.float32:
        raise ValueError("dists must be float32 with the shape of ids")
    if flags.shape != ids.shape or flags.dtype != torch.uint8:
        raise ValueError("flags must be uint8 with the shape of ids")
    devs = {t.device for t in (x, ids, dists, flags)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must share one device, got {devs}")


def rng_prune(x: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor,
              flags: torch.Tensor | None = None, metric: str = "l2",
              chunk: int = 512):
    """Returns (keep u8, red_w i32, red_d f32), each (R, M).

    ``ids`` rows are distance-sorted candidate lists of R vertices (-1 pad),
    ``dists`` their distances, ``flags`` 1 = "new" (None: all new, plain
    Algorithm 3). Old-old pairs are exempt. ``x`` may be bfloat16 (the gather
    reads half the bytes; the Gram accumulates in f32). On CPU tensors this
    runs :func:`rng_prune_plain`; on CUDA tensors the kernel, which reads an
    id outside [0, n) as padding instead of faulting."""
    if flags is None:
        flags = torch.ones_like(ids, dtype=torch.uint8)
    metric_code(metric)
    _check(x, ids, dists, flags)
    if x.device.type == "cpu":
        return rng_prune_plain(x, ids, dists, flags, metric, chunk)
    return _launch(x, ids, dists, flags, metric)


def rng_prune_plain(x, ids, dists, flags=None, metric: str = "l2", chunk: int = 512):
    """Plain PyTorch version: gather ``chunk`` rows' candidates, f32 Gram,
    scan (:func:`rng_prune_ref`)."""
    if flags is None:
        flags = torch.ones_like(ids, dtype=torch.uint8)
    outs = [rng_prune_ref(ids[s:s + chunk], dists[s:s + chunk], flags[s:s + chunk],
                          x[ids[s:s + chunk].clamp(min=0).long()], metric)
            for s in range(0, max(ids.shape[0], 1), chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _launch(x, ids, dists, flags, metric):
    r, m = ids.shape
    n, d = x.shape
    if m > MAX_M:
        raise ValueError(f"capacity M={m} exceeds the kernel's candidate tile {MAX_M}")
    if n >= 2**31 or r >= 2**31:
        raise ValueError("n and R must fit int32")
    x, ids, dists, flags = (t.contiguous() for t in (x, ids, dists, flags))
    keep = torch.empty((r, m), dtype=torch.uint8, device=x.device)
    red_w = torch.empty((r, m), dtype=torch.int32, device=x.device)
    red_d = torch.empty((r, m), dtype=torch.float32, device=x.device)
    if r == 0 or m == 0:
        return keep, red_w, red_d
    rc = _build.load("rng_prune", "ppppiiiiiipppp")(
        x.data_ptr(), ids.data_ptr(), dists.data_ptr(), flags.data_ptr(),
        n, d, r, m, metric_code(metric), int(x.dtype == torch.bfloat16),
        keep.data_ptr(), red_w.data_ptr(), red_d.data_ptr(),
        _build.stream_handle(x.device))
    _build.check(rc, "rng_prune")
    LAUNCHES["rng_prune"] += 1
    return keep, red_w, red_d
