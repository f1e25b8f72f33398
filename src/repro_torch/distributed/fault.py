"""Fault tolerance and straggler detection for long-running jobs (port of
``repro.distributed.fault``).

  * StepWatchdog      per-step wall-time tracker; flags stragglers above
                      ``straggler_factor`` x the trailing median.
  * run_with_restarts crash-looping driver: run the step loop, checkpoint
                      every k steps, on failure restore the latest commit
                      and continue; a step that derives its data from its
                      index makes recovery exact.
  * elastic restore   checkpoints are host numpy (the port's checkpoint,
                      the reference's format), so a job resumes onto
                      whatever device it runs on now (``device=``, the
                      reference's ``shardings=``; by default the device
                      of the fresh state's leaves), or onto a mesh of ranks
                      (``mesh=`` with the state's logical ``axes``: every
                      rank runs the loop on its blocks, rank 0 writes the
                      whole leaves, each rank restores its blocks).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.obs import trace


@dataclasses.dataclass
class StepWatchdog:
    window: int = 50
    straggler_factor: float = 1.5
    times: list = dataclasses.field(default_factory=list)

    def record(self, seconds: float) -> dict:
        self.times.append(seconds)
        hist = self.times[-self.window:]
        med = float(np.median(hist))
        is_straggler = len(hist) >= 10 and seconds > self.straggler_factor * med
        return {
            "step_time_s": seconds,
            "step_time_median_s": med,
            "straggler": bool(is_straggler),
        }


def _state_device(state) -> torch.device:
    """The device of the state's first tensor leaf (the host when it has
    none)."""
    for _, leaf in flatten(state):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def run_with_restarts(
    make_state: Callable[[], Any],          # fresh state
    step_fn: Callable[[Any, int], tuple[Any, dict]],   # (state, step) -> (state, metrics)
    n_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    max_restarts: int = 3,
    keep: int = 3,
    device: str | torch.device | None = None,
    mesh=None,
    axes=None,
) -> tuple[Any, list[dict]]:
    """Deterministic crash-recovery driver.

    ``step_fn`` receives the global step index and must derive its batch
    from it (deterministic data order == exact recovery). Any exception
    triggers a restore from the latest commit (its leaves as tensors on
    ``device``, by default the device of ``make_state()``'s first tensor
    leaf, the host for a state of numpy leaves); unrecoverable only after
    ``max_restarts``. Under ranks
    every rank calls it with the same arguments, and a step that fails
    must fail on every rank (a collective of one rank alone waits out the
    group's timeout and fails the run)."""
    io = {"mesh": mesh, "axes": axes}
    history: list[dict] = []
    restarts = 0
    state = make_state()
    if device is None:
        device = _state_device(state)
    start = 0
    latest = ckpt.latest_step(ckpt_dir)
    if latest is not None:
        state = ckpt.restore(ckpt_dir, latest, state, device=device, **io)
        start = latest + 1

    watchdog = StepWatchdog()
    step = start
    while step < n_steps:
        try:
            with trace.timed("fault/step", step=step) as tm:
                state, metrics = step_fn(state, step)
            metrics.update(watchdog.record(tm.seconds))
            history.append(metrics)
            if (step + 1) % ckpt_every == 0 or step == n_steps - 1:
                ckpt.save(ckpt_dir, step, state, keep=keep, **io)
            step += 1
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            latest = ckpt.latest_step(ckpt_dir)
            state = make_state()
            if latest is not None:
                state = ckpt.restore(ckpt_dir, latest, state, device=device, **io)
                step = latest + 1
            else:
                step = 0
    return state, history
