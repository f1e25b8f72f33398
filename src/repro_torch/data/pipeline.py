"""Host-side data pipeline (port of ``repro.data.pipeline``): deterministic
seeded batch streams and device prefetch.

Determinism contract (restarts depend on it): a batch is a pure function of
(dataset seed, global step), so a restart from a checkpoint replays the
exact stream. The rule: step ``s`` of seed ``seed`` draws from a
``torch.Generator`` seeded with ``seed * 2**32 + s`` (0 <= s < 2**32,
0 <= seed < 2**31), on the device the batch is made on.
"""
from __future__ import annotations

import collections
from typing import Callable, Iterator

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpoint import flatten, unflatten


def step_generator(seed: int, step: int, device: str | torch.device = "cpu") -> torch.Generator:
    """The generator of (seed, step), by the rule above."""
    if not (0 <= step < 2**32 and 0 <= seed < 2**31):
        raise ValueError(f"seed {seed} / step {step} out of range")
    return torch.Generator(device=resolve_device(device)).manual_seed(seed * 2**32 + step)


def seeded_stream(batch_fn: Callable[[torch.Generator], dict], seed: int,
                  start_step: int = 0, device: str | torch.device = "cpu") -> Iterator[dict]:
    """batch_fn(generator) -> batch, the generator from (seed, step)."""
    step = start_step
    while True:
        yield batch_fn(step_generator(seed, step, device))
        step += 1


def prefetch(it: Iterator[dict], size: int = 2,
             device: str | torch.device = "cuda") -> Iterator[dict]:
    """Keeps ``size`` batches in flight on ``device``: host tensors are
    pinned and copied with ``non_blocking`` (on a CUDA device), so host
    batch generation overlaps device compute."""
    dev = resolve_device(device)
    buf = collections.deque()

    def put(batch):
        def move(x):
            if dev.type == "cuda" and x.device.type == "cpu":
                return x.pin_memory().to(dev, non_blocking=True)
            return x.to(dev)
        buf.append(unflatten(batch, (move(x) for _, x in flatten(batch))))

    for batch in it:
        put(batch)
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
