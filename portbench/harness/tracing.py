"""The traced run's instruments: ``torch.profiler`` over a region the
driver marks, and the program's own spans (``repro_torch.obs``) over it.
Off (``--trace 0``), every method does nothing, so the timed run carries no
instrument."""
from __future__ import annotations

import contextlib

import torch

from portbench.harness import profile


class Tracer:
    def __init__(self, on: bool, device: torch.device):
        self.on, self.device = on, device
        self.summary = None     # profile.reduce() of the region, after finish()
        self.spans = []         # obs span events recorded in the region
        self.stats = {}         # counts the driver hands to the readers
        self._prof = None

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def warm(self) -> None:
        """Start the profiler once in set-up: its first start loads the
        tracing library, which must not fall in the window."""
        if not self.on:
            return
        from torch.profiler import profile as prof_
        with prof_(activities=self._activities()):
            torch.zeros(1, device=self.device).add_(1)
            sync(self.device)

    @contextlib.contextmanager
    def region(self, spans: bool):
        """Profile the block (and with ``spans`` record the program's
        spans); :meth:`finish` reads the profile once the window is over."""
        if not self.on:
            yield
            return
        from torch.profiler import profile as prof_
        from torch.profiler import record_function

        from repro_torch import obs
        if spans:
            obs.reset()
            obs.enable()
        prof = prof_(activities=self._activities())
        prof.start()
        try:
            with record_function(profile.MARK):
                yield
                sync(self.device)
        finally:
            prof.stop()
            if spans:
                obs.disable()
        self._prof = prof
        if spans:
            self.spans = obs.trace.events()

    def finish(self) -> None:
        if self._prof is not None:
            self.summary = profile.summarize(self._prof)
            self._prof = None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
