"""Deterministic open-loop load generator (a copy of
``repro.serving.loadgen``; ``arrival_times`` draws the reference's arrays
bit for bit).

A serving measurement needs a workload that is (a) **open-loop** — arrivals follow a schedule, they do
not wait for the server, so an overloaded server shows up as queue growth
and latency blowout instead of silently throttled offered load (the
coordinated-omission trap) — and (b) **deterministic** — the arrival
schedule and churn interleave are pure functions of the spec's seed, so two
runs of the same spec offer byte-identical work and their telemetry deltas
are attributable to the code under test.

``arrival_times`` draws the schedule once (Poisson: exponential
inter-arrival gaps at rate ``qps``; uniform: a fixed ``1/qps`` cadence);
``run_session`` replays it against a real (or injected) clock: submit every
request whose arrival time has passed, fire any write bursts attached to
those request indices, then ``pump``. Writes ride the same script —
``(after_request_index, "insert"|"delete", payload)`` tuples — so churn
lands at the same logical point in every run even though the wall-clock
instant varies with machine speed.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

ARRIVALS = ("poisson", "uniform")


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    n_requests: int = 512
    qps: float = 500.0           # offered load (schedule rate, not a cap)
    deadline_s: float = 0.050    # per-request budget handed to admission
    arrival: str = "poisson"     # "poisson" | "uniform"
    seed: int = 0

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError(
                f"n_requests must be >= 1, got {self.n_requests}")
        if self.qps <= 0:
            raise ValueError(f"qps must be > 0, got {self.qps}")
        if self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0, got {self.deadline_s}")
        if self.arrival not in ARRIVALS:
            raise ValueError(
                f"unknown arrival process {self.arrival!r}: expected one "
                f"of {ARRIVALS}")


def arrival_times(spec: LoadSpec) -> np.ndarray:
    """(n_requests,) seconds from session start, non-decreasing."""
    if spec.arrival == "uniform":
        return np.arange(spec.n_requests) / spec.qps
    rng = np.random.default_rng(spec.seed)
    gaps = rng.exponential(1.0 / spec.qps, size=spec.n_requests)
    return np.cumsum(gaps)


def run_session(frontend, queries: np.ndarray, spec: LoadSpec,
                writes: list[tuple[int, str, np.ndarray]] | None = None,
                clock=time.perf_counter) -> dict:
    """Replay one open-loop session; returns the telemetry summary plus the
    request-id list (``"rids"``) for recall evaluation of the returned
    results.

    ``queries``: (nq, d) pool — request i uses row ``i % nq``.
    ``writes``: optional churn script of ``(after_request_index, kind,
    payload)`` — submitted to the frontend's writer the moment request
    ``after_request_index`` is admitted (payload: (b, d) rows for
    "insert", (b,) ids for "delete").
    """
    arr = arrival_times(spec)
    writes = sorted(writes or [], key=lambda w: w[0])
    rids: list[int] = []
    t0 = clock()
    i = 0
    w = 0
    while i < len(arr):
        now = clock()
        while i < len(arr) and t0 + arr[i] <= now:
            rids.append(frontend.submit(queries[i % len(queries)],
                                        deadline_s=spec.deadline_s))
            while w < len(writes) and writes[w][0] <= i:
                kind, payload = writes[w][1], writes[w][2]
                if kind == "insert":
                    frontend.submit_insert(payload)
                elif kind == "delete":
                    frontend.submit_delete(payload)
                else:
                    raise ValueError(
                        f"unknown write kind {kind!r} in churn script")
                w += 1
            i += 1
        frontend.pump()   # pump re-reads the clock: submits happened since
    # the tail: whatever is still queued dispatches immediately (its
    # deadline trigger would fire within half a budget anyway) and the
    # remaining in-flight tiles are harvested
    frontend.drain()
    out = frontend.telemetry.summary()
    out["rids"] = rids
    return out
