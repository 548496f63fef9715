"""The measured window: one client in a closed loop with a fixed number
of engine calls in flight, as a sweep that reads each batch's counts a
batch late.

Call k is enqueued with seed ``invocation_seed(seed, point, k)`` (grid
point 0 in the measured window); its
per-channel (bit_errors, bits_counted) are copied to pinned host memory
without blocking and an event is recorded; then the oldest call is waited
for once ``in_flight`` calls are out, and its counts are summed on the
host in int64. A call belongs to the window when it was enqueued before
the window's end; the window closes when the last one's counts are on
the host. A reservoir drawn from the seed keeps the per-channel errors of
a few calls for the correctness check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque

import numpy as np
import torch

# The sweep's seed rule (the simulator's documented invocation seeds): a
# point's stride, the mix of the run's seed, and how many points stay unique.
_POINT_STRIDE = 1_000_003
_SEED_MIX = 0x9E3779B1
_MAX_POINTS = (1 << 31) // _POINT_STRIDE


def invocation_seed(seed: int, point: int, batch: int) -> int:
    """Seed of call ``batch`` of grid point ``point``."""
    if not 0 <= point < _MAX_POINTS or not 0 <= batch < _POINT_STRIDE:
        raise ValueError(f"seeds are unique for < {_MAX_POINTS} points and < {_POINT_STRIDE} "
                         f"calls a point; got point {point}, call {batch}")
    return (int(seed) * _SEED_MIX + point * _POINT_STRIDE + batch) & 0x7FFFFFFF


class Spans:
    """The benchmark's spans (``engine.call``, ``host.read_counts``,
    ``setup.warm``): profiler ranges when ``annotate``, else nothing; the
    window keeps its own per-call times."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate

    def __call__(self, name: str):
        return torch.profiler.record_function(name) if self.annotate else contextlib.nullcontext()


@dataclasses.dataclass
class CallRecord:
    index: int
    seed: int
    t_start: float
    t_return: float
    t_done: float = float("nan")
    failed: bool = False
    error: str = ""


@dataclasses.dataclass
class WindowResult:
    calls: list
    t_first: float
    t_last: float
    errors: int
    bits: int
    kept: dict  # call index → (seed, per-channel errors int64 array)

    @property
    def attempted(self) -> int:
        return len(self.calls)

    @property
    def failed(self) -> int:
        return sum(c.failed for c in self.calls)

    @property
    def seconds(self) -> float:
        return self.t_last - self.t_first


class _Fence:
    """Where the call's counts land on the host, and when they are there."""

    def __init__(self, n: int, device: torch.device):
        pin = device.type == "cuda"
        self.errs = torch.empty(n, dtype=torch.int32, pin_memory=pin)
        self.counted = torch.empty(n, dtype=torch.int32, pin_memory=pin)
        self.event = torch.cuda.Event() if pin else None

    def post(self, errs: torch.Tensor, counted: torch.Tensor) -> None:
        self.errs.copy_(errs, non_blocking=self.event is not None)
        self.counted.copy_(counted, non_blocking=self.event is not None)
        if self.event is not None:
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def run_window(call, n_channels: int, bits_per_channel: int, seed: int, seconds: float,
               in_flight: int, device: torch.device, spans: Spans, keep: int = 4,
               point: int = 0) -> WindowResult:
    """Drive ``call(seed) -> (errs, counted)`` for ``seconds``; see the
    module docstring. ``keep`` calls' per-channel errors are kept, a
    uniform sample of the window's calls drawn from ``seed``."""
    fences = [_Fence(n_channels, device) for _ in range(in_flight + 1)]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, 0x5A3])
    calls: list[CallRecord] = []
    pending: deque = deque()
    kept: dict = {}
    totals = [0, 0]

    def finish(rec: CallRecord, fence: _Fence | None) -> None:
        if fence is not None:
            with spans("host.read_counts"):
                fence.wait()
                errs = fence.errs.numpy().astype(np.int64)
                counted = fence.counted.numpy().astype(np.int64)
            rec.t_done = time.perf_counter()
            if not (counted == bits_per_channel).all():
                rec.failed = True
            totals[0] += int(errs.sum())
            totals[1] += int(counted.sum())
            # Reservoir sampling over the calls: call i replaces a kept one
            # with probability keep/(i+1).
            if len(kept) < keep:
                kept[rec.index] = (rec.seed, errs)
            else:
                j = int(rng.integers(0, rec.index + 1))
                if j < keep:
                    del kept[sorted(kept)[j]]
                    kept[rec.index] = (rec.seed, errs)
        else:
            rec.t_done = time.perf_counter()

    t_first = time.perf_counter()
    t_end = t_first + seconds
    k = 0
    while True:
        t_start = time.perf_counter()
        if t_start >= t_end:
            break
        s = invocation_seed(seed, point, k)
        rec = CallRecord(index=k, seed=s, t_start=t_start, t_return=t_start)
        fence = fences[k % len(fences)]
        try:
            with spans("engine.call"):
                errs, counted = call(s)
                fence.post(errs, counted)
        except (RuntimeError, ValueError) as exc:  # a call that raised is a failed call
            rec.failed = True
            rec.error = repr(exc)
            fence = None
        rec.t_return = time.perf_counter()
        calls.append(rec)
        pending.append((rec, fence))
        while len(pending) >= in_flight:
            finish(*pending.popleft())
        k += 1
    while pending:
        finish(*pending.popleft())
    t_last = max((c.t_done for c in calls), default=t_first)
    return WindowResult(calls=calls, t_first=t_first, t_last=t_last, errors=totals[0],
                        bits=totals[1], kept=kept)
