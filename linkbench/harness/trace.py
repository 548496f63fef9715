"""Reading the profiler's trace: device operations, the benchmark's own
spans, the busy union and the idle gaps.

Events are (name, on_device, start_us, end_us) on the trace's clock. The
traced window runs from the first ``engine.call`` span to the end of the
last device operation or span; device time outside it is clipped.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

SPAN_NAMES = ("engine.call", "host.read_counts", "setup.warm")


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    on_device: bool
    start: float  # us
    end: float  # us


def from_profiler(prof) -> list[Event]:
    """The events of a stopped ``torch.profiler.profile``, as its Kineto
    results hold them: host ranges and device operations alike."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e3
        out.append(Event(ev.name(), ev.device_type() == cuda, start,
                         start + ev.duration_ns() / 1e3))
    return out


def summary(events: list[Event], top: int = 12) -> str:
    """The commonest (on_device, name) pairs: what a trace held."""
    counts: dict = {}
    for e in events:
        k = (e.on_device, e.name[:50])
        counts[k] = counts.get(k, 0) + 1
    return "; ".join(f"{'dev' if d else 'host'} {n} x{c}"
                     for (d, n), c in sorted(counts.items(), key=lambda kv: -kv[1])[:top])


def short_name(name: str) -> str:
    """A kernel's function name without its return type, template
    arguments and parameters; a copy's own name."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    n = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[<(]", n, maxsplit=1)[0].strip() or name[:60]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def merge(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclasses.dataclass
class Trace:
    device: list  # device operations, clipped to the window
    spans: list  # the benchmark's spans
    t0: float
    t1: float

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    @property
    def calls(self) -> int:
        return sum(1 for e in self.spans if e.name == "engine.call")

    def kernels(self) -> list[Event]:
        return [e for e in self.device if not is_copy(e.name)]

    def busy_us(self) -> float:
        return sum(e - s for s, e in merge((e.start, e.end) for e in self.device))

    def idle_gaps(self) -> list[tuple[float, float]]:
        gaps, at = [], self.t0
        for s, e in merge((e.start, e.end) for e in self.device):
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def time_by_kernel(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for e in self.device:
            k = short_name(e.name)
            out[k] = out.get(k, 0.0) + (e.end - e.start)
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.time_by_kernel().items(), key=lambda kv: -kv[1])[:top]
        idle: dict[str, float] = {}
        spans = sorted(self.spans, key=lambda e: e.start)
        starts = [e.start for e in spans]
        for s, e in self.idle_gaps():
            i = bisect.bisect_right(starts, s) - 1
            k = spans[i].name if i >= 0 and spans[i].end > s else "host.other"
            idle[k] = idle.get(k, 0.0) + (e - s)
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v / 1e6] for k, v in ops],
                "idle_gaps": [[k, v / 1e6] for k, v in gaps]}


def build(events: list[Event]) -> Trace:
    """The traced window of an event list (see the module docstring)."""
    spans = [e for e in events if not e.on_device and e.name in SPAN_NAMES]
    device = [e for e in events if e.on_device and e.end > e.start
              and e.name not in SPAN_NAMES and not e.name.startswith("ProfilerStep")]
    calls = [e for e in spans if e.name == "engine.call"]
    if not calls or not device:
        raise ValueError(f"the trace holds no engine call or no device operation "
                         f"({len(events)} events: {summary(events)})")
    t0 = min(e.start for e in calls)
    t1 = max(max(e.end for e in device), max(e.end for e in spans))
    clipped = [Event(e.name, True, max(e.start, t0), e.end) for e in device if e.end > t0]
    return Trace(device=clipped, spans=[e for e in spans if e.end > t0], t0=t0, t1=t1)
