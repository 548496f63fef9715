"""One run of one cell: set-up, warm-up, the window, the trace, the
check, the metrics and the result line."""

from __future__ import annotations

import gc
import math
import subprocess
import sys
import time

import numpy as np
import torch

from linkbench.harness import check, spec
from linkbench.harness import trace as tr
from linkbench.harness.window import Spans, invocation_seed, run_window

FORBIDDEN = ("jax", "jaxlib", "flax", "sdr_tpu")
WARM_CALLS = 2  # the cell's own shape, twice: the first builds, the second finds all built
TRACE_SECONDS = 3.0  # the traced calls after the window
TRACE_POINT = 2  # their seeds' grid point (the warm-up's is 1, the window's 0)


class Context:
    """What a per-layer metric's reader gets: the cell, its engine, the
    window (run without the profiler) and the trace of the calls after it
    (None without one)."""

    def __init__(self, cell, engine, window, trace):
        self.cell, self.engine, self.window, self.trace = cell, engine, window, trace


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _warm(engine, seed: int, n: int, spans: Spans) -> None:
    """n calls of the cell's own shape with seeds off the window's (grid
    point 1), each waited for."""
    with spans("setup.warm"):
        for i in range(n):
            errs, counted = engine.call(invocation_seed(seed, 1, i))
            errs.sum().item()
            counted.sum().item()


def _trace(call, engine, seed: int, in_flight: int, device, spans: Spans, activities=None):
    """torch.profiler over ``TRACE_SECONDS`` more of the window's loop,
    after the window: once started, the profiler's host work slows every
    later call, so the window itself runs without it. Its first start
    initialises for seconds: an empty start and stop does that first.
    The calls take grid point 2's seeds. Returns the stopped profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = activities or [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    warm = profile(activities=activities)
    warm.start()
    warm.stop()
    prof = profile(activities=activities)
    t1 = time.perf_counter()
    prof.start()
    try:
        traced = run_window(call, engine.n_channels, engine.bits_per_channel, seed,
                            TRACE_SECONDS, in_flight, device, spans, keep=0, point=TRACE_POINT)
    finally:
        prof.stop()
    print(f"linkbench: the profiler initialised in {t1 - t0:.3f} s and traced "
          f"{traced.attempted} calls", file=sys.stderr)
    return prof


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def e2e_metrics(cell, engine, window, setup_s: float) -> dict:
    done = [c for c in window.calls if not c.failed]
    out = {}
    for m in cell.end_to_end:
        name = m["name"]
        if name == "setup_s":
            v = setup_s
        elif name == "link_gsps":
            v = len(done) * engine.samples_per_call / window.seconds / 1e9
        elif name == "batch_ms_p95":
            v = float(np.percentile([(c.t_done - c.t_start) * 1e3 for c in done], 95))
        else:
            raise KeyError(f"no measurement for end-to-end metric {name!r}")
        out[name] = {"value": v, "unit": m["unit"]}
    return out


def layer_metrics(cell, ctx) -> dict:
    out = {}
    for m in cell.per_layer:
        v = spec.load_module("metrics", m["name"]).read(ctx)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_proc0: float,
             wrap=None) -> dict:
    """The result line's object for one run. ``wrap(call) -> call`` puts
    a fault under the timed path (the harness's own tests)."""
    device = torch.device(device)
    marks = [("imports", time.perf_counter())]
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the CUDA context
        torch.cuda.reset_peak_memory_stats()
    marks.append(("context", time.perf_counter()))
    engine = spec.load_module("engines", cell.traffic["engine"]).Engine(
        cell.config, cell.traffic, device)
    call = engine.call if wrap is None else wrap(engine.call)
    in_flight = int(cell.traffic["in_flight"])
    spans = Spans(annotate=trace)
    marks.append(("engine", time.perf_counter()))
    _warm(engine, seed, WARM_CALLS, spans)
    marks.append(("warm", time.perf_counter()))
    prev, parts = t_proc0, []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f} s")
        prev = t
    print("linkbench: set-up " + ", ".join(parts), file=sys.stderr)
    window = run_window(call, engine.n_channels, engine.bits_per_channel, seed, seconds,
                        in_flight, device, spans, keep=int(cell.checks["calls"]))
    setup_s = window.t_first - t_proc0
    prof = None
    if trace and device.type == "cuda":
        prof = _trace(call, engine, seed, in_flight, device, spans)
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
                    "memory_peak_bytes": peak, "power_limit": _power_limit()}
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    breakdown = None
    if trace:
        t = None
        if prof is not None:
            t = tr.build(tr.from_profiler(prof))
            dev_info["busy_s"] = t.busy_us() / 1e6
            dev_info["window_s"] = t.window_us / 1e6
            breakdown = t.breakdown()
        metrics = layer_metrics(cell, Context(cell, engine, window, t))
        del t, prof
    else:
        metrics = e2e_metrics(cell, engine, window, setup_s)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    correct, numbers = check.judge(engine, window, cell.checks, seed, device)
    out = {"correct": correct, "attempted": window.attempted, "failed": window.failed,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = numbers
    return out
