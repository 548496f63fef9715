"""Device health probing (port of ``sdr_tpu/obs/health.py``).

``probe_device`` runs a tiny reduction on the device on a watchdog
thread, so a caller can fail fast when the device hangs or raises
(the sweep driver's checkpoint/resume makes a retry later loss-free).
``hbm_bandwidth_gbps`` measures the device's sustained memory rate.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import torch


@dataclasses.dataclass
class HealthReport:
    healthy: bool
    latency_s: float | None
    backend: str | None  # the device type ("cuda" or "cpu")
    error: str | None = None


def probe_device(timeout_s: float = 30.0, device="cuda") -> HealthReport:
    """Dispatch + fetch a trivial reduction on ``device`` under a watchdog.

    Returns healthy=False if the fetch does not complete in time (a hung
    device does not raise — it blocks, hence the thread) or if the
    dispatch raises (no card, for one).
    """
    result: dict = {}

    def work():
        try:
            dev = torch.device(device)
            t0 = time.perf_counter()
            val = float(torch.ones((8, 128), dtype=torch.float32, device=dev).sum())
            result["latency"] = time.perf_counter() - t0
            result["backend"] = dev.type
            result["ok"] = val == 1024.0
        except Exception as e:  # noqa: BLE001 — report, don't crash the probe
            result["error"] = repr(e)

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        return HealthReport(False, None, None, error=f"probe hung > {timeout_s}s")
    if result.get("error"):
        return HealthReport(False, None, None, error=result["error"])
    return HealthReport(
        healthy=bool(result.get("ok")),
        latency_s=result.get("latency"),
        backend=result.get("backend"),
    )


def hbm_bandwidth_gbps(n_floats: int = 32 * 1024 * 1024, iters: int = 12,
                       device="cuda") -> float:
    """Sustained memory bandwidth in GB/s: ``iters`` chained passes over
    two float32 buffers of ``n_floats``, each pass one elementwise kernel
    that reads the buffer the last pass wrote and writes the other
    (b = a + 1, then a = b + 1, ...), after one warm-up pass. The
    dependency rides in the kernel's own input, so the window holds the
    streaming passes alone. Counts the read and the write (2× the
    buffer), as the JAX probe does. Timed with CUDA events on the card,
    on the host clock on the CPU."""
    dev = torch.device(device)
    gen = torch.Generator(device="cpu").manual_seed(1)
    bufs = [torch.randn((n_floats,), generator=gen, dtype=torch.float32).to(dev)]
    bufs.append(torch.empty_like(bufs[0]))

    def one_pass(i):
        torch.add(bufs[i % 2], 1.0, out=bufs[(i + 1) % 2])

    one_pass(0)  # warm-up: buffer 0 into buffer 1
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for i in range(1, iters + 1):
            one_pass(i)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for i in range(1, iters + 1):
            one_pass(i)
        float(bufs[(iters + 1) % 2][0])
        seconds = time.perf_counter() - t0
    return iters * 2 * n_floats * 4 / seconds / 1e9
