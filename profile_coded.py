#!/usr/bin/env python3
"""Where the time of the coded engine and of the link pipeline goes, on
one NVIDIA GPU.

Run from the root of the repository on a machine with a Hopper card:

    python3 profile_coded.py

For ``ldpc_fast_simulate`` on the coded cell ``chip_smoke.py`` phase 3g
times (``chip_smoke.coded_cell``: config 2, 8192 channels × 64 symbols,
RAYLEIGH_FLAT 6 dB, rate 1/2), in each of its seam × schedule variants
(``chip_smoke.CODED_VARIANTS``), and for the pipeline cells phase 3p
times (``chip_smoke.pipeline_cell``: ``link.pipeline.simulate`` on
``__graft_entry__.entry()``'s link at config 2, 8192 × 64, with MMSE and
with ZF, and ``link.stream.stream_simulate`` on it at n_blocks 4): one
warm-up call, then ``torch.profiler`` over three calls. Prints, per
call, the host-clock time, the device time (kernels summed), the
device's idle share (1 − device / host time) and the device time of the
largest kernels by name, then the card's name and power limit. It exits
non-zero without a CUDA device, or when the trace holds no device time.
"""

from __future__ import annotations

import subprocess
import sys
import time


def _short(name: str) -> str:
    """The port's kernels by their own names; torch's by what they do."""
    for key in ("ldpc_minsum", "demod_llr_cl", "demod_llr", "tx_kernel", "fade_fir", "fade_stream",
                "payload", "demod_rows"):
        if key in name:
            return key
    for key, label in (("index_elementwise", "torch gather"), ("CatArray", "torch cat"),
                       ("reduce_kernel", "torch reduce"), ("elementwise", "torch elementwise")):
        if key in name:
            return label
    return name[:40]


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_coded: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from chip_smoke import CODED_VARIANTS, SEED, coded_cell, pipeline_cell
    from sdr_tpu_torch.core.config import Equalizer
    from sdr_tpu_torch.link.fast_coded import ldpc_fast_simulate
    from sdr_tpu_torch.link.pipeline import simulate
    from sdr_tpu_torch.link.stream import stream_simulate

    dev = torch.device("cuda")
    cfg = coded_cell()
    entry, zf = pipeline_cell(), pipeline_cell(equalizer=Equalizer.ZF)
    cells = [(f"seam={seam} {schedule} {iters}",
              lambda seam=seam, schedule=schedule, iters=iters: ldpc_fast_simulate(
                  cfg, SEED, iters=iters, schedule=schedule, seam=seam, device=dev))
             for seam, schedule, iters in CODED_VARIANTS]
    cells += [("pipeline-entry", lambda: simulate(entry, SEED, device=dev)),
              ("pipeline-zf", lambda: simulate(zf, SEED, device=dev)),
              ("stream-multipath n_blocks 4", lambda: stream_simulate(entry, SEED, 4, device=dev))]
    reps = 3
    for label, call in cells:
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps * 1e3
        by_name: dict[str, float] = {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
                key = _short(ev.key)
                by_name[key] = by_name.get(key, 0.0) + us / 1e3 / reps
        device = sum(by_name.values())
        if device <= 0:
            print("profile_coded: the trace holds no device time", file=sys.stderr)
            return 1
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(f"{label}: host {wall:.3f} ms per call, device "
              f"{device:.3f} ms, idle share {1.0 - device / wall:.4f}; by kernel (ms per call): "
              + "; ".join(f"{k} {v:.3f}" for k, v in top))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
