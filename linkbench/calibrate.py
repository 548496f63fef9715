"""Readings for the limits of the correctness check, on the card.

    python3 linkbench/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--control-seeds <n> ...] [--seconds 2]

For each seed: a short window of the cell's own calls at its own sizes,
the run's sample of calls and channels, and the gap (``check.py``)
between the port's counts and the plain reference's: the lower reading.
For each control seed the same sample from the reference in bfloat16
against the reference in float32: the upper reading. Prints one JSON line
a seed. The benchmark's runs never run this.
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)

    import torch

    from linkbench.harness import check, spec
    from linkbench.harness.window import Spans, run_window

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cell = spec.cell(args.workload)
    engine = spec.load_module("engines", cell.traffic["engine"]).Engine(cell.config, cell.traffic,
                                                                        dev)
    for label, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            t = time.perf_counter()
            window = run_window(engine.call, engine.n_channels, engine.bits_per_channel, seed,
                                args.seconds, int(cell.traffic["in_flight"]), dev, Spans(),
                                keep=int(cell.checks["calls"]))
            picked = check.samples(engine, window.kept, seed, cell.checks["channels"], dev)
            t_ref = time.perf_counter()
            if label == "program":
                gap = check.reference_gap(engine, picked)
            else:
                ctl = [engine.reference(s, ids, "bf16").cpu().numpy() for s, ids, _ in picked]
                gap = check.reference_gap(engine, picked, against=ctl)
            print(json.dumps({"cell": cell.name, "reading": label, "seed": seed,
                              "err_gap_ppm": gap, "calls": window.attempted,
                              "failed": window.failed, "errors": window.errors,
                              "bits": window.bits, "window_s": window.seconds,
                              "reference_s": time.perf_counter() - t_ref,
                              "total_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
