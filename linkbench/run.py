"""One run of one benchmark cell of the link simulator's PyTorch and CUDA
port, on the card this process finds.

    python3 linkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Python's bytecode cache goes to
``.linkbench-cache/pyc`` there. Prints progress and the compared numbers
on standard error, and as the last line of standard output one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``, each compared number with its limit. Exits non-zero, with no
result, when no CUDA device is found, when the cell asks for more cards
than there are, or when JAX or the JAX package was loaded.
"""

import time

T_PROC0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Python's bytecode cache at a fixed path inside the checkout, whatever the
# environment says: the first run compiles torch's and the port's modules,
# every later run loads them.
sys.pycache_prefix = str(ROOT / ".linkbench-cache" / "pyc")
sys.dont_write_bytecode = False

import os  # noqa: E402

# The run's threads on two fixed cores, the last two it may use: its host
# pace wanders less from run to run.
os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])

import argparse  # noqa: E402
import json  # noqa: E402

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from linkbench.harness import runner, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"linkbench: the cell asks for {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROC0)
    loaded = runner.forbidden_modules()
    if loaded:
        print(f"linkbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, num in result["check"].items():
        print(f"check {name}: {num['value']} (limit {num['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
