"""Run one cell of BENCHMARK.json and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics. Weights and traffic come from ``--seed``; the set-up
(imports, kernel loads, weights, warm-up) is timed from the first line of
this file. Exits non-zero with no result when the card the cell needs is
missing, when the program cannot be loaded, or when the JAX package was
loaded.

Options for measuring the benchmark itself, never used by its runs:
``--control fp8`` also reads the comparison with the reference in the
precision below the configuration's (the control); ``--fault <name>``
plants a fault in the timed path (``harness/faults.py``); ``--rate`` sets
an open loop's session rate (the knee sweep); ``--dry-run`` runs the cell's
tiny CPU rehearsal.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", choices=("fp8",), default=None)
    parser.add_argument("--fault", default=None)
    parser.add_argument("--rate", type=float, default=None)
    parser.add_argument("--dry-run", action="store_true")
    raise SystemExit(main.run(parser.parse_args(), STARTED))
