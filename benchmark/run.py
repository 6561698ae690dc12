"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness knows no cell, configuration, traffic mix or metric by name.
It reads the cell's entry in ``BENCHMARK.json``, the configuration
``benchmark/configs/<config>.json``, the traffic mix
``benchmark/traffic/<traffic>.json``, runs the mix's kind
``benchmark/kinds/<kind>.py`` (set-up, the measured window, the check of
its outputs against the plain reference), and reads each metric the cell
reports with ``benchmark/metrics/<metric>.py``: with ``--trace 0`` its
end-to-end metrics, with ``--trace 1`` its per-layer ones. The last line
of standard output is the result as one JSON object.
"""

import time

T_START = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, for the program and for this package; not the
# benchmark's own folder
sys.path[0] = str(ROOT)

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    os.environ.update(harness.cache_env(ROOT))
    return harness.run_cell(ROOT, a.workload, a.seed, a.seconds, bool(a.trace), T_START,
                            need_card=True)


if __name__ == "__main__":
    sys.exit(main())
