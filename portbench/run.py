"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Reads the cell from ``BENCHMARK.json``, builds its configuration
(``portbench/configs/<config>.py`` over ``<config>.json``) and its traffic
(``portbench/traffic/<mix>.json``) from the seed, warms the pipeline up,
hands it lists of recordings for ``--seconds`` seconds, checks what it
produced against the plain reference (``portbench/reference/``) and
prints one JSON line. ``--trace 1`` profiles one list of the window and
reports the cell's per-layer metrics (``portbench/metrics/<name>.py``)
in place of its end-to-end ones. Without a CUDA card, or with fewer than
the cell asks for, it prints no result and exits with 2.
"""

import time

PROCESS_START = time.perf_counter()

import os  # noqa: E402

# the host's OpenMP and BLAS pools at one thread each, set before numpy
# and torch load: the pipeline's host work (decode threads, clustering)
# then runs alike in every run instead of contending for the cores
for _pool in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_pool] = "1"

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], started=PROCESS_START))
