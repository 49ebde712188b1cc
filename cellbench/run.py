"""Run one benchmark cell once and print its result as the last line.

    python3 cellbench/run.py --workload northstar_bf16.matvec --seed 7 \
        --seconds 10 --trace 0

(also ``python3 -m cellbench.run ...``) from the root of a checkout that
holds the program beside this directory.
"""

import sys
import time

STARTED = time.perf_counter()

from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# Run as a script, Python puts this directory first on the path, where its
# modules could shadow others: the checkout's root goes there instead.
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(HERE.parent)
else:
    sys.path.insert(0, str(HERE.parent))

from cellbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=STARTED))
