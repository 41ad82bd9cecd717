"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port (``sketch2img_torch``)
on a machine with the CUDA devices the cell asks for. Prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``compared``: each number of the output check beside its limit (also
the last lines of standard error). ``--control 1`` puts the
lower-precision control in the program's place: its readings are the
ones compared, and decide ``correct``, which must come out false. Without
a card it exits with 3 and prints no result.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
