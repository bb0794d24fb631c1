"""Readings that the output check's limits are set from, for a PtEmbedTRv3 serving
cell: ``calibrate.py``'s readings with the v3 check (``serving_v3.judge``) and the v3
reference (``reference/poem_v3_ref.py``) in place of the flagship's, in one process:

* the program's numbers over many seeds: the timed path (``Predictor.__call__``
  over every batch of the pool) against the float32 v3 reference, as a run
  compares them, with ``calibrate.dlt_look``'s look at each sample's gap beside
  its valid views;
* the control's numbers on a few seeds: the v3 reference with fp8 products (the
  precision below the configuration's bf16 compute) in the program's place.

    python benchmark/calibrate_v3.py --workload <cell> --seeds 12 --control-seeds 3

Prints one JSON line a reading and a summary line. Needs a CUDA card.
"""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import calibrate  # noqa: E402
from benchmark.reference.poem_v3_ref import V3Reference  # noqa: E402
from benchmark.serving_v3 import judge  # noqa: E402

if __name__ == "__main__":
    # calibrate.serve_readings looks both names up in its module when it runs
    calibrate.judge, calibrate.Reference = judge, V3Reference
    sys.exit(calibrate.main())
