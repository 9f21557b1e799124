"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It drives ``uncalled_tpu_torch`` on the CUDA device(s) the cell asks for
and exits with a non-zero code, printing no result, where there are too
few.  Set-up is timed from here.
"""

import os
import sys
import time

T0 = time.time()
# one process with few threads: no thread pool of numpy's or torch's
# spinning beside the host loop (the program's own DSP pool stays)
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
