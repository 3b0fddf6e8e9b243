"""The port's benchmark, one cell once:

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Prints the result as the last line of standard output; exits non-zero,
with no result, without the CUDA devices the cell asks for."""

import os
import os.path as osp
import sys
import time

T_START = time.perf_counter()
# one thread for OpenMP and BLAS: the loop's host work is the main
# thread's and the reader's, and idle pool threads that spin take cores
# from them (steadier rows on a host shared with other machines)
os.environ['OMP_NUM_THREADS'] = '1'
os.environ['MKL_NUM_THREADS'] = '1'
sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from portbench import harness  # noqa: E402

if __name__ == '__main__':
    sys.exit(harness.main(sys.argv[1:], T_START))
