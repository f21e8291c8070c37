"""How many intra-op threads a test process may use: one rule for the suite.

Under pytest-xdist every worker is a process of its own, and torch's (OpenMP)
pool and numpy's BLAS pool each size themselves to every core the process may
run on: ``-n 6`` on 8 cores ran ~48 spinning threads, and small models ran
many times slower than alone.  So a worker gets its share, the cores it may
run on divided by the worker count, at least one.  It is set at import, before
any test module imports torch, as ``OMP_NUM_THREADS``: torch's pool and every
subprocess a test starts inherit it.  Pools loaded before this module (torch,
or the BLAS that a pytest plugin loaded with numpy) are limited to the same
count.  A value of ``OMP_NUM_THREADS`` that the caller set is kept, and
outside xdist nothing changes.  (``tests/conftest.py`` holds the ``slow`` and
``cuda`` markers.)
"""
import os
import sys

# what the caller gave this process, before the rule below
CALLER_OMP_NUM_THREADS = os.environ.get("OMP_NUM_THREADS")


def _limit_worker_threads() -> None:
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers or "OMP_NUM_THREADS" in os.environ:
        return
    threads = max(1, len(os.sched_getaffinity(0)) // int(workers))
    os.environ["OMP_NUM_THREADS"] = str(threads)
    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(threads)
    if "numpy" in sys.modules:
        try:
            from threadpoolctl import threadpool_limits
        except ImportError:
            return
        threadpool_limits(threads, user_api="blas")


_limit_worker_threads()
