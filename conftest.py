"""Guards for every test collected under this root (``tests/`` and ``bench/``).

Threads.  Under pytest-xdist each worker takes its share of the cores,
``os.cpu_count() // workers`` (at least one), for torch's intra-op pool, and
``OMP_NUM_THREADS`` / ``MKL_NUM_THREADS`` carry that share to the processes a
test starts.  Without it every worker spins one OpenMP thread per core on
small eager tensors, and the workers slow one another several-fold.  A run
without xdist keeps torch's defaults.

Time limit.  Every test (setup, call and teardown together) runs under
``TEST_LIMIT_S``.  A test past it writes every thread's stack to stderr and
ends its process (``faulthandler``).  Under xdist the controller reports the
test as failed ("worker 'gwN' crashed while running ...") and starts a new
worker; that worker fails the test at once instead of running it again, and
the run goes on to its end.
"""
import faulthandler
import hashlib
import os
from pathlib import Path

import pytest

# about 4x the slowest test (53-64 s) of a 6-worker run on 8 cores
TEST_LIMIT_S = 240.0

_stderr = pytest.StashKey[int]()   # fd 2 before pytest captures output
_ran_out = pytest.StashKey[bool]()


def pytest_configure(config):
    config.stash[_stderr] = os.dup(2)
    workerinput = getattr(config, "workerinput", None)
    if workerinput is not None:
        share = max(1, (os.cpu_count() or 1) // workerinput["workercount"])
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ[var] = str(share)
        import torch
        torch.set_num_threads(share)


def _running_path(item):
    """A file that exists while ``item`` runs in an xdist worker.  All
    workers of a run share its directory (their basetemps' parent), so a
    worker that finds it knows an earlier worker ended inside the test."""
    if not hasattr(item.config, "workerinput"):
        return None
    d = Path(item.config.option.basetemp).parent / "running"
    d.mkdir(exist_ok=True)
    return d / hashlib.sha1(item.nodeid.encode()).hexdigest()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item):
    running = _running_path(item)
    if running is not None:
        item.stash[_ran_out] = running.exists()
        running.touch()
    faulthandler.dump_traceback_later(TEST_LIMIT_S, exit=True,
                                      file=item.config.stash[_stderr])
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        if running is not None:
            running.unlink()


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_setup(item):
    if item.stash.get(_ran_out, False):
        pytest.fail("an earlier worker ended inside this test (its time "
                    "limit or a crash; see that worker's stack dump above), "
                    "so it is not run again", pytrace=False)
