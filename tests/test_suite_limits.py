"""The root ``conftest.py``'s guards, each run as its own pytest session on
a throwaway test file beside a copy of the conftest and ``pytest.ini``:

* under xdist a test that sleeps past its time limit (the copy's
  ``TEST_LIMIT_S`` cut to 2 s) fails alone, with its stack in the output,
  and the session ends by itself with the next test passed;
* without xdist the same test writes its stack and ends the session;
* under xdist each worker's torch pool is its share of ``os.cpu_count()``,
  and a child the test starts sees that share in ``OMP_NUM_THREADS`` and
  ``MKL_NUM_THREADS``; without xdist neither is set.
"""
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SLEEPER = """
import time

def test_sleeps_past_its_limit():
    time.sleep(60)


def test_quick():
    pass
"""

THREADS = """
import os
import subprocess
import sys

import torch


def test_threads_are_the_workers_share():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    share = str(max(1, os.cpu_count() // int(workers))) if workers else None
    if share is not None:
        assert torch.get_num_threads() == int(share)
    child = subprocess.run(
        [sys.executable, "-c", "import os; print(os.environ.get("
         "'OMP_NUM_THREADS'), os.environ.get('MKL_NUM_THREADS'))"],
        capture_output=True, text=True, check=True)
    assert child.stdout.split() == [str(share)] * 2
"""


def _session(tmp_path, source, *args, test_limit=None):
    """Run pytest on ``source`` in ``tmp_path`` with the root's conftest and
    ini, free of the calling session's xdist and thread settings."""
    (tmp_path / "test_case.py").write_text(textwrap.dedent(source))
    conftest = (ROOT / "conftest.py").read_text()
    if test_limit is not None:
        line = "TEST_LIMIT_S = 240.0\n"
        assert line in conftest
        conftest = conftest.replace(line, f"TEST_LIMIT_S = {test_limit}\n")
    (tmp_path / "conftest.py").write_text(conftest)
    shutil.copy(ROOT / "pytest.ini", tmp_path)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "OMP_NUM_THREADS",
                                "MKL_NUM_THREADS"))}
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-rA", "-p", "no:cacheprovider",
         "-p", "no:randomly", "--basetemp", str(tmp_path / "basetemp"),
         *args], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=120)


def test_a_test_past_its_limit_fails_alone_and_the_session_ends(tmp_path):
    r = _session(tmp_path, SLEEPER, "-p", "xdist", "-n", "1", "--dist",
                 "loadfile", test_limit=2.0)
    out = r.stdout + r.stderr
    assert r.returncode == 1, out
    # the dump: every thread's stack, the sleeping frame among them
    assert "Timeout (0:00:02)!" in out, out
    assert "in test_sleeps_past_its_limit" in out, out
    assert ("crashed while running "
            "'test_case.py::test_sleeps_past_its_limit'") in out, out
    # the replacement worker fails the test again without running it
    assert "an earlier worker ended inside this test" in out, out
    assert "PASSED test_case.py::test_quick" in out, out
    assert "1 passed" in out, out


def test_without_xdist_a_test_past_its_limit_dumps_and_ends(tmp_path):
    r = _session(tmp_path, SLEEPER, test_limit=2.0)
    out = r.stdout + r.stderr
    assert r.returncode == 1, out
    assert "Timeout (0:00:02)!" in r.stderr, out
    assert "in test_sleeps_past_its_limit" in r.stderr, out
    assert "passed" not in r.stdout, out


@pytest.mark.parametrize("args", [("-p", "xdist", "-n", "2"), ()],
                         ids=["xdist", "plain"])
def test_worker_threads_are_a_share_of_the_cores(tmp_path, args):
    r = _session(tmp_path, THREADS, *args)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out
    assert "1 passed" in out, out
