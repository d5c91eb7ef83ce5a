"""The harness of the port's test files, ``tests/torch_port_harness.py``:
the torch thread budget of a pytest-xdist worker, and the report of every
thread's stack when a test runs past ``HANG_REPORT_S``."""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

import torch_port_harness
from torch_port_harness import hang_report, hang_report_module  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))

# A child pytest session, without xdist, whose hang report fires after 1 s:
# inside the set-up of a module fixture that the first test asks for,
# inside that of one that only the third test asks for, and inside the
# fourth test's body; never in the quick second test.
CHILD_TESTS = '''
import os
import time

import pytest

import torch_port_harness
from torch_port_harness import hang_report, hang_report_module  # noqa: F401

torch_port_harness.HANG_REPORT_S = 1


@pytest.fixture(scope="module")
def slow_first_setup():
    time.sleep(2.5)


@pytest.fixture(scope="module")
def slow_later_setup():
    time.sleep(2.5)


def test_slow_first_setup(slow_first_setup):
    pass


def test_quick_and_uncapped():
    assert torch_port_harness.THREADS is None
    assert "OMP_NUM_THREADS" not in os.environ
    assert "MKL_NUM_THREADS" not in os.environ


def test_slow_later_setup(slow_later_setup):
    pass


def test_slow_body():
    time.sleep(2.5)
'''


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    root = tmp_path_factory.mktemp("harness")
    shutil.copy(os.path.join(HERE, "torch_port_harness.py"), root)
    (root / "test_child.py").write_text(textwrap.dedent(CHILD_TESTS))
    (root / "pytest.ini").write_text("[pytest]\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")
           and k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", "-c", str(root / "pytest.ini"),
         "--rootdir", str(root), str(root / "test_child.py")],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("workers, threads",
                         [(1, 8), (3, 2), (6, 1), (8, 1), (64, 1)])
def test_worker_threads_share_out_eight_cpus(workers, threads):
    env = {"PYTEST_XDIST_WORKER_COUNT": str(workers)}
    assert torch_port_harness.worker_threads(env, cpus=8) == threads
    assert torch_port_harness.worker_threads({}, cpus=8) is None


def test_this_process_keeps_its_thread_budget():
    """Under xdist with N workers, torch runs at most usable CPUs // N
    threads (at least one), and spawned children inherit the cap through
    OMP_NUM_THREADS; without xdist nothing is capped."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        assert torch_port_harness.THREADS is None
        return
    cap = max(1, len(os.sched_getaffinity(0)) // int(workers))
    assert torch_port_harness.THREADS == cap
    assert torch.get_num_threads() <= cap
    assert os.environ["OMP_NUM_THREADS"] == str(cap)
    assert os.environ["MKL_NUM_THREADS"] == str(cap)


def test_no_thread_cap_without_xdist(child):
    assert child.returncode == 0, child.stdout + child.stderr
    assert "4 passed" in child.stdout


def test_hang_report_prints_the_stacks_and_fails_nothing(child):
    """Past the limit every thread's stack goes to stderr, from inside the
    set-up of a module fixture (the file's first or a later one) and from
    inside a test, and the tests pass."""
    assert child.returncode == 0, child.stdout + child.stderr
    assert child.stderr.count("Timeout (0:00:01)!") == 3, child.stderr
    assert "in slow_first_setup" in child.stderr
    assert "in slow_later_setup" in child.stderr
    assert "in test_slow_body" in child.stderr
    assert "in test_quick_and_uncapped" not in child.stderr
