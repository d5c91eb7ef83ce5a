"""What every ``tests/test_torch_port_*.py`` file imports first: a torch
thread budget for each pytest-xdist worker, and a report of every thread's
stack when one of the file's tests runs past ``HANG_REPORT_S``.

A port test file brings the report's fixtures into its namespace::

    from torch_port_harness import hang_report, hang_report_module  # noqa: F401

The thread budget is set when this module is first imported.  Every xdist
worker imports every test module while it collects, before its first test
runs, so the budget holds in every worker whichever file it runs first.
Run without xdist, nothing is capped.
"""

import contextlib
import faulthandler
import os

import pytest
import torch

# Seconds a test may run before every thread's stack is printed to stderr
# (the test goes on and is not failed).
HANG_REPORT_S = 240


def usable_cpus():
    """CPUs this process may run on: its affinity where the platform has
    one, else every CPU of the host."""
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


def worker_threads(env=os.environ, cpus=None):
    """Torch threads for one pytest-xdist worker: the CPUs shared out over
    the workers, at least one.  ``None`` outside xdist."""
    workers = env.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, (cpus or usable_cpus()) // int(workers))


# Each worker would otherwise take torch's default of a thread per core, so
# that n workers run n × cores compute threads.  The environment carries
# the cap to the processes a test spawns.
THREADS = worker_threads()
if THREADS is not None:
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = \
        str(THREADS)
    torch.set_num_threads(THREADS)


_STDERR_COPY = None


def _arm(config):
    """Start the clock again; the report goes to a copy of stderr taken
    outside pytest's capture, so that it reaches the log while a test's
    output is captured."""
    global _STDERR_COPY
    if _STDERR_COPY is None:
        capture = config.pluginmanager.getplugin("capturemanager")
        with (capture.global_and_fixture_disabled() if capture
              else contextlib.nullcontext()):
            _STDERR_COPY = os.dup(2)
    faulthandler.dump_traceback_later(HANG_REPORT_S, exit=False,
                                      file=_STDERR_COPY)


@pytest.fixture(scope="module", autouse=True)
def hang_report_module(pytestconfig):
    """Armed before the file's first module fixture is built, stopped after
    its last one is torn down."""
    _arm(pytestconfig)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(autouse=True)
def hang_report(hang_report_module, pytestconfig):
    """The clock starts again as each test starts, and runs on through its
    teardown into the next test's set-up, so that a module fixture that only
    a later test asks for is timed too."""
    _arm(pytestconfig)
