"""Keeps pytest workers small: each time a worker that holds more than
``LIMIT`` bytes leaves a test file, it drops JAX's compiled executables,
collects garbage and hands freed heap back to the operating system.

A worker runs many files in one process and otherwise keeps every file's
executables and freed heap to the end, growing by gigabytes.  The suite's
largest test (the multi-chip dry run in tests/test_sharding.py) needs most
of the host's memory, so the other workers must stay small while it runs.
Below ``LIMIT`` a worker keeps its executables, so that a file it comes
back to need not compile them again.

The port's test files import ``release_memory``; the first one a worker
runs registers the hook, which then serves every file the worker runs.
"""
import ctypes
import ctypes.util
import gc
import os

import pytest

_NAME = "tests.torch_release"
LIMIT = 3 << 29  # 1.5 GiB resident


def _resident_bytes():
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError):
        return LIMIT + 1  # cannot tell: release


def _malloc_trim():
    try:
        ctypes.CDLL(ctypes.util.find_library("c")).malloc_trim(0)
    except (OSError, AttributeError, TypeError):
        pass  # not glibc: nothing to hand back


def release():
    import jax

    jax.clear_caches()
    gc.collect()
    _malloc_trim()


class _ReleaseBetweenFiles:
    @pytest.hookimpl(trylast=True)
    def pytest_runtest_teardown(self, item, nextitem):
        module = getattr(item, "module", None)
        if (nextitem is None
                or getattr(nextitem, "module", None) is not module) \
                and _resident_bytes() > LIMIT:
            release()


@pytest.fixture(autouse=True, scope="module")
def release_memory(request):
    plugins = request.config.pluginmanager
    if not plugins.has_plugin(_NAME):
        plugins.register(_ReleaseBetweenFiles(), _NAME)
