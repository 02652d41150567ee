"""Keeps pytest workers from crowding each other: each worker's torch
takes its share of the cores, and workers stay small while the suite's
largest test runs.

Cores: pytest-xdist runs several workers on one host, and torch's
intra-op pool takes every core in each of them; the pools' threads then
wait on each other's descheduled threads (the port's test files ran 2.3
times slower under ``-n 6`` on 8 cores than with one thread a worker).
Under xdist each worker's torch takes ``cpu_count // workers`` threads,
and the session's workers share one JAX persistent compilation cache
(``share_work``, at import): many files compile the same programs (the
tiny presets' engines, the train steps), and a worker that released its
executables reads them back instead of compiling them again.  The cache
is a directory of the temporary directory named after the session's
controller process, so each session starts cold.

Memory:

The multi-chip dry run (``HEAVY``: tests/test_sharding.py) needs most of
the host's memory for a few minutes (47.6 GB resident on a 62 GB host).
A worker runs many files in one process and keeps every file's JAX
executables and freed heap, growing by gigabytes, so the other workers
must be small while the dry run is in flight.  Releasing (JAX's compiled
executables, garbage, freed heap handed back to the operating system)
takes seconds, and a file that comes back to a released program compiles
it again, so a worker releases only when that is needed:

- ``HEAVY`` tests run first (the hook moves them to the front of every
  worker's collection, so the scheduler hands them out first): the other
  workers are then fresh, and none is deep in a long test whose file it
  cannot leave;
- a worker about to run a ``HEAVY`` test releases first, and raises a
  flag (a file named after the pytest session's controller process) for
  as long as that test runs;
- leaving a test file, a worker holding more than ``LIMIT`` releases
  while the flag is up or while the host has less than ``LOW_AVAILABLE``
  available, and a worker holding more than ``HIGH`` releases always.

Every worker imports the port's test files while it collects, and the
first import registers the hook (``_register``, from the collecting
pytest's config), so the hook serves every file from the first test on.
Under xdist that import raises when it finds no config: a hook
registered later would miss the reordering.  Outside xdist the
``release_memory`` fixture the port's test files import registers it.

Each worker holds a file in the session's ``workers`` directory while it
runs; the last worker to finish removes that directory, the compilation
cache and the flag.
"""
import ctypes
import ctypes.util
import gc
import os
import shutil
import sys
import tempfile

import pytest
import torch

_NAME = "tests.torch_release"
HEAVY = ("tests/test_sharding.py::test_dryrun_multichip_entry",)
LIMIT = 3 << 29            # 1.5 GiB resident: released while memory is short
HIGH = 6 << 30             # 6 GiB resident: released at any file boundary
LOW_AVAILABLE = 16 << 30   # the host is short below this much available


def _session_path(name: str) -> str:
    """A path in the temporary directory shared by the workers of one
    session (each worker's parent is the session's controller)."""
    return os.path.join(tempfile.gettempdir(),
                        f"panst3r-{name}-{os.getppid()}")


def share_work() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if not workers:
        return
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.config.update("jax_compilation_cache_dir",
                          _session_path("jax-cache"))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)


def _resident_bytes():
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError):
        return HIGH + 1  # cannot tell: release


def _available_bytes():
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) << 10
    except (OSError, ValueError):
        pass
    return 0  # cannot tell: short


def _flag():
    """The heavy-test flag shared by the workers of one session."""
    return _session_path("heavy-test")


def _malloc_trim():
    try:
        ctypes.CDLL(ctypes.util.find_library("c")).malloc_trim(0)
    except (OSError, AttributeError, TypeError):
        pass  # not glibc: nothing to hand back


def release():
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
    gc.collect()
    _malloc_trim()


def _memory_short() -> bool:
    return os.path.exists(_flag()) or _available_bytes() < LOW_AVAILABLE


def _worker_file():
    worker = os.environ.get("PYTEST_XDIST_WORKER")
    return worker and os.path.join(_session_path("workers"), worker)


class _ReleaseBetweenFiles:
    def __init__(self):
        path = _worker_file()
        if path:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            open(path, "w").close()

    def pytest_sessionfinish(self):
        """The last worker to finish removes the session's files."""
        path = _worker_file()
        if not path:
            return
        os.remove(path)
        try:
            if os.listdir(os.path.dirname(path)):
                return
        except FileNotFoundError:
            return              # another last worker got there first
        for name in ("workers", "jax-cache"):
            shutil.rmtree(_session_path(name), ignore_errors=True)
        try:
            os.remove(_flag())
        except FileNotFoundError:
            pass

    def pytest_collection_modifyitems(self, items):
        items.sort(key=lambda item: item.nodeid not in HEAVY)

    @pytest.hookimpl(tryfirst=True)
    def pytest_runtest_setup(self, item):
        if item.nodeid in HEAVY:
            release()
            with open(_flag(), "w"):
                pass

    @pytest.hookimpl(trylast=True)
    def pytest_runtest_teardown(self, item, nextitem):
        if item.nodeid in HEAVY:
            try:
                os.remove(_flag())
            except FileNotFoundError:
                pass
        module = getattr(item, "module", None)
        if nextitem is not None \
                and getattr(nextitem, "module", None) is module:
            return
        rss = _resident_bytes()
        if rss > HIGH or (rss > LIMIT and _memory_short()):
            release()


def _register(config) -> None:
    plugins = config.pluginmanager
    if not plugins.has_plugin(_NAME):
        plugins.register(_ReleaseBetweenFiles(), _NAME)


def _collecting_config():
    """The config of the pytest run importing this module, if any (a
    ``config`` local of a frame up the stack)."""
    frame = sys._getframe(1)
    while frame is not None:
        config = frame.f_locals.get("config")
        if hasattr(config, "pluginmanager"):
            return config
        frame = frame.f_back
    return None


@pytest.fixture(autouse=True, scope="module")
def release_memory(request):
    _register(request.config)


share_work()
_config = _collecting_config()
if _config is not None:
    _register(_config)
elif os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    raise RuntimeError(f"{_NAME}: imported by a pytest-xdist worker with no "
                       f"pytest config up the stack; the hook that runs "
                       f"{HEAVY} first cannot register in time")
