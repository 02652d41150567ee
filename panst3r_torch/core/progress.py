"""Progress routing (counterpart of panst3r_tpu/core/progress.py).

A context-local, thread-safe hook, so that a user interface (a web demo)
can take over the progress reports of library code without the library
knowing of it: ``report`` wraps an iterable with the installed handler,
else with tqdm where it is installed, else returns it as it is; ``route``
installs a handler for the duration of a block.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Callable, Iterable, Optional

_handler: contextvars.ContextVar[Optional[Callable]] = \
    contextvars.ContextVar("progress_handler", default=None)
_lock = threading.RLock()


def report(iterable: Iterable, desc: str = "", total: Optional[int] = None):
    """Wrap an iterable; routes to the installed handler or tqdm/no-op."""
    handler = _handler.get()
    if handler is not None:
        return handler(iterable, desc=desc, total=total)
    try:
        from tqdm.auto import tqdm

        return tqdm(iterable, desc=desc, total=total, leave=False)
    except Exception:
        return iterable


@contextlib.contextmanager
def route(handler: Callable):
    """Temporarily install a progress handler (thread/context-safe)."""
    with _lock:
        token = _handler.set(handler)
    try:
        yield
    finally:
        with _lock:
            _handler.reset(token)
