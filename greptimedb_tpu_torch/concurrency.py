"""Concurrency factories: every lock, condition, event, thread and pool the
storage layer creates comes from here.

The JAX package's facade without its sanitizer: each factory returns the
stdlib object (`Lock()` is `threading.Lock()`), and the sanitizer-only
keyword arguments (`name=` on locks and conditions, `shared=` on pools) are
accepted and dropped, as the JAX package's off path drops them.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor as _Executor

__all__ = ["Condition", "Event", "Lock", "RLock", "Thread",
           "ThreadPoolExecutor"]


def Lock(*, name: str | None = None):
    return threading.Lock()


def RLock(*, name: str | None = None):
    return threading.RLock()


def Condition(lock=None, *, name: str | None = None):
    return threading.Condition(lock)


def Event():
    return threading.Event()


def Thread(*args, **kwargs):
    return threading.Thread(*args, **kwargs)


def ThreadPoolExecutor(*args, shared: bool = False, **kwargs):
    return _Executor(*args, **kwargs)
