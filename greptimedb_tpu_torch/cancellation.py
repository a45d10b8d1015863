"""Cooperative statement cancellation (the JAX package's cancellation.py).

A kill cannot stop a CUDA kernel in flight, so a running statement polls
`checkpoint()` at stage boundaries (the start of each table scan) and
raises there. The check is a context variable: it holds in the thread
that runs the statement, and in no other.
"""

from __future__ import annotations

import contextvars

_check: contextvars.ContextVar = contextvars.ContextVar(
    "statement_cancel_check", default=None)


def set_check(fn):
    """Install a zero-argument callable that raises if the statement was
    killed. Returns a token for `reset`."""
    return _check.set(fn)


def reset(token):
    _check.reset(token)


def checkpoint():
    """Raise (through the installed callable) if the current statement
    was killed. Outside a statement it does nothing."""
    fn = _check.get()
    if fn is not None:
        fn()
    # the statement's deadline check (sched/deadline.py) comes with
    # ROADMAP A4, admission; without a deadline it does nothing
