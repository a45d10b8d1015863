"""Cooperative statement cancellation (the JAX package's cancellation.py).

A kill cannot stop a CUDA kernel in flight, so a running statement polls
`checkpoint()` at stage boundaries (the start of each table scan) and
raises there: for a kill through the installed check, for a lapsed
deadline (sched/deadline.py) through QueryDeadlineExceededError. Both
are context variables: they hold in the thread that runs the statement,
and in no other.
"""

from __future__ import annotations

import contextvars

from greptimedb_tpu_torch.sched import deadline as _deadline

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
    was killed, or QueryDeadlineExceededError if its deadline lapsed.
    Outside a statement it does nothing."""
    fn = _check.get()
    if fn is not None:
        fn()
    _deadline.check()
