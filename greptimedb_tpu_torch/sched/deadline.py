"""End-to-end query deadlines (the JAX package's sched/deadline.py).

An admitted query carries an absolute deadline on the monotonic clock
(the wall clock jumps with NTP slews), bound into a context variable for
the statement's lifetime, so every `cancellation.checkpoint()` on the
execution path raises the typed `QueryDeadlineExceededError` once it
lapses. A kernel in flight is not interrupted: the check lands at the
next checkpoint (each table scan).
"""

from __future__ import annotations

import contextvars
import math
import time

from greptimedb_tpu_torch.errors import QueryDeadlineExceededError

_current: contextvars.ContextVar = contextvars.ContextVar(
    "query_deadline", default=None)


class Deadline:
    """Absolute monotonic deadline for one query."""

    __slots__ = ("at",)

    def __init__(self, timeout_s: float):
        self.at = time.monotonic() + float(timeout_s)

    @classmethod
    def from_timeout(cls, timeout_s) -> "Deadline | None":
        """None, <= 0 or a non-finite timeout means no deadline (nan or
        inf would make the arithmetic of `at` nonsense); the protocol
        edges refuse them as client errors before they get here."""
        if timeout_s is None:
            return None
        t = float(timeout_s)
        if not math.isfinite(t) or t <= 0:
            return None
        return cls(t)

    def remaining(self) -> float:
        return max(0.0, self.at - time.monotonic())

    def expired(self) -> bool:
        return time.monotonic() >= self.at

    def check(self, what: str = "query"):
        if self.expired():
            raise QueryDeadlineExceededError(f"{what} deadline exceeded")


def bind(deadline: Deadline | None):
    """Install `deadline` for the current context; returns a token for
    `reset`. Binding None clears an inherited deadline."""
    return _current.set(deadline)


def reset(token):
    _current.reset(token)


def current() -> Deadline | None:
    return _current.get()


def remaining() -> float | None:
    """Seconds left on the active deadline; None when unbounded."""
    d = _current.get()
    return None if d is None else d.remaining()


def call_timeout(cap_s: float | None = None) -> float | None:
    """A timeout derived from the active deadline, optionally capped:
    min(remaining, cap). None when nothing bounds it."""
    r = remaining()
    if r is None:
        return cap_s
    return r if cap_s is None else min(r, cap_s)


def check(what: str = "query"):
    """Raise QueryDeadlineExceededError when the active deadline has
    lapsed; nothing when unbounded. Every cancellation.checkpoint()
    calls it."""
    d = _current.get()
    if d is not None:
        d.check(what)
