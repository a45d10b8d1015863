"""Pluggable user authentication (the JAX package's auth.py).

The HTTP server asks a provider for the Basic-auth credentials of every
request when one is configured: `StaticUserProvider` holds `user=pwd`
pairs (plain or `sha256:<hex>`), `WatchFileUserProvider` reloads them
from a file when its mtime changes. The authenticated user becomes the
statement's tenant (sched/admission.tenant_of). The JAX package's
`plain_password` (the MySQL handshake's, ROADMAP A3) and
`StaticUserProvider.from_option` (the command line's, A10) wait for
their callers.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os

from greptimedb_tpu_torch import concurrency
from greptimedb_tpu_torch.errors import GreptimeError, StatusCode


class AccessDeniedError(GreptimeError):
    """Missing, malformed or wrong credentials (HTTP 401)."""

    status_code = StatusCode.ACCESS_DENIED


class UserProvider:
    def authenticate(self, username: str, password: str) -> bool:
        raise NotImplementedError


class StaticUserProvider(UserProvider):
    """`user=pwd` pairs; a value is plain or `sha256:<hex>`."""

    def __init__(self, users: dict[str, str]):
        self._users = dict(users)

    def authenticate(self, username: str, password: str) -> bool:
        want = self._users.get(username)
        if want is None:
            return False
        if want.startswith("sha256:"):
            return hmac.compare_digest(
                hashlib.sha256(password.encode()).hexdigest().encode(),
                want[len("sha256:"):].encode())
        return hmac.compare_digest(password.encode(), want.encode())


class WatchFileUserProvider(UserProvider):
    """`user=pwd` lines of a file (`#` comments), reloaded when the file's
    mtime changes."""

    def __init__(self, path: str):
        self.path = path
        self._mtime = 0.0
        self._inner = StaticUserProvider({})
        self._lock = concurrency.Lock()
        self._maybe_reload()

    def _maybe_reload(self):
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            return
        with self._lock:
            if mtime == self._mtime:
                return
            users = {}
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith("#"):
                        k, _, v = line.partition("=")
                        users[k.strip()] = v.strip()
            self._inner = StaticUserProvider(users)
            self._mtime = mtime

    def authenticate(self, username: str, password: str) -> bool:
        self._maybe_reload()
        return self._inner.authenticate(username, password)


def check_basic_auth(header: str | None, provider: UserProvider | None
                     ) -> str | None:
    """The authenticated user name (None when no provider is configured);
    AccessDeniedError for missing, malformed or wrong credentials."""
    if provider is None:
        return None
    if not header or not header.startswith("Basic "):
        raise AccessDeniedError("missing Authorization header")
    try:
        raw = base64.b64decode(header[len("Basic "):]).decode()
        user, _, pwd = raw.partition(":")
    except Exception:  # noqa: BLE001 - any decode failure is malformed
        raise AccessDeniedError("malformed Authorization header") from None
    if not provider.authenticate(user, pwd):
        raise AccessDeniedError(f"invalid credentials for {user!r}")
    return user
