"""Per-request query context (the JAX package's session.QueryContext):
the current database, the wire it came in on, the user and per-statement
extensions. `USE` changes `database` for the rest of a session."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class QueryContext:
    database: str = "public"
    channel: str = "http"
    username: str = ""
    extensions: dict = field(default_factory=dict)
