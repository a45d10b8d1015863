"""Per-request query context (the JAX package's session.QueryContext):
the current database, the session's time zone, the wire it came in on,
the user, per-statement extensions and the variables SET gives it. `USE`
changes `database` for the rest of a session, `SET time_zone` its
`timezone`."""

from __future__ import annotations

from dataclasses import dataclass, field

#: the process-wide time zone new sessions start in; `SET time_zone`
#: overrides it per session
_DEFAULT_TIMEZONE = "UTC"


def set_default_timezone(tz: str) -> None:
    """The `default_timezone` setting: new QueryContexts and the SHOW
    VARIABLES defaults report `tz` until a session overrides it."""
    global _DEFAULT_TIMEZONE
    tz = tz or "UTC"
    _DEFAULT_TIMEZONE = tz
    DEFAULT_VARIABLES["time_zone"] = tz
    DEFAULT_VARIABLES["system_time_zone"] = tz


def default_timezone() -> str:
    return _DEFAULT_TIMEZONE


@dataclass
class QueryContext:
    database: str = "public"
    timezone: str = field(default_factory=lambda: _DEFAULT_TIMEZONE)
    channel: str = "http"
    username: str = ""
    extensions: dict = field(default_factory=dict)
    # session variables SET gives; SHOW VARIABLES reads them back
    variables: dict = field(default_factory=dict)


#: server defaults SHOW VARIABLES reports where the session has not
#: overridden them (the MySQL names clients probe on connect)
DEFAULT_VARIABLES = {
    "version": "8.4.2-greptimedb-tpu",
    "version_comment": "GreptimeDB-TPU",
    "sql_mode": "ANSI",
    "time_zone": "UTC",
    "system_time_zone": "UTC",
    "max_allowed_packet": "16777216",
    "max_execution_time": "0",
    "autocommit": "ON",
    "character_set_client": "utf8mb4",
    "character_set_results": "utf8mb4",
    "character_set_connection": "utf8mb4",
    "collation_connection": "utf8mb4_bin",
    "transaction_isolation": "REPEATABLE-READ",
    "wait_timeout": "28800",
    "interactive_timeout": "28800",
    "net_write_timeout": "60",
    "lower_case_table_names": "0",
    "datestyle": "ISO, MDY",
    "client_encoding": "UTF8",
    "read_timeout": "0",
}
