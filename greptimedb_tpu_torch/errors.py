"""The error classes the port raises (copies of greptimedb_tpu.errors).

Every error carries a wire status code (`status_code`, the JAX package's
StatusCode); the HTTP server maps the overload and deadline codes to 429
and 503, every other error to 400.
"""

import enum


class StatusCode(enum.IntEnum):
    SUCCESS = 0
    UNKNOWN = 1000
    UNSUPPORTED = 1001
    UNEXPECTED = 1002
    INTERNAL = 1003
    INVALID_ARGUMENTS = 1004
    CANCELLED = 1005
    ILLEGAL_STATE = 1006

    INVALID_SYNTAX = 2000
    PLAN_QUERY = 3000
    ENGINE_EXECUTE_QUERY = 3001

    TABLE_ALREADY_EXISTS = 4000
    TABLE_NOT_FOUND = 4001
    TABLE_COLUMN_NOT_FOUND = 4002
    TABLE_COLUMN_EXISTS = 4003
    DATABASE_NOT_FOUND = 4004
    REGION_NOT_FOUND = 4005
    REGION_ALREADY_EXISTS = 4006
    REGION_READONLY = 4007
    DATABASE_ALREADY_EXISTS = 4010

    STORAGE_UNAVAILABLE = 5000
    REQUEST_OUTDATED = 5001

    RUNTIME_RESOURCES_EXHAUSTED = 6000
    RATE_LIMITED = 6001
    QUERY_OVERLOADED = 6002
    QUERY_QUEUE_TIMEOUT = 6003
    DEADLINE_EXCEEDED = 6004

    USER_NOT_FOUND = 7000
    UNSUPPORTED_PASSWORD_TYPE = 7001
    USER_PASSWORD_MISMATCH = 7002
    AUTH_HEADER_NOT_FOUND = 7003
    INVALID_AUTH_HEADER = 7004
    ACCESS_DENIED = 7005
    PERMISSION_DENIED = 7006

    FLOW_ALREADY_EXISTS = 8000
    FLOW_NOT_FOUND = 8001


class GreptimeError(Exception):
    """Base error."""

    status_code: StatusCode = StatusCode.INTERNAL


class CompactionError(GreptimeError):
    """A device merge diverged from the host reference merge."""


class UnsupportedError(GreptimeError):
    """A query shape or option the port does not run yet."""


class InvalidSyntaxError(GreptimeError):
    """A query text that does not parse."""


class PlanError(GreptimeError):
    """A query that parses but cannot be planned."""


class ExecutionError(GreptimeError):
    """A planned query that fails while it runs."""


class ArithmeticOverflowError(ExecutionError):
    """An exact integer aggregate (SUM over BIGINT/UINT64) exceeds the
    int64 result range; raised instead of silently wrapping."""


class TableNotFoundError(GreptimeError):
    """A table or field that does not exist."""


class ColumnNotFoundError(GreptimeError):
    """A column an expression names that its source does not hold."""


class SstRestoreError(GreptimeError):
    """An SST object named by the manifest is missing, torn or corrupt
    when a region restores it."""


class RegionReadonlyError(GreptimeError):
    """A write to a region that is not writable."""


class RegionNotFoundError(GreptimeError):
    """A region id the engine has not opened."""


class TableAlreadyExistsError(GreptimeError):
    """CREATE of a table name that is taken."""


class InvalidArgumentError(GreptimeError):
    """A request argument (an option, a value, a name) that is not
    valid."""


class DatabaseNotFoundError(GreptimeError):
    """A database that does not exist."""


class IllegalStateError(GreptimeError):
    """An object used in a state that does not allow it (a table whose
    open failed)."""


class FlowNotFoundError(GreptimeError):
    """A flow name that does not exist (DROP FLOW, ADMIN flush_flow)."""


class FlowAlreadyExistsError(GreptimeError):
    """CREATE FLOW of a flow name that is taken."""


class OverloadedError(GreptimeError):
    """Base of the overload errors: the node sheds load instead of
    queueing without bound (HTTP 429/503, never a hang)."""

    status_code = StatusCode.RATE_LIMITED


class QueryOverloadedError(OverloadedError):
    """Admission control shed the query at the door: the tenant is over
    its qps quota, or the bounded wait queue is full. Retryable after
    client back-off (HTTP 429)."""

    status_code = StatusCode.QUERY_OVERLOADED


class QueryQueueTimeoutError(OverloadedError):
    """The query waited in the admission queue past the queue-time SLO
    without an execution slot freeing: the instance is saturated (HTTP
    503)."""

    status_code = StatusCode.QUERY_QUEUE_TIMEOUT


class QueryDeadlineExceededError(GreptimeError):
    """The query's absolute deadline lapsed, in the admission queue or at
    a cooperative checkpoint (HTTP 503)."""

    status_code = StatusCode.DEADLINE_EXCEEDED
