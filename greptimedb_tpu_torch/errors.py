"""The error classes the port raises (copies of greptimedb_tpu.errors)."""


class GreptimeError(Exception):
    """Base error."""


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
