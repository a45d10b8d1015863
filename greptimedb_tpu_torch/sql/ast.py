"""SQL AST node definitions (statements + expressions)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from greptimedb_tpu_torch.datatypes.types import ConcreteDataType


# ----------------------------------------------------------------------
# expressions
# ----------------------------------------------------------------------

@dataclass
class Expr:
    pass


@dataclass
class Literal(Expr):
    value: Any          # int | float | str | bool | None


@dataclass
class IntervalLit(Expr):
    ms: int
    raw: str


@dataclass
class Column(Expr):
    name: str
    table: str | None = None


@dataclass
class Star(Expr):
    pass


@dataclass
class BinaryOp(Expr):
    op: str             # + - * / % = != < <= > >= and or like
    left: Expr
    right: Expr


@dataclass
class UnaryOp(Expr):
    op: str             # - not
    operand: Expr


@dataclass
class FuncCall(Expr):
    name: str
    args: list[Expr] = field(default_factory=list)
    distinct: bool = False
    order_by: list["OrderItem"] = field(default_factory=list)
    over: "WindowSpec | None" = None   # window function when set
    filter: "Expr | None" = None       # agg FILTER (WHERE ...) clause


@dataclass
class WindowSpec:
    """OVER ([PARTITION BY ...] [ORDER BY ...] [frame]). frame is the
    normalized frame text; None means the SQL default (whole partition
    without ORDER BY, running peer-frame with it)."""

    partition_by: list[Expr] = field(default_factory=list)
    order_by: list["OrderItem"] = field(default_factory=list)
    frame: str | None = None


@dataclass
class RangeFunc(Expr):
    """`agg(x) RANGE '10s' [FILL v]` — per-item range window in a RANGE
    select (reference: src/query/src/range_select/plan.rs RangeFn)."""

    func: "FuncCall"
    range_ms: int
    fill: str | None = None


@dataclass
class Cast(Expr):
    operand: Expr
    to: ConcreteDataType


@dataclass
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class InList(Expr):
    operand: Expr
    items: list[Expr]
    negated: bool = False


@dataclass
class IsNull(Expr):
    operand: Expr
    negated: bool = False


@dataclass
class Case(Expr):
    operand: Optional[Expr]
    whens: list[tuple[Expr, Expr]]
    else_: Optional[Expr]


@dataclass
class ScalarSubquery(Expr):
    """(SELECT ...) used as a scalar value (uncorrelated)."""

    query: "Statement"


@dataclass
class InSubquery(Expr):
    """x [NOT] IN (SELECT ...) (uncorrelated)."""

    operand: Expr
    query: "Statement"
    negated: bool = False


@dataclass
class Exists(Expr):
    """[NOT] EXISTS (SELECT ...) (uncorrelated)."""

    query: "Statement"
    negated: bool = False


# ----------------------------------------------------------------------
# FROM sources
# ----------------------------------------------------------------------

@dataclass
class TableName:
    """A (possibly aliased) base table, CTE, or view reference."""

    name: str
    alias: str | None = None


@dataclass
class SubquerySource:
    """(SELECT ...) AS alias in FROM."""

    query: "Statement"              # Select | SetOp
    alias: str


@dataclass
class JoinSource:
    left: object                    # TableName | SubquerySource | JoinSource
    right: object
    kind: str                       # inner | left | right | full | cross
    on: Expr | None = None
    using: list[str] | None = None


# ----------------------------------------------------------------------
# statements
# ----------------------------------------------------------------------

@dataclass
class Statement:
    pass


@dataclass
class ColumnDef:
    name: str
    data_type: ConcreteDataType
    nullable: bool = True
    default: Any = None
    primary_key: bool = False
    time_index: bool = False
    fulltext: bool = False


@dataclass
class CreateTable(Statement):
    name: str
    columns: list[ColumnDef]
    time_index: str | None
    primary_keys: list[str]
    if_not_exists: bool = False
    engine: str = "mito"
    options: dict = field(default_factory=dict)
    partitions: list[Expr] = field(default_factory=list)
    partition_columns: list[str] = field(default_factory=list)
    like_table: str | None = None   # CREATE TABLE t LIKE source


@dataclass
class CreateDatabase(Statement):
    name: str
    if_not_exists: bool = False


@dataclass
class DropTable(Statement):
    names: list[str]
    if_exists: bool = False


@dataclass
class DropDatabase(Statement):
    name: str
    if_exists: bool = False


@dataclass
class TruncateTable(Statement):
    name: str


@dataclass
class AlterTable(Statement):
    name: str
    action: str                     # add_column | drop_column | rename
    column: ColumnDef | None = None
    old_name: str | None = None
    new_name: str | None = None


@dataclass
class Insert(Statement):
    table: str
    columns: list[str]
    values: list[list[Expr]]
    select: Optional["Select"] = None


@dataclass
class Delete(Statement):
    table: str
    where: Expr | None


@dataclass
class OrderItem:
    expr: Expr
    asc: bool = True
    nulls_first: bool | None = None


@dataclass
class SelectItem:
    expr: Expr
    alias: str | None = None


@dataclass
class RangeClause:
    """GreptimeDB RANGE query: ALIGN <interval> [TO ...] [BY (...)] [FILL ...]"""

    align_ms: int
    to: str | None = None
    by: list[Expr] | None = None
    fill: str | None = None


@dataclass
class Select(Statement):
    items: list[SelectItem]
    from_table: str | None = None   # set when FROM is one plain table
    where: Expr | None = None
    group_by: list[Expr] = field(default_factory=list)
    having: Expr | None = None
    order_by: list[OrderItem] = field(default_factory=list)
    limit: int | None = None
    offset: int | None = None
    range_clause: RangeClause | None = None
    distinct: bool = False
    source: object | None = None    # TableName | SubquerySource | JoinSource
    ctes: list[tuple[str, "Statement"]] = field(default_factory=list)


@dataclass
class SetOp(Statement):
    """UNION / INTERSECT / EXCEPT compound select. Trailing ORDER BY /
    LIMIT apply to the combined result."""

    op: str                         # union | intersect | except
    all: bool
    left: Statement                 # Select | SetOp
    right: Statement
    order_by: list[OrderItem] = field(default_factory=list)
    limit: int | None = None
    offset: int | None = None
    ctes: list[tuple[str, "Statement"]] = field(default_factory=list)


@dataclass
class Use(Statement):
    database: str


@dataclass
class ShowDatabases(Statement):
    like: str | None = None


@dataclass
class ShowTables(Statement):
    like: str | None = None
    database: str | None = None
    full: bool = False


@dataclass
class ShowCreateTable(Statement):
    name: str


@dataclass
class ShowFlows(Statement):
    pass


@dataclass
class ShowViews(Statement):
    pass


@dataclass
class ShowCreateView(Statement):
    name: str


@dataclass
class ShowCreateFlow(Statement):
    name: str


@dataclass
class DescribeTable(Statement):
    name: str


@dataclass
class Explain(Statement):
    statement: Statement
    analyze: bool = False


@dataclass
class Tql(Statement):
    """TQL EVAL (start, end, step) <promql> | TQL ANALYZE ... | TQL EXPLAIN"""

    kind: str                       # eval | explain | analyze
    start: Expr
    end: Expr
    step: Expr
    query: str
    lookback: Expr | None = None


@dataclass
class CreateFlow(Statement):
    name: str
    sink_table: str
    query: Select
    if_not_exists: bool = False
    expire_after_s: int | None = None
    comment: str | None = None


@dataclass
class DropFlow(Statement):
    name: str
    if_exists: bool = False


@dataclass
class CreateView(Statement):
    name: str
    query: Statement                # Select | SetOp
    or_replace: bool = False
    text: str | None = None         # raw SQL of the query (persisted)


@dataclass
class DropView(Statement):
    name: str
    if_exists: bool = False


@dataclass
class Copy(Statement):
    table: str
    direction: str                  # to | from
    path: str
    format: str = "parquet"
    options: dict = field(default_factory=dict)


@dataclass
class Admin(Statement):
    """ADMIN func(args...) — maintenance functions callable from SQL
    (reference: src/sql/src/statements/admin.rs + the admin function set
    in src/common/function/src/{flush_flow,system}/)."""

    func: str
    args: list[Expr] = field(default_factory=list)


@dataclass
class SetVariable(Statement):
    """SET [SESSION|GLOBAL] name = value [, name = value ...]
    (reference: src/operator/src/statement/set.rs)."""

    assignments: list  # list[tuple[str, Expr]]
    scope: str = "session"


@dataclass
class ShowVariables(Statement):
    name: str | None = None         # SHOW VARIABLES LIKE 'x' / SHOW VARIABLES
    like: str | None = None


@dataclass
class ShowColumns(Statement):
    table: str
    database: str | None = None
    like: str | None = None
    full: bool = False


@dataclass
class ShowIndex(Statement):
    table: str
    database: str | None = None


@dataclass
class ShowStatus(Statement):
    pass


@dataclass
class ShowCharset(Statement):
    pass


@dataclass
class ShowCollation(Statement):
    pass


@dataclass
class ShowProcesslist(Statement):
    full: bool = False


@dataclass
class Prepare(Statement):
    """PREPARE name FROM '<sql>' (MySQL) | PREPARE name AS <stmt> (PG).
    The statement text is stored per-session with ?/$n placeholders."""

    name: str
    sql_text: str


@dataclass
class Execute(Statement):
    """EXECUTE name [(args...)] | EXECUTE name USING args..."""

    name: str
    args: list[Expr] = field(default_factory=list)


@dataclass
class Deallocate(Statement):
    name: str
