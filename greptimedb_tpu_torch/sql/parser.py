"""Recursive-descent SQL parser over sql.lexer tokens.

A copy of the JAX package's sql/parser.py. Statement surface mirrors
GreptimeDB's dialect (src/sql/src/parser.rs and statements/ upstream):
CREATE TABLE with TIME INDEX + PRIMARY KEY tag semantics, RANGE queries
via ALIGN, TQL, flows, views, COPY, SHOW/DESCRIBE/EXPLAIN, USE, and the
DML core.
"""

from __future__ import annotations

import re

from greptimedb_tpu_torch.datatypes.types import ConcreteDataType
from greptimedb_tpu_torch.errors import InvalidSyntaxError
from greptimedb_tpu_torch.sql import ast as A
from greptimedb_tpu_torch.sql.lexer import Tok, Token, tokenize

_INTERVAL_RE = re.compile(
    r"^\s*(-?\s*\d+(?:\.\d+)?)\s*(nanosecond|microsecond|millisecond|second|minute|"
    r"hour|day|week|month|year|ns|us|ms|s|m|h|d|w|y)s?\s*$",
    re.IGNORECASE,
)

_UNIT_MS = {
    "nanosecond": 1e-6, "ns": 1e-6,
    "microsecond": 1e-3, "us": 1e-3,
    "millisecond": 1.0, "ms": 1.0,
    "second": 1000.0, "s": 1000.0,
    "minute": 60_000.0, "m": 60_000.0,
    "hour": 3_600_000.0, "h": 3_600_000.0,
    "day": 86_400_000.0, "d": 86_400_000.0,
    "week": 604_800_000.0, "w": 604_800_000.0,
    "month": 2_592_000_000.0, "year": 31_536_000_000.0, "y": 31_536_000_000.0,
}


def parse_interval_ms(text: str) -> int:
    """'5 minutes', '1h', '30s', also compound '1 hour 30 minutes';
    per-part signs carry through ('-1 day' < 0, '1 day -1 hour'),
    including a space-separated sign ('- 1 day')."""
    total = 0.0
    parts = re.findall(
        r"(-?\s*\d+(?:\.\d+)?)\s*([a-zA-Z]+)", text
    )
    if not parts:
        raise InvalidSyntaxError(f"bad interval: {text!r}")
    parts = [(num.replace(" ", ""), unit) for num, unit in parts]
    for num, unit in parts:
        unit = unit.lower().rstrip("s") if unit.lower() not in ("s", "ns", "us", "ms") else unit.lower()
        if unit not in _UNIT_MS:
            unit2 = unit + "s" if unit + "s" in _UNIT_MS else None
            if unit2 is None:
                raise InvalidSyntaxError(f"bad interval unit: {unit!r}")
            unit = unit2
        total += float(num) * _UNIT_MS[unit]
    return int(total)


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0

    # ---- token helpers ------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != Tok.EOF:
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == Tok.IDENT and t.upper in kws

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str):
        if not self.eat_kw(kw):
            raise InvalidSyntaxError(
                f"expected {kw} at {self.peek().pos}: got {self.peek().text!r}"
            )

    def at_op(self, op: str) -> bool:
        t = self.peek()
        return t.kind == Tok.OP and t.text == op

    def eat_op(self, op: str) -> bool:
        if self.at_op(op):
            self.next()
            return True
        return False

    def expect_op(self, op: str):
        if not self.eat_op(op):
            raise InvalidSyntaxError(
                f"expected {op!r} at {self.peek().pos}: got {self.peek().text!r}"
            )

    def ident(self) -> str:
        t = self.next()
        if t.kind not in (Tok.IDENT, Tok.QIDENT):
            raise InvalidSyntaxError(f"expected identifier at {t.pos}")
        return t.text

    def qualified_name(self) -> str:
        parts = [self.ident()]
        while self.eat_op("."):
            parts.append(self.ident())
        return ".".join(parts)

    # ---- entry --------------------------------------------------------
    @staticmethod
    def parse_sql(sql: str) -> list[A.Statement]:
        p = Parser(sql)
        stmts = []
        while p.peek().kind != Tok.EOF:
            stmts.append(p.statement())
            while p.eat_op(";"):
                pass
        return stmts

    def statement(self) -> A.Statement:
        t = self.peek()
        if t.kind != Tok.IDENT:
            raise InvalidSyntaxError(f"expected statement at {t.pos}")
        kw = t.upper
        if kw in ("SELECT", "WITH"):
            return self.select_or_setop()
        if kw == "CREATE":
            return self.create()
        if kw == "DROP":
            return self.drop()
        if kw == "INSERT":
            return self.insert()
        if kw == "DELETE":
            return self.delete()
        if kw == "SHOW":
            return self.show()
        if kw in ("DESCRIBE", "DESC"):
            self.next()
            self.eat_kw("TABLE")
            return A.DescribeTable(self.qualified_name())
        if kw == "EXPLAIN":
            self.next()
            analyze = self.eat_kw("ANALYZE")
            self.eat_kw("VERBOSE")
            return A.Explain(self.statement(), analyze=analyze)
        if kw == "USE":
            self.next()
            return A.Use(self.ident())
        if kw == "TQL":
            return self.tql()
        if kw == "ALTER":
            return self.alter()
        if kw == "TRUNCATE":
            self.next()
            self.eat_kw("TABLE")
            return A.TruncateTable(self.qualified_name())
        if kw == "COPY":
            return self.copy()
        if kw == "ADMIN":
            return self.admin()
        if kw == "SET":
            return self.set_variable()
        if kw == "KILL":
            self.next()
            # MySQL: KILL [QUERY | CONNECTION] <id>
            if self.at_kw("QUERY") or self.at_kw("CONNECTION"):
                self.next()
            return A.Admin("kill", [self.expr()])
        if kw == "PREPARE":
            return self.prepare()
        if kw == "EXECUTE":
            return self.execute_stmt()
        if kw == "DEALLOCATE":
            self.next()
            self.eat_kw("PREPARE")
            if self.at_kw("ALL"):
                self.next()
                return A.Deallocate("all")
            return A.Deallocate(self.ident())
        raise InvalidSyntaxError(f"unsupported statement {t.text!r} at {t.pos}")

    def prepare(self) -> A.Statement:
        self.expect_kw("PREPARE")
        name = self.ident()
        if self.eat_kw("FROM"):
            t = self.next()
            if t.kind != Tok.STRING:
                raise InvalidSyntaxError(
                    f"PREPARE ... FROM expects a string at {t.pos}"
                )
            return A.Prepare(name, t.text)
        self.expect_kw("AS")
        start = self.peek().pos
        while self.peek().kind != Tok.EOF and not self.at_op(";"):
            self.next()
        t = self.peek()
        end = t.pos if t.kind != Tok.EOF else len(self.sql)
        text = self.sql[start:end].strip()
        if not text:
            raise InvalidSyntaxError("empty PREPARE body")
        return A.Prepare(name, text)

    def execute_stmt(self) -> A.Statement:
        self.expect_kw("EXECUTE")
        name = self.ident()
        args: list[A.Expr] = []
        if self.eat_op("("):
            if not self.eat_op(")"):
                while True:
                    args.append(self.expr())
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
        elif self.eat_kw("USING"):
            while True:
                args.append(self.expr())
                if not self.eat_op(","):
                    break
        return A.Execute(name, args)

    def admin(self) -> A.Statement:
        self.expect_kw("ADMIN")
        func = self.ident()
        args: list[A.Expr] = []
        if self.eat_op("("):
            if not self.eat_op(")"):
                while True:
                    args.append(self.expr())
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
        return A.Admin(func.lower(), args)

    def set_variable(self) -> A.Statement:
        self.expect_kw("SET")
        scope = "session"
        if self.eat_kw("SESSION"):
            scope = "session"
        elif self.eat_kw("GLOBAL"):
            scope = "global"
        elif self.eat_kw("LOCAL"):
            scope = "session"
        name = self.ident()
        # postgres `SET TIME ZONE 'x'`
        if name.upper() == "TIME" and self.at_kw("ZONE"):
            self.next()
            return A.SetVariable([("time_zone", self._set_value())], scope)
        # `SET NAMES <charset> [COLLATE <collation>]`
        if name.upper() == "NAMES" and not self.at_op("="):
            charset = self._set_value()
            assignments = [("names", charset)]
            if self.eat_kw("COLLATE"):
                assignments.append(
                    ("collation_connection", self._set_value())
                )
            return A.SetVariable(assignments, scope)
        # `SET [SESSION|GLOBAL] TRANSACTION ISOLATION LEVEL <levels>` /
        # `SET TRANSACTION READ ONLY|WRITE`
        if name.upper() == "TRANSACTION" and not self.at_op("="):
            assignments = []
            while True:
                if self.eat_kw("ISOLATION"):
                    self.expect_kw("LEVEL")
                    first = self.ident().upper()
                    # each level's word count is fixed; a greedy loop
                    # would eat the READ of a following "READ ONLY"
                    if first == "READ":
                        words = [first, self.ident().upper()]
                    elif first == "REPEATABLE":
                        self.expect_kw("READ")
                        words = [first, "READ"]
                    else:  # SERIALIZABLE
                        words = [first]
                    assignments.append((
                        "transaction_isolation", A.Literal("-".join(words)),
                    ))
                elif self.eat_kw("READ"):
                    mode = self.ident().upper()  # ONLY | WRITE
                    assignments.append(
                        ("transaction_read_only",
                         A.Literal("ON" if mode == "ONLY" else "OFF"))
                    )
                else:
                    break
                # clauses may be comma-separated (MySQL) or juxtaposed
                # (postgres: "... SERIALIZABLE READ ONLY")
                self.eat_op(",")
            if not assignments:
                raise InvalidSyntaxError(
                    f"expected ISOLATION or READ at {self.peek().pos}"
                )
            return A.SetVariable(assignments, scope)
        assignments = []
        while True:
            if not self.eat_op("="):
                self.eat_kw("TO")
            assignments.append((name.lower(), self._set_value()))
            if not self.eat_op(","):
                break
            name = self.ident()
        return A.SetVariable(assignments, scope)

    def _set_value(self) -> A.Expr:
        """A SET value: bare identifiers are string values, not column
        references (MySQL `SET NAMES utf8mb4`, `SET sql_mode = ANSI`)."""
        t = self.peek()
        if t.kind in (Tok.IDENT, Tok.QIDENT) and t.upper not in (
            "TRUE", "FALSE", "NULL", "DEFAULT",
        ):
            nxt = self.peek(1)
            if nxt.kind != Tok.OP or nxt.text in (",", ";"):
                self.next()
                return A.Literal(t.text)
        if self.eat_kw("DEFAULT"):
            return A.Literal("DEFAULT")
        return self.expr()

    # ---- DDL ----------------------------------------------------------
    def create(self) -> A.Statement:
        self.expect_kw("CREATE")
        if self.eat_kw("DATABASE") or self.eat_kw("SCHEMA"):
            ine = self._if_not_exists()
            return A.CreateDatabase(self.ident(), if_not_exists=ine)
        if self.at_kw("OR"):
            self.next()
            self.expect_kw("REPLACE")
            self.expect_kw("VIEW")
            name = self.qualified_name()
            self.expect_kw("AS")
            q, text = self._query_with_text()
            return A.CreateView(name, q, or_replace=True, text=text)
        if self.eat_kw("VIEW"):
            name = self.qualified_name()
            self.expect_kw("AS")
            q, text = self._query_with_text()
            return A.CreateView(name, q, text=text)
        if self.eat_kw("FLOW"):
            ine = self._if_not_exists()
            name = self.qualified_name()
            self.expect_kw("SINK")
            self.expect_kw("TO")
            sink = self.qualified_name()
            expire = None
            if self.eat_kw("EXPIRE"):
                self.expect_kw("AFTER")
                expire_ms = parse_interval_ms(self._interval_text())
                if expire_ms <= 0:
                    raise InvalidSyntaxError(
                        "EXPIRE AFTER interval must be positive"
                    )
                # ceil so a positive sub-second interval stays positive
                expire = (expire_ms + 999) // 1000
            comment = None
            if self.eat_kw("COMMENT"):
                comment = self.next().text
            self.expect_kw("AS")
            return A.CreateFlow(name, sink, self.select(), if_not_exists=ine,
                                expire_after_s=expire, comment=comment)
        if self.eat_kw("TABLE"):
            return self.create_table()
        if self.eat_kw("EXTERNAL"):
            self.expect_kw("TABLE")
            return self.create_table(external=True)
        raise InvalidSyntaxError(f"unsupported CREATE at {self.peek().pos}")

    def _query_with_text(self) -> tuple[A.Statement, str]:
        """Parse a select/compound and return it with its raw SQL text
        (what the catalog persists for views)."""
        start = self.peek().pos
        q = self.select_or_setop()
        t = self.peek()
        end = t.pos if t.kind != Tok.EOF else len(self.sql)
        return q, self.sql[start:end].strip()

    def _if_not_exists(self) -> bool:
        if self.at_kw("IF"):
            self.next()
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def create_table(self, external: bool = False) -> A.CreateTable:
        ine = self._if_not_exists()
        name = self.qualified_name()
        if self.at_kw("LIKE"):
            self.next()
            src = self.qualified_name()
            return A.CreateTable(
                name, [], None, [], if_not_exists=ine, like_table=src
            )
        columns: list[A.ColumnDef] = []
        time_index: str | None = None
        primary_keys: list[str] = []
        if self.eat_op("("):
            while not self.at_op(")"):
                if self.at_kw("TIME"):
                    self.next()
                    self.expect_kw("INDEX")
                    self.expect_op("(")
                    time_index = self.ident()
                    self.expect_op(")")
                elif self.at_kw("PRIMARY"):
                    self.next()
                    self.expect_kw("KEY")
                    self.expect_op("(")
                    primary_keys.append(self.ident())
                    while self.eat_op(","):
                        primary_keys.append(self.ident())
                    self.expect_op(")")
                else:
                    columns.append(self.column_def())
                if not self.eat_op(","):
                    break
            self.expect_op(")")
        for c in columns:
            if c.time_index and time_index is None:
                time_index = c.name
            if c.primary_key and c.name not in primary_keys:
                primary_keys.append(c.name)
        engine = "file" if external else "mito"
        options: dict = {}
        partition_cols: list[str] = []
        partitions: list[A.Expr] = []
        while True:
            if self.eat_kw("ENGINE"):
                self.expect_op("=")
                engine = self.ident()
            elif self.at_kw("PARTITION"):
                self.next()
                self.expect_kw("ON")
                self.expect_kw("COLUMNS")
                self.expect_op("(")
                partition_cols.append(self.ident())
                while self.eat_op(","):
                    partition_cols.append(self.ident())
                self.expect_op(")")
                self.expect_op("(")
                depth = 1
                # partition exprs parsed as generic expressions separated
                # by commas at depth 1
                while depth > 0 and self.peek().kind != Tok.EOF:
                    if self.at_op(")") and depth == 1:
                        break
                    partitions.append(self.expr())
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
            elif self.eat_kw("WITH"):
                self.expect_op("(")
                while not self.at_op(")"):
                    key = self.next().text
                    self.expect_op("=")
                    val = self.next().text
                    options[key.lower()] = val
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
            else:
                break
        return A.CreateTable(
            name=name, columns=columns, time_index=time_index,
            primary_keys=primary_keys, if_not_exists=ine, engine=engine,
            options=options, partitions=partitions,
            partition_columns=partition_cols,
        )

    def column_def(self) -> A.ColumnDef:
        name = self.ident()
        dtype = self.data_type()
        col = A.ColumnDef(name=name, data_type=dtype)
        while True:
            if self.eat_kw("NOT"):
                self.expect_kw("NULL")
                col.nullable = False
            elif self.eat_kw("NULL"):
                col.nullable = True
            elif self.at_kw("DEFAULT"):
                self.next()
                e = self.expr()
                col.default = e.value if isinstance(e, A.Literal) else e
            elif self.at_kw("PRIMARY"):
                self.next()
                self.expect_kw("KEY")
                col.primary_key = True
            elif self.at_kw("TIME"):
                self.next()
                self.expect_kw("INDEX")
                col.time_index = True
                col.nullable = False
            elif self.at_kw("FULLTEXT"):
                self.next()
                if self.eat_op("("):  # FULLTEXT(with options)
                    while not self.eat_op(")"):
                        self.next()
                col.fulltext = True
            elif self.at_kw("COMMENT"):
                self.next()
                self.next()
            else:
                break
        return col

    def data_type(self) -> ConcreteDataType:
        base = self.ident().lower()
        if self.eat_op("("):
            args = [self.next().text]
            while self.eat_op(","):
                args.append(self.next().text)
            self.expect_op(")")
            base = f"{base}({','.join(args)})"
        if self.at_kw("UNSIGNED"):
            self.next()
            base = f"{base} unsigned"
        return ConcreteDataType.from_name(base)

    def drop(self) -> A.Statement:
        self.expect_kw("DROP")
        if self.eat_kw("DATABASE") or self.eat_kw("SCHEMA"):
            ie = self._if_exists()
            return A.DropDatabase(self.ident(), if_exists=ie)
        if self.eat_kw("FLOW"):
            ie = self._if_exists()
            return A.DropFlow(self.qualified_name(), if_exists=ie)
        if self.eat_kw("VIEW"):
            ie = self._if_exists()
            return A.DropView(self.qualified_name(), if_exists=ie)
        self.eat_kw("TABLE")
        ie = self._if_exists()
        names = [self.qualified_name()]
        while self.eat_op(","):
            names.append(self.qualified_name())
        return A.DropTable(names, if_exists=ie)

    def _if_exists(self) -> bool:
        if self.at_kw("IF"):
            self.next()
            self.expect_kw("EXISTS")
            return True
        return False

    def alter(self) -> A.AlterTable:
        self.expect_kw("ALTER")
        self.expect_kw("TABLE")
        name = self.qualified_name()
        if self.eat_kw("ADD"):
            self.eat_kw("COLUMN")
            col = self.column_def()
            return A.AlterTable(name, "add_column", column=col)
        if self.eat_kw("DROP"):
            self.eat_kw("COLUMN")
            return A.AlterTable(name, "drop_column",
                                old_name=self.ident())
        if self.eat_kw("RENAME"):
            self.eat_kw("TO")
            return A.AlterTable(name, "rename", new_name=self.ident())
        raise InvalidSyntaxError(f"unsupported ALTER at {self.peek().pos}")

    def copy(self) -> A.Copy:
        self.expect_kw("COPY")
        table = self.qualified_name()
        if self.eat_kw("TO"):
            direction = "to"
        else:
            self.expect_kw("FROM")
            direction = "from"
        path = self.next().text
        fmt = "parquet"
        options: dict = {}
        if self.eat_kw("WITH"):
            self.expect_op("(")
            while not self.at_op(")"):
                key = self.next().text.lower()
                self.expect_op("=")
                val = self.next().text
                options[key] = val
                if not self.eat_op(","):
                    break
            self.expect_op(")")
            fmt = options.get("format", fmt).lower()
        return A.Copy(table, direction, path, format=fmt, options=options)

    # ---- TQL ----------------------------------------------------------
    def tql(self) -> A.Tql:
        self.expect_kw("TQL")
        t = self.next()
        kind = t.upper.lower()
        if kind not in ("eval", "evaluate", "explain", "analyze"):
            raise InvalidSyntaxError(f"unsupported TQL {t.text!r}")
        if kind == "evaluate":
            kind = "eval"
        lookback = None
        if kind in ("explain", "analyze") and not self.at_op("("):
            # TQL EXPLAIN/ANALYZE accept a bare expression (the
            # reference defaults the range to a single instant at 0)
            start = end = A.Literal(0)
            step = A.Literal("5m")
        else:
            self.expect_op("(")
            start = self.expr()
            self.expect_op(",")
            end = self.expr()
            self.expect_op(",")
            step = self.expr()
            if self.eat_op(","):
                lookback = self.expr()
            self.expect_op(")")
        # the rest of the statement text is the raw PromQL query
        t0 = self.peek()
        query = self.sql[t0.pos:].strip().rstrip(";")
        # consume remaining tokens
        while self.peek().kind != Tok.EOF and not self.at_op(";"):
            self.next()
        return A.Tql(kind=kind, start=start, end=end, step=step,
                     query=query, lookback=lookback)

    # ---- DML ----------------------------------------------------------
    def insert(self) -> A.Insert:
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        table = self.qualified_name()
        columns: list[str] = []
        if self.eat_op("("):
            columns.append(self.ident())
            while self.eat_op(","):
                columns.append(self.ident())
            self.expect_op(")")
        if self.at_kw("SELECT"):
            return A.Insert(table, columns, [], select=self.select())
        self.expect_kw("VALUES")
        values: list[list[A.Expr]] = []
        while True:
            self.expect_op("(")
            row = [self.expr()]
            while self.eat_op(","):
                row.append(self.expr())
            self.expect_op(")")
            values.append(row)
            if not self.eat_op(","):
                break
        return A.Insert(table, columns, values)

    def delete(self) -> A.Delete:
        self.expect_kw("DELETE")
        self.expect_kw("FROM")
        table = self.qualified_name()
        where = self.expr() if self.eat_kw("WHERE") else None
        return A.Delete(table, where)

    # ---- SHOW ---------------------------------------------------------
    def show(self) -> A.Statement:
        self.expect_kw("SHOW")
        full = self.eat_kw("FULL")
        if self.eat_kw("DATABASES") or self.eat_kw("SCHEMAS"):
            like = None
            if self.eat_kw("LIKE"):
                like = self.next().text
            return A.ShowDatabases(like=like)
        if self.eat_kw("TABLES"):
            like = None
            db = None
            if self.eat_kw("FROM") or self.eat_kw("IN"):
                db = self.ident()
            if self.eat_kw("LIKE"):
                like = self.next().text
            return A.ShowTables(like=like, database=db, full=full)
        if self.eat_kw("FLOWS"):
            return A.ShowFlows()
        if self.eat_kw("VIEWS"):
            return A.ShowViews()
        if self.eat_kw("CREATE"):
            if self.eat_kw("VIEW"):
                return A.ShowCreateView(self.qualified_name())
            if self.eat_kw("FLOW"):
                return A.ShowCreateFlow(self.qualified_name())
            self.expect_kw("TABLE")
            return A.ShowCreateTable(self.qualified_name())
        if self.eat_kw("VARIABLES"):
            like = None
            if self.eat_kw("LIKE"):
                like = self.next().text
            return A.ShowVariables(like=like)
        if self.eat_kw("COLUMNS") or self.eat_kw("FIELDS"):
            self.expect_kw("FROM")
            table, db = self._show_table_target()
            like = None
            if self.eat_kw("LIKE"):
                like = self.next().text
            return A.ShowColumns(table, database=db, like=like, full=full)
        if self.eat_kw("INDEX") or self.eat_kw("INDEXES") or self.eat_kw("KEYS"):
            self.expect_kw("FROM")
            table, db = self._show_table_target()
            return A.ShowIndex(table, database=db)
        if self.at_kw("GLOBAL") or self.at_kw("SESSION"):
            self.next()
            if self.eat_kw("STATUS"):
                return A.ShowStatus()
            self.expect_kw("VARIABLES")
            like = None
            if self.eat_kw("LIKE"):
                like = self.next().text
            return A.ShowVariables(like=like)
        if self.eat_kw("STATUS"):
            return A.ShowStatus()
        if self.eat_kw("CHARSET") or self.eat_kw("CHARACTER"):
            self.eat_kw("SET")
            return A.ShowCharset()
        if self.eat_kw("COLLATION"):
            return A.ShowCollation()
        if self.eat_kw("PROCESSLIST"):
            return A.ShowProcesslist(full=full)
        raise InvalidSyntaxError(f"unsupported SHOW at {self.peek().pos}")

    def _show_table_target(self) -> tuple[str, str | None]:
        """`tbl [FROM|IN db]` or `db.tbl` (MySQL qualified form)."""
        name = self.ident()
        db = None
        if self.eat_op("."):
            db, name = name, self.ident()
        elif self.eat_kw("FROM") or self.eat_kw("IN"):
            db = self.ident()
        return name, db

    # ---- SELECT -------------------------------------------------------
    def select_or_setop(self) -> A.Statement:
        """[WITH ...] select-core (UNION|INTERSECT|EXCEPT [ALL] core)*.
        A trailing ORDER BY / LIMIT on the last core applies to the whole
        compound (standard SQL)."""
        ctes: list[tuple[str, A.Statement]] = []
        if self.eat_kw("WITH"):
            while True:
                name = self.ident()
                self.expect_kw("AS")
                self.expect_op("(")
                q = self.select_or_setop()
                self.expect_op(")")
                ctes.append((name, q))
                if not self.eat_op(","):
                    break
        left, l_paren = self._intersect_level()
        had_setop = False
        last_paren = l_paren
        while self.at_kw("UNION", "EXCEPT"):
            op = self.next().upper.lower()
            all_ = self.eat_kw("ALL")
            self.eat_kw("DISTINCT")
            self._check_core_clean(left, l_paren or had_setop)
            right, r_paren = self._intersect_level()
            left = A.SetOp(op=op, all=all_, left=left, right=right)
            had_setop = True
            last_paren = r_paren
        if isinstance(left, A.SetOp):
            # trailing order/limit of the last UNPARENTHESIZED core binds
            # to the whole compound (standard SQL); a parenthesized
            # operand keeps its own ORDER BY / LIMIT
            last = left.right
            if isinstance(last, (A.Select, A.SetOp)) and not last_paren \
                    and not left.order_by and left.limit is None \
                    and (last.order_by or last.limit is not None):
                left.order_by = last.order_by
                left.limit = last.limit
                left.offset = last.offset
                last.order_by = []
                last.limit = last.offset = None
            # a parenthesized last operand keeps its own clauses; the
            # compound's ORDER BY / LIMIT can still follow the parens
            if not left.order_by and self.eat_kw("ORDER"):
                self.expect_kw("BY")
                left.order_by = [self.order_item()]
                while self.eat_op(","):
                    left.order_by.append(self.order_item())
            if left.limit is None and self.eat_kw("LIMIT"):
                left.limit = int(self.next().text)
            if left.offset is None and self.eat_kw("OFFSET"):
                left.offset = int(self.next().text)
        if ctes:
            left.ctes = ctes
        return left

    def _intersect_level(self) -> tuple[A.Statement, bool]:
        """INTERSECT binds tighter than UNION/EXCEPT (standard SQL).
        Returns (stmt, last operand was parenthesized)."""
        left, l_paren = self.select_core()
        had = False
        last_paren = l_paren
        while self.at_kw("INTERSECT"):
            self.next()
            all_ = self.eat_kw("ALL")
            self.eat_kw("DISTINCT")
            self._check_core_clean(left, l_paren or had)
            right, r_paren = self.select_core()
            left = A.SetOp(op="intersect", all=all_, left=left, right=right)
            had = True
            last_paren = r_paren
        if isinstance(left, A.SetOp) and had:
            last = left.right
            if isinstance(last, A.Select) and not last_paren:
                left.order_by = last.order_by
                left.limit = last.limit
                left.offset = last.offset
                last.order_by = []
                last.limit = last.offset = None
        return left, last_paren and not had

    def _check_core_clean(self, core, parenthesized: bool):
        if parenthesized:
            return
        if isinstance(core, A.Select) and (
            core.order_by or core.limit is not None
        ):
            raise InvalidSyntaxError(
                "ORDER BY / LIMIT before a set operator — "
                "parenthesize the subquery"
            )

    def select_core(self) -> tuple[A.Select | A.SetOp, bool]:
        """Returns (select, was_parenthesized)."""
        if self.at_op("("):
            # parenthesized select as a set-operation operand
            save = self.i
            self.next()
            if self.at_kw("SELECT", "WITH"):
                q = self.select_or_setop()
                self.expect_op(")")
                return q, True
            self.i = save
        return self.select(), False

    def select(self) -> A.Select:
        self.expect_kw("SELECT")
        distinct = self.eat_kw("DISTINCT")
        items = [self.select_item()]
        while self.eat_op(","):
            items.append(self.select_item())
        from_table = None
        source = None
        if self.eat_kw("FROM"):
            source = self.from_source()
            if isinstance(source, A.TableName):
                from_table = source.name
        where = self.expr() if self.eat_kw("WHERE") else None
        range_clause = None
        if self.at_kw("ALIGN"):
            range_clause = self.align_clause()
        group_by: list[A.Expr] = []
        if self.eat_kw("GROUP"):
            self.expect_kw("BY")
            group_by.append(self.expr())
            while self.eat_op(","):
                group_by.append(self.expr())
        having = self.expr() if self.eat_kw("HAVING") else None
        if range_clause is None and self.at_kw("ALIGN"):
            range_clause = self.align_clause()
        order_by: list[A.OrderItem] = []
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            order_by.append(self.order_item())
            while self.eat_op(","):
                order_by.append(self.order_item())
        limit = offset = None
        if self.eat_kw("LIMIT"):
            limit = int(self.next().text)
            # MySQL `LIMIT offset, count`
            if self.eat_op(","):
                offset, limit = limit, int(self.next().text)
        if self.eat_kw("OFFSET"):
            offset = int(self.next().text)
        if limit is None and offset is not None and self.eat_kw("LIMIT"):
            limit = int(self.next().text)  # postgres `OFFSET n LIMIT m`
        return A.Select(
            items=items, from_table=from_table, where=where,
            group_by=group_by, having=having, order_by=order_by,
            limit=limit, offset=offset, range_clause=range_clause,
            distinct=distinct, source=source,
        )

    # ---- FROM sources -------------------------------------------------
    _ALIAS_STOP = (
        "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET", "ALIGN",
        "UNION", "INTERSECT", "EXCEPT", "JOIN", "INNER", "LEFT", "RIGHT",
        "FULL", "CROSS", "ON", "USING", "AS", "FILL", "BY", "TO", "SET",
    )

    def _maybe_alias(self) -> str | None:
        if self.eat_kw("AS"):
            return self.ident()
        t = self.peek()
        if t.kind in (Tok.IDENT, Tok.QIDENT) and not self.at_kw(
            *self._ALIAS_STOP
        ):
            return self.ident()
        return None

    def table_factor(self):
        if self.at_op("("):
            save = self.i
            self.next()
            if self.at_kw("SELECT", "WITH"):
                q = self.select_or_setop()
                self.expect_op(")")
                alias = self._maybe_alias()
                if alias is None:
                    raise InvalidSyntaxError("FROM subquery needs an alias")
                return A.SubquerySource(q, alias)
            # parenthesized join tree
            src = self.from_source()
            self.expect_op(")")
            return src
        name = self.qualified_name()
        return A.TableName(name, self._maybe_alias())

    def from_source(self):
        left = self.table_factor()
        while True:
            if self.at_kw("CROSS"):
                self.next()
                self.expect_kw("JOIN")
                left = A.JoinSource(left, self.table_factor(), "cross")
                continue
            kind = None
            if self.at_kw("JOIN", "INNER"):
                self.eat_kw("INNER")
                kind = "inner"
            elif self.at_kw("LEFT"):
                self.next()
                self.eat_kw("OUTER")
                kind = "left"
            elif self.at_kw("RIGHT"):
                self.next()
                self.eat_kw("OUTER")
                kind = "right"
            elif self.at_kw("FULL"):
                self.next()
                self.eat_kw("OUTER")
                kind = "full"
            elif self.eat_op(","):
                left = A.JoinSource(left, self.table_factor(), "cross")
                continue
            else:
                return left
            self.expect_kw("JOIN")
            right = self.table_factor()
            on = None
            using = None
            if self.eat_kw("ON"):
                on = self.expr()
            elif self.eat_kw("USING"):
                self.expect_op("(")
                using = [self.ident()]
                while self.eat_op(","):
                    using.append(self.ident())
                self.expect_op(")")
            left = A.JoinSource(left, right, kind, on, using)

    def align_clause(self) -> A.RangeClause:
        self.expect_kw("ALIGN")
        align_ms = parse_interval_ms(self._interval_text())
        if align_ms <= 0:
            raise InvalidSyntaxError(
                "ALIGN interval must be positive"
            )
        to = None
        if self.eat_kw("TO"):
            to = self.next().text
        by = None
        if self.eat_kw("BY"):
            self.expect_op("(")
            # BY () = one global group (reference range_select semantics)
            by = []
            if not self.eat_op(")"):
                by = [self.expr()]
                while self.eat_op(","):
                    by.append(self.expr())
                self.expect_op(")")
        fill = None
        if self.eat_kw("FILL"):
            fill = self.next().text.lower()
        return A.RangeClause(align_ms=align_ms, to=to, by=by, fill=fill)

    def _interval_text(self) -> str:
        t = self.next()
        if t.kind in (Tok.STRING, Tok.NUMBER, Tok.IDENT):
            # '5m' | '5 minutes' | 5m (ident-number mix)
            if t.kind == Tok.NUMBER and self.peek().kind == Tok.IDENT:
                return t.text + self.next().text
            return t.text
        raise InvalidSyntaxError(f"expected interval at {t.pos}")

    def select_item(self) -> A.SelectItem:
        if self.at_op("*"):
            self.next()
            return A.SelectItem(A.Star())
        e = self.expr()
        alias = None
        if self.eat_kw("AS"):
            alias = self.ident()
        elif self.peek().kind in (Tok.IDENT, Tok.QIDENT) and not self.at_kw(
            "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET",
            "ALIGN", "UNION", "INTERSECT", "EXCEPT", "FILL", "BY", "TO",
        ):
            alias = self.ident()
        return A.SelectItem(e, alias)

    def order_item(self) -> A.OrderItem:
        e = self.expr()
        asc = True
        if self.eat_kw("DESC"):
            asc = False
        else:
            self.eat_kw("ASC")
        nulls_first = None
        if self.eat_kw("NULLS"):
            if self.eat_kw("FIRST"):
                nulls_first = True
            else:
                self.expect_kw("LAST")
                nulls_first = False
        return A.OrderItem(e, asc, nulls_first)

    # ---- expressions (precedence climbing) ----------------------------
    def expr(self) -> A.Expr:
        return self.or_expr()

    def or_expr(self) -> A.Expr:
        left = self.and_expr()
        while self.at_kw("OR"):
            self.next()
            left = A.BinaryOp("or", left, self.and_expr())
        return left

    def and_expr(self) -> A.Expr:
        left = self.not_expr()
        while self.at_kw("AND"):
            self.next()
            left = A.BinaryOp("and", left, self.not_expr())
        return left

    def not_expr(self) -> A.Expr:
        if self.at_kw("NOT"):
            save = self.i
            self.next()
            if self.at_kw("EXISTS"):
                self.next()
                self.expect_op("(")
                q = self.select_or_setop()
                self.expect_op(")")
                return A.Exists(q, negated=True)
            self.i = save
            self.next()
            return A.UnaryOp("not", self.not_expr())
        if self.at_kw("EXISTS"):
            self.next()
            self.expect_op("(")
            q = self.select_or_setop()
            self.expect_op(")")
            return A.Exists(q)
        return self.cmp_expr()

    def cmp_expr(self) -> A.Expr:
        left = self.add_expr()
        t = self.peek()
        if t.kind == Tok.OP and t.text in ("=", "!=", "<>", "<", "<=", ">",
                                           ">=", "=~", "!~"):
            self.next()
            op = {"<>": "!=", "=~": "like"}.get(t.text, t.text)
            return A.BinaryOp(op, left, self.add_expr())
        if self.at_kw("LIKE"):
            self.next()
            return A.BinaryOp("like", left, self.add_expr())
        if self.at_kw("BETWEEN"):
            self.next()
            low = self.add_expr()
            self.expect_kw("AND")
            return A.Between(left, low, self.add_expr())
        if self.at_kw("IN"):
            self.next()
            self.expect_op("(")
            if self.at_kw("SELECT", "WITH"):
                q = self.select_or_setop()
                self.expect_op(")")
                return A.InSubquery(left, q)
            items = [self.expr()]
            while self.eat_op(","):
                items.append(self.expr())
            self.expect_op(")")
            return A.InList(left, items)
        if self.at_kw("NOT"):
            save = self.i
            self.next()
            if self.eat_kw("BETWEEN"):
                low = self.add_expr()
                self.expect_kw("AND")
                return A.Between(left, low, self.add_expr(), negated=True)
            if self.eat_kw("IN"):
                self.expect_op("(")
                if self.at_kw("SELECT", "WITH"):
                    q = self.select_or_setop()
                    self.expect_op(")")
                    return A.InSubquery(left, q, negated=True)
                items = [self.expr()]
                while self.eat_op(","):
                    items.append(self.expr())
                self.expect_op(")")
                return A.InList(left, items, negated=True)
            if self.eat_kw("LIKE"):
                return A.UnaryOp(
                    "not", A.BinaryOp("like", left, self.add_expr())
                )
            self.i = save
        if self.at_kw("IS"):
            self.next()
            negated = self.eat_kw("NOT")
            self.expect_kw("NULL")
            return A.IsNull(left, negated=negated)
        return left

    def add_expr(self) -> A.Expr:
        left = self.mul_expr()
        while True:
            t = self.peek()
            if t.kind == Tok.OP and t.text in ("+", "-", "||"):
                self.next()
                left = A.BinaryOp(t.text, left, self.mul_expr())
            else:
                return left

    def mul_expr(self) -> A.Expr:
        left = self.unary()
        while True:
            t = self.peek()
            if t.kind == Tok.OP and t.text in ("*", "/", "%"):
                self.next()
                left = A.BinaryOp(t.text, left, self.unary())
            else:
                return left

    def unary(self) -> A.Expr:
        if self.at_op("-"):
            self.next()
            return A.UnaryOp("-", self.unary())
        if self.at_op("+"):
            self.next()
            return self.unary()
        return self.postfix()

    def postfix(self) -> A.Expr:
        e = self.primary()
        while self.eat_op("::"):
            e = A.Cast(e, self.data_type())
        return e

    def primary(self) -> A.Expr:
        t = self.peek()
        if t.kind == Tok.NUMBER:
            self.next()
            text = t.text
            if "." in text or "e" in text or "E" in text:
                return A.Literal(float(text))
            return A.Literal(int(text))
        if t.kind == Tok.STRING:
            self.next()
            if _INTERVAL_RE.match(t.text):
                return A.IntervalLit(parse_interval_ms(t.text), t.text)
            return A.Literal(t.text)
        if self.eat_op("("):
            if self.at_kw("SELECT", "WITH"):
                q = self.select_or_setop()
                self.expect_op(")")
                return A.ScalarSubquery(q)
            e = self.expr()
            self.expect_op(")")
            return e
        if self.at_op("*"):
            self.next()
            return A.Star()
        if t.kind in (Tok.IDENT, Tok.QIDENT):
            up = t.upper
            if up == "NULL":
                self.next()
                return A.Literal(None)
            if up == "TRUE":
                self.next()
                return A.Literal(True)
            if up == "FALSE":
                self.next()
                return A.Literal(False)
            if up == "INTERVAL":
                self.next()
                text = self._interval_text()
                return A.IntervalLit(parse_interval_ms(text), text)
            if up in ("TIMESTAMP", "DATE", "TIME") \
                    and self.peek(1).kind == Tok.STRING:
                # typed literals: TIMESTAMP '2024-01-01 00:00:00'
                self.next()
                lit = self.next().text
                if up == "TIMESTAMP":
                    return A.Cast(
                        A.Literal(lit),
                        ConcreteDataType.timestamp_millisecond(),
                    )
                if up == "DATE":
                    return A.Cast(A.Literal(lit), ConcreteDataType.date())
                return A.Literal(lit)
            if up == "CASE":
                return self.case_expr()
            if up == "CAST":
                self.next()
                self.expect_op("(")
                e = self.expr()
                self.expect_kw("AS")
                to = self.data_type()
                self.expect_op(")")
                return A.Cast(e, to)
            name = self.qualified_name()
            if self.at_op("("):
                return self.func_call(name)
            if "." in name:
                parts = name.rsplit(".", 1)
                return A.Column(parts[1], table=parts[0])
            return A.Column(name)
        raise InvalidSyntaxError(
            f"unexpected token {t.text!r} at {t.pos}"
        )

    def case_expr(self) -> A.Expr:
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.expr()
        whens = []
        while self.eat_kw("WHEN"):
            cond = self.expr()
            self.expect_kw("THEN")
            whens.append((cond, self.expr()))
        else_ = None
        if self.eat_kw("ELSE"):
            else_ = self.expr()
        self.expect_kw("END")
        return A.Case(operand, whens, else_)

    def func_call(self, name: str) -> A.Expr:
        self.expect_op("(")
        # EXTRACT(part FROM expr) standard form -> extract('part', expr)
        if name.lower() in ("extract", "date_part") \
                and self.peek().kind == Tok.IDENT \
                and self.peek(1).kind == Tok.IDENT \
                and self.peek(1).upper == "FROM":
            part = self.ident()
            self.expect_kw("FROM")
            operand = self.expr()
            self.expect_op(")")
            return A.FuncCall(name.lower(),
                              [A.Literal(part.lower()), operand])
        distinct = self.eat_kw("DISTINCT")
        args: list[A.Expr] = []
        order_by: list[A.OrderItem] = []
        if not self.at_op(")"):
            args.append(self.expr())
            while self.eat_op(","):
                args.append(self.expr())
            if self.eat_kw("ORDER"):
                self.expect_kw("BY")
                order_by.append(self.order_item())
                while self.eat_op(","):
                    order_by.append(self.order_item())
        self.expect_op(")")
        fc = A.FuncCall(name.lower(), args, distinct=distinct,
                        order_by=order_by)
        if self.at_kw("WITHIN"):
            # percentile_cont(f) WITHIN GROUP (ORDER BY x) -> quantile
            # agg; ORDER BY x DESC means the fraction counts from the
            # top, i.e. the ascending (1 - f) quantile
            self.next()
            self.expect_kw("GROUP")
            self.expect_op("(")
            self.expect_kw("ORDER")
            self.expect_kw("BY")
            target = self.order_item()
            self.expect_op(")")
            args = list(fc.args)
            if not target.asc and args:
                args[0] = A.BinaryOp("-", A.Literal(1.0), args[0])
            fc = A.FuncCall(fc.name, args + [target.expr],
                            distinct=fc.distinct)
        if self.at_kw("FILTER"):
            # SQL:2003 aggregate filter: agg(x) FILTER (WHERE cond)
            self.next()
            self.expect_op("(")
            self.expect_kw("WHERE")
            fc.filter = self.expr()
            self.expect_op(")")
        if self.at_kw("OVER"):
            self.next()
            fc.over = self.window_spec()
            if fc.filter is not None:
                raise InvalidSyntaxError(
                    "FILTER on window functions is not supported"
                )
        if self.at_kw("RANGE") and fc.over is None:
            if fc.filter is not None:
                raise InvalidSyntaxError(
                    "FILTER is not supported on RANGE aggregates"
                )
            self.next()
            range_ms = parse_interval_ms(self._interval_text())
            if range_ms <= 0:
                raise InvalidSyntaxError(
                    "RANGE interval must be positive"
                )
            fill = None
            if self.at_kw("FILL"):
                self.next()
                fill = self.next().text.lower()
            return A.RangeFunc(fc, range_ms, fill)
        return fc

    def window_spec(self) -> A.WindowSpec:
        self.expect_op("(")
        spec = A.WindowSpec()
        if self.eat_kw("PARTITION"):
            self.expect_kw("BY")
            spec.partition_by.append(self.expr())
            while self.eat_op(","):
                spec.partition_by.append(self.expr())
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            spec.order_by.append(self.order_item())
            while self.eat_op(","):
                spec.order_by.append(self.order_item())
        if self.at_kw("ROWS", "RANGE", "GROUPS"):
            words = [self.next().upper]
            while not self.at_op(")"):
                t = self.next()
                words.append(t.upper if t.kind == Tok.IDENT else t.text)
            spec.frame = " ".join(words)
        self.expect_op(")")
        return spec


def parse_sql(sql: str) -> list[A.Statement]:
    return Parser.parse_sql(sql)
