"""PromQL expression parser (a copy of the JAX package's promql/parser.py;
host code, no device work).

Grammar per the Prometheus spec, mirroring the surface the reference's
PromPlanner consumes (/root/reference/src/query/src/promql/planner.rs:172 —
which uses the promql-parser crate): selectors with matchers, range/offset
modifiers, subqueries, unary/binary operators with bool/on/ignoring/
group_left/group_right, aggregation operators with by/without, functions.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from greptimedb_tpu_torch.errors import InvalidSyntaxError


# ----------------------------------------------------------------------
# AST
# ----------------------------------------------------------------------

@dataclass
class PromExpr:
    pass


@dataclass
class NumberLit(PromExpr):
    value: float


@dataclass
class StringLit(PromExpr):
    value: str


@dataclass
class Matcher:
    name: str
    op: str           # = != =~ !~
    value: str


@dataclass
class VectorSelector(PromExpr):
    name: str | None
    matchers: list[Matcher] = field(default_factory=list)
    range_ms: int | None = None        # set => matrix selector
    offset_ms: int = 0
    at_ms: int | None = None


@dataclass
class Subquery(PromExpr):
    expr: PromExpr
    range_ms: int
    step_ms: int | None               # None => default eval interval
    offset_ms: int = 0


@dataclass
class Unary(PromExpr):
    op: str
    expr: PromExpr


@dataclass
class VectorMatching:
    on: bool = False                   # True: on(...), False: ignoring(...)
    labels: list[str] = field(default_factory=list)
    group: str | None = None           # "left" | "right"
    include: list[str] = field(default_factory=list)
    explicit: bool = False


@dataclass
class Binary(PromExpr):
    op: str
    lhs: PromExpr
    rhs: PromExpr
    bool_mod: bool = False
    matching: VectorMatching = field(default_factory=VectorMatching)


@dataclass
class Agg(PromExpr):
    op: str                            # sum avg min max count topk ...
    expr: PromExpr
    param: PromExpr | None = None      # k for topk, phi for quantile, ...
    grouping: list[str] = field(default_factory=list)
    without: bool = False


@dataclass
class Call(PromExpr):
    name: str
    args: list[PromExpr] = field(default_factory=list)


AGG_OPS = {
    "sum", "avg", "min", "max", "count", "group", "stddev", "stdvar",
    "topk", "bottomk", "quantile", "count_values", "limitk", "limit_ratio",
}
_PARAM_AGGS = {"topk", "bottomk", "quantile", "count_values", "limitk",
               "limit_ratio"}

_DURATION_RE = re.compile(
    r"(?:(\d+)y)?(?:(\d+)w)?(?:(\d+)d)?(?:(\d+)h)?(?:(\d+)m)?"
    r"(?:(\d+)s)?(?:(\d+)ms)?"
)
_UNIT_MS = [
    ("y", 365 * 86400_000), ("w", 7 * 86400_000), ("d", 86400_000),
    ("h", 3600_000), ("m", 60_000), ("s", 1000), ("ms", 1),
]


def parse_duration_ms(text: str) -> int:
    m = _DURATION_RE.fullmatch(text.strip())
    if not m or not any(m.groups()):
        raise InvalidSyntaxError(f"invalid duration: {text!r}")
    total = 0
    for g, (_, ms) in zip(m.groups(), _UNIT_MS):
        if g:
            total += int(g) * ms
    return total


# ----------------------------------------------------------------------
# lexer
# ----------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<duration>\d+(?:y|w|d|h|m(?!s)|s|ms)(?:\d+(?:y|w|d|h|m(?!s)|s|ms))*)
  | (?P<number>
        0x[0-9a-fA-F]+
      | (?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?
      | [iI][nN][fF](?![a-zA-Z0-9_:.])
      | [nN][aA][nN](?![a-zA-Z0-9_:.]))
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<op>=~|!~|==|!=|<=|>=|<|>|=|\+|-|\*|/|%|\^|\(|\)|\{|\}|\[|\]|,|:|@)
  | (?P<ident>[a-zA-Z_:][a-zA-Z0-9_:.]*)
""", re.VERBOSE)


def _tokenize(src: str):
    tokens = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise InvalidSyntaxError(
                f"unexpected character {src[pos]!r} at {pos}"
            )
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        tokens.append((kind, m.group(), m.start()))
    tokens.append(("eof", "", len(src)))
    return tokens


_CMP_OPS = {"==", "!=", "<", "<=", ">", ">="}
_SET_OPS = {"and", "or", "unless"}

# precedence (higher binds tighter)
_PRECEDENCE = {
    "or": 1, "and": 2, "unless": 2,
    "==": 3, "!=": 3, "<": 3, "<=": 3, ">": 3, ">=": 3,
    "+": 4, "-": 4,
    "*": 5, "/": 5, "%": 5, "atan2": 5,
    "^": 6,
}


class _Parser:
    def __init__(self, src: str):
        self.tokens = _tokenize(src)
        self.i = 0

    def peek(self, k: int = 0):
        return self.tokens[min(self.i + k, len(self.tokens) - 1)]

    def next(self):
        t = self.tokens[self.i]
        self.i = min(self.i + 1, len(self.tokens) - 1)
        return t

    def at(self, text: str) -> bool:
        return self.peek()[1] == text

    def at_kind(self, kind: str) -> bool:
        return self.peek()[0] == kind

    def eat(self, text: str) -> bool:
        if self.at(text):
            self.next()
            return True
        return False

    def expect(self, text: str):
        t = self.next()
        if t[1] != text:
            raise InvalidSyntaxError(
                f"expected {text!r}, got {t[1]!r} at {t[2]}"
            )

    # ------------------------------------------------------------------
    def parse(self) -> PromExpr:
        e = self.expr(0)
        t = self.peek()
        if t[0] != "eof":
            raise InvalidSyntaxError(f"trailing input at {t[2]}: {t[1]!r}")
        return e

    def expr(self, min_prec: int) -> PromExpr:
        lhs = self.unary()
        while True:
            t = self.peek()
            if t[0] == "op" and t[1] in _PRECEDENCE:
                op = t[1]
            elif t[0] == "ident" and t[1].lower() in (
                "and", "or", "unless", "atan2"
            ):
                op = t[1].lower()
            else:
                break
            prec = _PRECEDENCE[op]
            if prec < min_prec:
                break
            self.next()
            bool_mod = False
            matching = VectorMatching()
            if self.peek()[1] == "bool":
                self.next()
                bool_mod = True
            if self.peek()[1] in ("on", "ignoring"):
                matching.explicit = True
                matching.on = self.next()[1] == "on"
                matching.labels = self._label_list()
            if self.peek()[1] in ("group_left", "group_right"):
                matching.group = self.next()[1].removeprefix("group_")
                if self.at("("):
                    matching.include = self._label_list()
            # ^ is right-associative
            rhs = self.expr(prec + (0 if op == "^" else 1))
            lhs = Binary(op, lhs, rhs, bool_mod, matching)
        return lhs

    def _label_list(self) -> list[str]:
        self.expect("(")
        out = []
        if not self.at(")"):
            out.append(self.next()[1])
            while self.eat(","):
                if self.at(")"):
                    break
                out.append(self.next()[1])
        self.expect(")")
        return out

    def unary(self) -> PromExpr:
        # unary +/- binds between '*' and '^' (Prometheus: -1^2 == -(1^2))
        if self.at("-"):
            self.next()
            return Unary("-", self.expr(_PRECEDENCE["^"]))
        if self.at("+"):
            self.next()
            return self.expr(_PRECEDENCE["^"])
        return self.postfix()

    def postfix(self) -> PromExpr:
        e = self.primary()
        while True:
            if self.at("["):
                e = self._range_or_subquery(e)
            elif self.peek()[1] == "offset":
                self.next()
                neg = self.eat("-")
                d = self._duration()
                off = -d if neg else d
                if isinstance(e, VectorSelector):
                    e.offset_ms = off
                elif isinstance(e, Subquery):
                    e.offset_ms = off
                else:
                    raise InvalidSyntaxError("offset on non-selector")
            elif self.at("@"):
                self.next()
                t = self.next()
                if isinstance(e, VectorSelector):
                    e.at_ms = int(float(t[1]) * 1000)
                else:
                    raise InvalidSyntaxError("@ on non-selector")
            else:
                break
        return e

    def _duration(self) -> int:
        t = self.next()
        if t[0] == "duration":
            return parse_duration_ms(t[1])
        if t[0] == "number":
            return int(float(t[1]) * 1000)
        raise InvalidSyntaxError(f"expected duration at {t[2]}")

    def _range_or_subquery(self, e: PromExpr) -> PromExpr:
        self.expect("[")
        rng = self._duration()
        if self.eat(":"):
            step = None
            if not self.at("]"):
                step = self._duration()
            self.expect("]")
            return Subquery(e, rng, step)
        self.expect("]")
        if not isinstance(e, VectorSelector) or e.range_ms is not None:
            raise InvalidSyntaxError("range on non-vector selector")
        e.range_ms = rng
        return e

    def primary(self) -> PromExpr:
        t = self.peek()
        if t[0] == "number":
            self.next()
            txt = t[1].lower()
            if txt.startswith("0x"):
                return NumberLit(float(int(txt, 16)))
            if txt == "inf":
                return NumberLit(float("inf"))
            if txt == "nan":
                return NumberLit(float("nan"))
            return NumberLit(float(t[1]))
        if t[0] == "string":
            self.next()
            return StringLit(_unquote(t[1]))
        if t[1] == "(":
            self.next()
            e = self.expr(0)
            self.expect(")")
            return e
        if t[1] == "{":
            return VectorSelector(None, self._matchers())
        if t[0] == "ident":
            name = t[1]
            low = name.lower()
            if low in AGG_OPS and self.peek(1)[1] in ("(", "by", "without"):
                return self._aggregation(low)
            self.next()
            if self.at("("):
                return self._call(low)
            matchers = self._matchers() if self.at("{") else []
            return VectorSelector(name, matchers)
        raise InvalidSyntaxError(f"unexpected token {t[1]!r} at {t[2]}")

    def _matchers(self) -> list[Matcher]:
        self.expect("{")
        out = []
        while not self.at("}"):
            name = self.next()[1]
            op = self.next()[1]
            if op not in ("=", "!=", "=~", "!~"):
                raise InvalidSyntaxError(f"bad matcher op {op!r}")
            v = self.next()
            out.append(Matcher(name, op, _unquote(v[1])))
            if not self.eat(","):
                break
        self.expect("}")
        return out

    def _aggregation(self, op: str) -> PromExpr:
        self.next()  # op name
        grouping: list[str] = []
        without = False
        if self.peek()[1] in ("by", "without"):
            without = self.next()[1] == "without"
            grouping = self._label_list()
        self.expect("(")
        args = [self.expr(0)]
        while self.eat(","):
            args.append(self.expr(0))
        self.expect(")")
        if self.peek()[1] in ("by", "without"):
            without = self.next()[1] == "without"
            grouping = self._label_list()
        param = None
        if op in _PARAM_AGGS:
            if len(args) != 2:
                raise InvalidSyntaxError(f"{op} takes (param, vector)")
            param, expr = args
        else:
            if len(args) != 1:
                raise InvalidSyntaxError(f"{op} takes one vector")
            expr = args[0]
        return Agg(op, expr, param, grouping, without)

    def _call(self, name: str) -> PromExpr:
        self.expect("(")
        args = []
        if not self.at(")"):
            args.append(self.expr(0))
            while self.eat(","):
                args.append(self.expr(0))
        self.expect(")")
        return Call(name, args)


_ESCAPES = {
    "n": "\n", "t": "\t", "r": "\r", "\\": "\\", '"': '"', "'": "'",
    "a": "\a", "b": "\b", "f": "\f", "v": "\v",
}


def _unquote(s: str) -> str:
    body = s[1:-1]
    if "\\" not in body:
        return body
    # escape handling that leaves non-ASCII text intact (unicode_escape
    # would decode UTF-8 bytes as Latin-1)
    return re.sub(
        r"\\(u[0-9a-fA-F]{4}|x[0-9a-fA-F]{2}|.)",
        lambda m: (
            chr(int(m.group(1)[1:], 16))
            if m.group(1)[0] in ("u", "x") and len(m.group(1)) > 1
            else _ESCAPES.get(m.group(1), m.group(1))
        ),
        body,
    )


def parse_promql(src: str) -> PromExpr:
    return _Parser(src).parse()
