"""SQL tokenizer."""

from __future__ import annotations

import enum
from dataclasses import dataclass

from greptimedb_tpu_torch.errors import InvalidSyntaxError


class Tok(enum.Enum):
    IDENT = "ident"
    QIDENT = "qident"        # "quoted" or `backtick` identifier
    NUMBER = "number"
    STRING = "string"
    OP = "op"
    EOF = "eof"


@dataclass
class Token:
    kind: Tok
    text: str
    pos: int

    @property
    def upper(self) -> str:
        return self.text.upper()


_TWO_CHAR_OPS = {"<=", ">=", "<>", "!=", "||", "::", "->", "=~", "!~"}
_ONE_CHAR_OPS = set("+-*/%(),.;=<>[]{}@:?$^")  # ^ rides for TQL pow


def tokenize(sql: str) -> list[Token]:
    out: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":
            while i < n and sql[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":
            j = sql.find("*/", i + 2)
            i = n if j < 0 else j + 2
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i + 1
            seen_dot = c == "."
            while j < n and (sql[j].isdigit() or (sql[j] == "." and not seen_dot)
                             or sql[j] in "eE"
                             or (sql[j] in "+-" and sql[j - 1] in "eE")):
                if sql[j] == ".":
                    seen_dot = True
                j += 1
            out.append(Token(Tok.NUMBER, sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i + 1
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            out.append(Token(Tok.IDENT, sql[i:j], i))
            i = j
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    buf.append("'")
                    j += 2
                elif sql[j] == "'":
                    break
                elif sql[j] == "\\" and j + 1 < n:
                    esc = sql[j + 1]
                    buf.append({"n": "\n", "t": "\t", "r": "\r"}.get(esc, esc))
                    j += 2
                else:
                    buf.append(sql[j])
                    j += 1
            if j >= n:
                raise InvalidSyntaxError(f"unterminated string at {i}")
            out.append(Token(Tok.STRING, "".join(buf), i))
            i = j + 1
            continue
        if c in ('"', "`"):
            close = c
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == close and j + 1 < n and sql[j + 1] == close:
                    buf.append(close)  # doubled quote escapes itself
                    j += 2
                elif sql[j] == close:
                    break
                else:
                    buf.append(sql[j])
                    j += 1
            if j >= n:
                raise InvalidSyntaxError(f"unterminated identifier at {i}")
            out.append(Token(Tok.QIDENT, "".join(buf), i))
            i = j + 1
            continue
        if sql[i:i + 2] in _TWO_CHAR_OPS:
            out.append(Token(Tok.OP, sql[i:i + 2], i))
            i += 2
            continue
        if c in _ONE_CHAR_OPS:
            out.append(Token(Tok.OP, c, i))
            i += 1
            continue
        raise InvalidSyntaxError(f"unexpected character {c!r} at {i}")
    out.append(Token(Tok.EOF, "", n))
    return out
