"""SQL tokenizer.

The reference delegates SQL parsing to DataFusion/sqlparser-rs; this rebuild
ships its own frontend (SURVEY.md §7 step 2).  The token set covers the
TPC-H dialect plus the DDL/utility statements the client context handles
(CREATE EXTERNAL TABLE, SHOW, SET — reference client/src/context.rs:313-460).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum, auto

from ..errors import SqlError


class TokType(Enum):
    IDENT = auto()
    QUOTED_IDENT = auto()
    STRING = auto()
    NUMBER = auto()
    OP = auto()  # + - * / % = <> != < <= > >= || .
    LPAREN = auto()
    RPAREN = auto()
    COMMA = auto()
    SEMICOLON = auto()
    EOF = auto()


@dataclass(frozen=True)
class Token:
    type: TokType
    value: str
    pos: int

    @property
    def upper(self) -> str:
        return self.value.upper()


_TWO_CHAR_OPS = {"<>", "!=", "<=", ">=", "||"}
_ONE_CHAR_OPS = set("+-*/%=<>.")


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":  # line comment
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":  # block comment
            j = sql.find("*/", i + 2)
            if j < 0:
                raise SqlError(f"unterminated block comment at {i}")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":  # escaped ''
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            else:
                raise SqlError(f"unterminated string literal at {i}")
            toks.append(Token(TokType.STRING, "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise SqlError(f"unterminated quoted identifier at {i}")
            toks.append(Token(TokType.QUOTED_IDENT, sql[i + 1 : j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            while j < n and (sql[j].isdigit() or (sql[j] == "." and not seen_dot)):
                if sql[j] == ".":
                    seen_dot = True
                j += 1
            if j < n and sql[j] in "eE":
                k = j + 1
                if k < n and sql[k] in "+-":
                    k += 1
                if k < n and sql[k].isdigit():
                    while k < n and sql[k].isdigit():
                        k += 1
                    j = k
            toks.append(Token(TokType.NUMBER, sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            toks.append(Token(TokType.IDENT, sql[i:j], i))
            i = j
            continue
        if sql[i : i + 2] in _TWO_CHAR_OPS:
            toks.append(Token(TokType.OP, sql[i : i + 2], i))
            i += 2
            continue
        if c in _ONE_CHAR_OPS:
            toks.append(Token(TokType.OP, c, i))
            i += 1
            continue
        if c == "(":
            toks.append(Token(TokType.LPAREN, c, i))
        elif c == ")":
            toks.append(Token(TokType.RPAREN, c, i))
        elif c == ",":
            toks.append(Token(TokType.COMMA, c, i))
        elif c == ";":
            toks.append(Token(TokType.SEMICOLON, c, i))
        else:
            raise SqlError(f"unexpected character {c!r} at {i}")
        i += 1
    toks.append(Token(TokType.EOF, "", n))
    return toks
