"""Recursive-descent SQL parser for the TPC-H dialect + client DDL.

The reference relies on sqlparser-rs via DataFusion; this is a from-scratch
frontend sized to the reference's supported surface: SELECT queries with
joins / subqueries / aggregates (benchmarks/queries/q1-q22 in the reference),
plus CREATE EXTERNAL TABLE / SHOW / SET handled by the client context
(reference client/src/context.rs:313-460).
"""

from __future__ import annotations

from typing import Optional

from ..errors import SqlError
from . import ast
from .lexer import Token, TokType, tokenize

_RESERVED_STOPWORDS = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET", "ON",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "AND", "OR", "NOT",
    "AS", "BY", "ASC", "DESC", "UNION", "SELECT", "WHEN", "THEN", "ELSE",
    "END", "CASE", "IS", "IN", "BETWEEN", "LIKE", "EXISTS", "NULLS", "SET",
    "USING", "OUTER", "SEMI", "ANTI",
}


class Parser:
    def __init__(self, sql: str) -> None:
        self.toks = tokenize(sql)
        self.i = 0

    # ------------------------------------------------------------- helpers
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.type is not TokType.EOF:
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.type is TokType.IDENT and t.upper in kws

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            raise SqlError(f"expected {kw}, found {self.peek().value!r} at {self.peek().pos}")

    def expect(self, type_: TokType) -> Token:
        t = self.next()
        if t.type is not type_:
            raise SqlError(f"expected {type_.name}, found {t.value!r} at {t.pos}")
        return t

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.type is TokType.OP and t.value in ops

    def eat_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    # ---------------------------------------------------------- statements
    def parse_statement(self) -> ast.Statement:
        stmt = self._statement()
        if self.peek().type is TokType.SEMICOLON:
            self.next()
        if self.peek().type is not TokType.EOF:
            raise SqlError(f"unexpected trailing input at {self.peek().pos}: {self.peek().value!r}")
        return stmt

    def _statement(self) -> ast.Statement:
        if self.at_kw("SELECT", "WITH") or self.peek().type is TokType.LPAREN:
            return self.parse_query()
        if self.at_kw("CREATE"):
            return self._create_external_table()
        if self.at_kw("SHOW"):
            self.next()
            parts = []
            while self.peek().type is TokType.IDENT:
                parts.append(self.next().value)
            return ast.ShowStmt(parts)
        if self.at_kw("SET"):
            self.next()
            name_parts = [self.expect(TokType.IDENT).value]
            while self.eat_op("."):
                name_parts.append(self.expect(TokType.IDENT).value)
            if not self.eat_op("="):
                self.expect_kw("TO")
            t = self.next()
            if t.type not in (TokType.STRING, TokType.NUMBER, TokType.IDENT):
                raise SqlError(f"bad SET value at {t.pos}")
            return ast.SetVariable(".".join(name_parts), t.value)
        if self.at_kw("EXPLAIN"):
            self.next()
            verbose = self.eat_kw("VERBOSE")
            analyze = self.eat_kw("ANALYZE")
            return ast.Explain(self.parse_query(), verbose, analyze)
        if self.at_kw("DROP"):
            self.next()
            self.expect_kw("TABLE")
            if_exists = False
            if self.eat_kw("IF"):
                self.expect_kw("EXISTS")
                if_exists = True
            return ast.DropTable(self._identifier(), if_exists)
        raise SqlError(f"unsupported statement starting with {self.peek().value!r}")

    def _create_external_table(self) -> ast.CreateExternalTable:
        self.expect_kw("CREATE")
        self.expect_kw("EXTERNAL")
        self.expect_kw("TABLE")
        if_not_exists = False
        if self.eat_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            if_not_exists = True
        name = self._identifier()
        columns: list[tuple[str, str]] = []
        if self.peek().type is TokType.LPAREN:
            self.next()
            while True:
                col = self._identifier()
                ty_parts = [self._identifier()]
                # multi-word / parameterized types: DECIMAL(12,2), DOUBLE PRECISION
                if self.peek().type is TokType.LPAREN:
                    self.next()
                    ty_parts.append("(")
                    while self.peek().type is not TokType.RPAREN:
                        ty_parts.append(self.next().value)
                    self.next()
                    ty_parts.append(")")
                elif self.at_kw("PRECISION"):
                    ty_parts.append(self.next().value)
                columns.append((col, " ".join(ty_parts)))
                if not self.eat_op(",") and self.peek().type is not TokType.COMMA:
                    break
                if self.peek().type is TokType.COMMA:
                    self.next()
            self.expect(TokType.RPAREN)
        file_type = "CSV"
        has_header = False
        delimiter = ","
        if self.eat_kw("STORED"):
            self.expect_kw("AS")
            file_type = self.next().upper
        if self.eat_kw("WITH"):
            self.expect_kw("HEADER")
            self.expect_kw("ROW")
            has_header = True
        if self.eat_kw("DELIMITER"):
            delimiter = self.expect(TokType.STRING).value
        self.expect_kw("LOCATION")
        location = self.expect(TokType.STRING).value
        return ast.CreateExternalTable(
            name, file_type, location, columns, has_header, delimiter, if_not_exists
        )

    # -------------------------------------------------------------- queries
    def parse_query(self) -> ast.Query:
        if self.peek().type is TokType.LPAREN:
            # parenthesized query
            self.next()
            q = self.parse_query()
            self.expect(TokType.RPAREN)
            return q
        ctes: list[tuple[str, ast.Query]] = []
        if self.eat_kw("WITH"):
            while True:
                name = self._identifier()
                self.expect_kw("AS")
                self.expect(TokType.LPAREN)
                sub = self.parse_query()
                self.expect(TokType.RPAREN)
                ctes.append((name, sub))
                if self.peek().type is TokType.COMMA:
                    self.next()
                else:
                    break
        self.expect_kw("SELECT")
        q = ast.Query()
        q.ctes = ctes
        q.distinct = self.eat_kw("DISTINCT")
        self.eat_kw("ALL")
        q.select = self._select_list()
        if self.eat_kw("FROM"):
            q.from_ = self._table_refs()
        if self.eat_kw("WHERE"):
            q.where = self.parse_expr()
        if self.eat_kw("GROUP"):
            self.expect_kw("BY")
            q.group_by = self._expr_list()
        if self.eat_kw("HAVING"):
            q.having = self.parse_expr()
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            q.order_by = self._order_items()
        if self.eat_kw("LIMIT"):
            q.limit = int(self.expect(TokType.NUMBER).value)
        if self.eat_kw("OFFSET"):
            q.offset = int(self.expect(TokType.NUMBER).value)
        return q

    def _select_list(self) -> list[ast.SelectItem]:
        items = [self._select_item()]
        while self.peek().type is TokType.COMMA:
            self.next()
            items.append(self._select_item())
        return items

    def _select_item(self) -> ast.SelectItem:
        expr = self.parse_expr()
        alias: Optional[str] = None
        if self.eat_kw("AS"):
            alias = self._identifier()
        elif self.peek().type is TokType.IDENT and self.peek().upper not in _RESERVED_STOPWORDS:
            alias = self.next().value
        elif self.peek().type is TokType.QUOTED_IDENT:
            alias = self.next().value
        return ast.SelectItem(expr, alias)

    def _table_refs(self) -> list[ast.TableRef]:
        refs = [self._table_ref_with_joins()]
        while self.peek().type is TokType.COMMA:
            self.next()
            refs.append(self._table_ref_with_joins())
        return refs

    def _table_ref_with_joins(self) -> ast.TableRef:
        left = self._table_primary()
        while True:
            kind = None
            if self.at_kw("JOIN"):
                kind = "INNER"
                self.next()
            elif self.at_kw("INNER") and self.peek(1).upper == "JOIN":
                self.next(); self.next()
                kind = "INNER"
            elif self.at_kw("LEFT", "RIGHT", "FULL"):
                kind = self.next().upper
                self.eat_kw("OUTER")
                self.expect_kw("JOIN")
            elif self.at_kw("CROSS") and self.peek(1).upper == "JOIN":
                self.next(); self.next()
                kind = "CROSS"
            else:
                break
            right = self._table_primary()
            on = None
            if kind != "CROSS":
                self.expect_kw("ON")
                on = self.parse_expr()
            left = ast.JoinClause(left, right, kind, on)
        return left

    def _table_primary(self) -> ast.TableRef:
        if self.peek().type is TokType.LPAREN:
            self.next()
            q = self.parse_query()
            self.expect(TokType.RPAREN)
            self.eat_kw("AS")
            alias = self._identifier()
            return ast.DerivedTable(q, alias)
        name = self._identifier()
        while self.eat_op("."):  # schema-qualified: keep last part
            name = self._identifier()
        alias = None
        if self.eat_kw("AS"):
            alias = self._identifier()
        elif (
            self.peek().type is TokType.IDENT
            and self.peek().upper not in _RESERVED_STOPWORDS
        ):
            alias = self.next().value
        return ast.NamedTable(name, alias)

    def _rows_frame(self) -> ast.WindowFrame:
        """ROWS BETWEEN <bound> AND <bound>, or the one-bound shorthand
        ROWS <bound> (= BETWEEN <bound> AND CURRENT ROW)."""

        def bound():
            """(offset | None, direction) — direction disambiguates which
            side UNBOUNDED points to."""
            if self.eat_kw("UNBOUNDED"):
                if self.eat_kw("PRECEDING"):
                    return None, "preceding"
                self.expect_kw("FOLLOWING")
                return None, "following"
            if self.eat_kw("CURRENT"):
                self.expect_kw("ROW")
                return 0, "current"
            tok = self.expect(TokType.NUMBER)
            try:
                n = int(tok.value)
            except ValueError as err:
                raise SqlError(
                    f"ROWS frame bound must be an integer, got {tok.value!r}"
                ) from err
            if self.eat_kw("PRECEDING"):
                return -n, "preceding"
            self.expect_kw("FOLLOWING")
            return n, "following"

        if self.eat_kw("BETWEEN"):
            start, sdir = bound()
            self.expect_kw("AND")
            end, edir = bound()
            if start is None and sdir == "following":
                raise SqlError("frame start cannot be UNBOUNDED FOLLOWING")
            if end is None and edir == "preceding":
                raise SqlError("frame end cannot be UNBOUNDED PRECEDING")
        else:
            start, sdir = bound()
            if sdir == "following" and start is not None and start > 0:
                raise SqlError(
                    "a one-bound ROWS frame must start at or before "
                    "CURRENT ROW"
                )
            if start is None and sdir == "following":
                raise SqlError("frame start cannot be UNBOUNDED FOLLOWING")
            end = 0
        return ast.WindowFrame(start, end)

    def _order_items(self) -> list[ast.OrderItem]:
        items = []
        while True:
            e = self.parse_expr()
            asc = True
            if self.eat_kw("ASC"):
                asc = True
            elif self.eat_kw("DESC"):
                asc = False
            nulls_first = None
            if self.eat_kw("NULLS"):
                if self.eat_kw("FIRST"):
                    nulls_first = True
                else:
                    self.expect_kw("LAST")
                    nulls_first = False
            items.append(ast.OrderItem(e, asc, nulls_first))
            if self.peek().type is TokType.COMMA:
                self.next()
                continue
            break
        return items

    def _expr_list(self) -> list[ast.SqlExpr]:
        out = [self.parse_expr()]
        while self.peek().type is TokType.COMMA:
            self.next()
            out.append(self.parse_expr())
        return out

    def _identifier(self) -> str:
        t = self.next()
        if t.type in (TokType.IDENT, TokType.QUOTED_IDENT):
            return t.value
        raise SqlError(f"expected identifier, found {t.value!r} at {t.pos}")

    # ---------------------------------------------------------- expressions
    def parse_expr(self) -> ast.SqlExpr:
        return self._or_expr()

    def _or_expr(self) -> ast.SqlExpr:
        left = self._and_expr()
        while self.eat_kw("OR"):
            left = ast.Binary("OR", left, self._and_expr())
        return left

    def _and_expr(self) -> ast.SqlExpr:
        left = self._not_expr()
        while self.eat_kw("AND"):
            left = ast.Binary("AND", left, self._not_expr())
        return left

    def _not_expr(self) -> ast.SqlExpr:
        if self.eat_kw("NOT"):
            return ast.Unary("NOT", self._not_expr())
        return self._comparison()

    def _comparison(self) -> ast.SqlExpr:
        left = self._additive()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.next().value
                if op == "!=":
                    op = "<>"
                left = ast.Binary(op, left, self._additive())
                continue
            negated = False
            save = self.i
            if self.eat_kw("NOT"):
                negated = True
            if self.eat_kw("BETWEEN"):
                low = self._additive()
                self.expect_kw("AND")
                high = self._additive()
                left = ast.Between(left, low, high, negated)
                continue
            if self.eat_kw("IN"):
                self.expect(TokType.LPAREN)
                if self.at_kw("SELECT"):
                    q = self.parse_query()
                    self.expect(TokType.RPAREN)
                    left = ast.InSubquery(left, q, negated)
                else:
                    items = self._expr_list()
                    self.expect(TokType.RPAREN)
                    left = ast.InList(left, items, negated)
                continue
            if self.eat_kw("LIKE"):
                left = ast.Like(left, self._additive(), negated)
                continue
            if negated:
                self.i = save  # NOT belonged to something else
                break
            if self.eat_kw("IS"):
                neg = self.eat_kw("NOT")
                self.expect_kw("NULL")
                left = ast.IsNull(left, neg)
                continue
            break
        return left

    def _additive(self) -> ast.SqlExpr:
        left = self._multiplicative()
        while self.at_op("+", "-", "||"):
            op = self.next().value
            left = ast.Binary(op, left, self._multiplicative())
        return left

    def _multiplicative(self) -> ast.SqlExpr:
        left = self._unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            left = ast.Binary(op, left, self._unary())
        return left

    def _unary(self) -> ast.SqlExpr:
        if self.eat_op("-"):
            return ast.Unary("-", self._unary())
        if self.eat_op("+"):
            return self._unary()
        return self._primary()

    def _primary(self) -> ast.SqlExpr:
        t = self.peek()
        if t.type is TokType.NUMBER:
            self.next()
            return ast.NumberLit(t.value)
        if t.type is TokType.STRING:
            self.next()
            return ast.StringLit(t.value)
        if t.type is TokType.LPAREN:
            self.next()
            if self.at_kw("SELECT"):
                q = self.parse_query()
                self.expect(TokType.RPAREN)
                return ast.ScalarSubquery(q)
            e = self.parse_expr()
            self.expect(TokType.RPAREN)
            return e
        if t.type is TokType.OP and t.value == "*":
            self.next()
            return ast.Star()
        if t.type is TokType.QUOTED_IDENT:
            self.next()
            return self._maybe_compound(ast.ColumnRef(t.value))
        if t.type is not TokType.IDENT:
            raise SqlError(f"unexpected token {t.value!r} at {t.pos}")

        kw = t.upper
        if kw == "CASE":
            return self._case()
        if kw == "CAST":
            self.next()
            self.expect(TokType.LPAREN)
            e = self.parse_expr()
            self.expect_kw("AS")
            ty_parts = [self._identifier()]
            if self.peek().type is TokType.LPAREN:
                self.next()
                ty_parts.append("(")
                while self.peek().type is not TokType.RPAREN:
                    ty_parts.append(self.next().value)
                self.next()
                ty_parts.append(")")
            elif self.at_kw("PRECISION"):
                ty_parts.append(self.next().value)
            self.expect(TokType.RPAREN)
            return ast.CastExpr(e, " ".join(ty_parts))
        if kw == "EXTRACT":
            self.next()
            self.expect(TokType.LPAREN)
            fieldname = self._identifier().upper()
            self.expect_kw("FROM")
            e = self.parse_expr()
            self.expect(TokType.RPAREN)
            return ast.Extract(fieldname, e)
        if kw == "SUBSTRING":
            self.next()
            self.expect(TokType.LPAREN)
            e = self.parse_expr()
            if self.eat_kw("FROM"):
                start = self.parse_expr()
                length = None
                if self.eat_kw("FOR"):
                    length = self.parse_expr()
            else:
                self.expect(TokType.COMMA) if self.peek().type is TokType.COMMA else None
                start = self.parse_expr()
                length = None
                if self.peek().type is TokType.COMMA:
                    self.next()
                    length = self.parse_expr()
            self.expect(TokType.RPAREN)
            return ast.Substring(e, start, length)
        if kw == "DATE" and self.peek(1).type is TokType.STRING:
            self.next()
            return ast.DateLit(self.next().value)
        if kw == "TIMESTAMP" and self.peek(1).type is TokType.STRING:
            self.next()
            return ast.DateLit(self.next().value.split(" ")[0])
        if kw == "INTERVAL":
            self.next()
            v = self.next()
            if v.type is TokType.STRING:
                parts = v.value.strip().split()
                if len(parts) == 2:
                    return ast.IntervalLit(parts[0], parts[1].upper().rstrip("S"))
                amount = parts[0]
            else:
                amount = v.value
            unit = self._identifier().upper().rstrip("S")
            return ast.IntervalLit(amount, unit)
        if kw == "EXISTS" and self.peek(1).type is TokType.LPAREN:
            self.next()
            self.next()
            q = self.parse_query()
            self.expect(TokType.RPAREN)
            return ast.Exists(q)
        if kw == "NULL":
            self.next()
            return ast.NullLit()
        if kw == "TRUE":
            self.next()
            return ast.BoolLit(True)
        if kw == "FALSE":
            self.next()
            return ast.BoolLit(False)

        # function call or column reference
        if self.peek(1).type is TokType.LPAREN:
            name = self.next().value
            self.next()  # (
            distinct = self.eat_kw("DISTINCT")
            if self.at_op("*"):
                self.next()
                args: list[ast.SqlExpr] = [ast.Star()]
            elif self.peek().type is TokType.RPAREN:
                args = []
            else:
                args = self._expr_list()
            self.expect(TokType.RPAREN)
            call = ast.FunctionCall(name.lower(), args, distinct)
            if self.eat_kw("OVER"):
                self.expect(TokType.LPAREN)
                spec = ast.WindowSpec()
                if self.eat_kw("PARTITION"):
                    self.expect_kw("BY")
                    spec.partition_by = self._expr_list()
                if self.eat_kw("ORDER"):
                    self.expect_kw("BY")
                    spec.order_by = self._order_items()
                if self.eat_kw("ROWS"):
                    spec.frame = self._rows_frame()
                self.expect(TokType.RPAREN)
                call.over = spec
            return call
        self.next()
        return self._maybe_compound(ast.ColumnRef(t.value))

    def _maybe_compound(self, col: ast.ColumnRef) -> ast.SqlExpr:
        if self.eat_op("."):
            if self.at_op("*"):
                self.next()
                return ast.Star(qualifier=col.name)
            part = self._identifier()
            return ast.ColumnRef(part, qualifier=col.name)
        return col

    def _case(self) -> ast.SqlExpr:
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expr()
        whens = []
        while self.eat_kw("WHEN"):
            cond = self.parse_expr()
            self.expect_kw("THEN")
            whens.append((cond, self.parse_expr()))
        else_expr = None
        if self.eat_kw("ELSE"):
            else_expr = self.parse_expr()
        self.expect_kw("END")
        return ast.Case(operand, whens, else_expr)


def parse_sql(sql: str) -> ast.Statement:
    return Parser(sql).parse_statement()
