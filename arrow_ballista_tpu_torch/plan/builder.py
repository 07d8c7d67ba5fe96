"""AST → logical plan builder (name resolution & analysis).

Counterpart of DataFusion's SQL planner as used by the reference's
``BallistaContext::sql`` (``client/src/context.rs:346-460``).  Resolves table
names against the catalog, extracts aggregates out of SELECT/HAVING/ORDER BY,
decorrelates ``IN (subquery)`` into semi/anti joins, and plans uncorrelated
scalar subqueries as :class:`~..plan.expressions.ScalarSubqueryExpr`.
"""

from __future__ import annotations

import datetime as _dt
from typing import Optional

import pyarrow as pa

from ..catalog import Catalog
from ..errors import NotImplementedYet, PlanError, SqlError
from ..sql import ast
from . import expressions as ex
from . import logical as lp


def sql_type_to_arrow(name: str) -> pa.DataType:
    n = name.strip().upper()
    base = n.split("(")[0].strip()
    if base in ("INT", "INTEGER"):
        return pa.int32()
    if base in ("BIGINT", "LONG"):
        return pa.int64()
    if base == "SMALLINT":
        return pa.int16()
    if base == "TINYINT":
        return pa.int8()
    if base in ("FLOAT", "REAL"):
        return pa.float32()
    if base in ("DOUBLE", "DOUBLE PRECISION"):
        return pa.float64()
    if base in ("DECIMAL", "NUMERIC"):
        # decimals execute as float64 on the TPU path (MXU/VPU have no
        # decimal unit); precision-sensitive users can cast explicitly
        return pa.float64()
    if base in ("VARCHAR", "CHAR", "TEXT", "STRING"):
        return pa.string()
    if base in ("BOOLEAN", "BOOL"):
        return pa.bool_()
    if base == "DATE":
        return pa.date32()
    if base in ("TIMESTAMP", "DATETIME"):
        return pa.timestamp("us")
    raise SqlError(f"unsupported SQL type {name!r}")


_INTERVAL_UNIT_MONTHS = {"YEAR": 12, "MONTH": 1}
_INTERVAL_UNIT_DAYS = {"DAY": 1, "WEEK": 7}


def _split_conjuncts(e: ast.SqlExpr) -> list[ast.SqlExpr]:
    if isinstance(e, ast.Binary) and e.op == "AND":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _conjoin(exprs: list[ex.Expr]) -> Optional[ex.Expr]:
    if not exprs:
        return None
    out = exprs[0]
    for e in exprs[1:]:
        out = ex.BinaryExpr(out, "AND", e)
    return out


class PlanBuilder:
    def __init__(self, catalog: Catalog, udfs=None):
        self.catalog = catalog
        self.udfs = udfs  # Optional[UdfRegistry]
        self._sq_counter = 0  # fresh-name counter for decorrelated subqueries
        self._ctes: dict[str, ast.Query] = {}

    # ------------------------------------------------------------- queries
    def build_query(self, q: ast.Query) -> lp.LogicalPlan:
        if q.ctes:
            saved = dict(self._ctes)
            try:
                for name, sub in q.ctes:
                    self._ctes[name.lower()] = sub
                return self._build_query_body(q)
            finally:
                self._ctes = saved
        return self._build_query_body(q)

    def _build_query_body(self, q: ast.Query) -> lp.LogicalPlan:
        # FROM
        if q.from_:
            plan = self._plan_table_ref(q.from_[0])
            for ref in q.from_[1:]:
                plan = lp.CrossJoin(plan, self._plan_table_ref(ref))
        else:
            plan = lp.EmptyRelation(produce_one_row=True)

        # WHERE — peel IN/EXISTS-subquery conjuncts into semi/anti joins.
        # Plain conjuncts are filtered FIRST so the optimizer's
        # Filter(CrossJoin) → hash-join rewrite still sees the cross-join
        # tree; subquery joins are planted on top of the filtered plan.
        if q.where is not None:
            plain: list[ex.Expr] = []
            sub_conjs: list[ast.SqlExpr] = []
            scalar_conjs: list[ast.Binary] = []
            for conj in _split_conjuncts(q.where):
                # normalize NOT EXISTS(...) / NOT (x IN (sub)) shapes
                if (
                    isinstance(conj, ast.Unary)
                    and conj.op == "NOT"
                    and isinstance(conj.operand, (ast.InSubquery, ast.Exists))
                ):
                    inner_c = conj.operand
                    conj = (
                        ast.Exists(inner_c.query, not inner_c.negated)
                        if isinstance(inner_c, ast.Exists)
                        else ast.InSubquery(
                            inner_c.operand, inner_c.query, not inner_c.negated
                        )
                    )
                if isinstance(conj, (ast.InSubquery, ast.Exists)):
                    sub_conjs.append(conj)
                    continue
                try:
                    plain.append(self._expr(conj, plan.schema))
                except PlanError:
                    # a comparison against a *correlated* scalar subquery
                    # fails normal building (outer refs don't resolve);
                    # decorrelate it below instead
                    if isinstance(conj, ast.Binary) and (
                        isinstance(conj.left, ast.ScalarSubquery)
                        or isinstance(conj.right, ast.ScalarSubquery)
                    ):
                        scalar_conjs.append(conj)
                    else:
                        raise
            pred = _conjoin(plain)
            if pred is not None:
                plan = lp.Filter(pred, plan)
            for conj in scalar_conjs:
                outer_fields = list(plan.schema)
                plan, cmp_expr = self._decorrelate_scalar(plan, conj)
                plan = lp.Filter(cmp_expr, plan)
                # project the helper key/value columns back out; alias to the
                # FULL (possibly qualified) field name so later qualified
                # references still resolve
                plan = lp.Projection(
                    [ex.Alias(ex.col(f.name), f.name) for f in outer_fields], plan
                )
            for conj in sub_conjs:
                if isinstance(conj, ast.InSubquery):
                    plan = self._plan_in_subquery(plan, conj)
                else:
                    plan = self._plan_exists(plan, conj)

        in_schema = plan.schema

        # SELECT list with * expansion
        select_exprs: list[ex.Expr] = []
        for item in q.select:
            if isinstance(item.expr, ast.Star):
                qual = item.expr.qualifier
                for f in in_schema:
                    parts = f.name.split(".")
                    if qual is None or (len(parts) == 2 and parts[0] == qual):
                        select_exprs.append(
                            ex.Column(parts[-1], parts[0] if len(parts) == 2 else None)
                        )
            else:
                e = self._expr(item.expr, in_schema)
                if item.alias:
                    e = ex.Alias(e, item.alias)
                select_exprs.append(e)

        alias_map = {e.name: e for e in select_exprs}

        # GROUP BY (supports ordinals and select aliases)
        group_exprs: list[ex.Expr] = []
        for g in q.group_by:
            if isinstance(g, ast.NumberLit):
                idx = int(g.value) - 1
                if idx < 0 or idx >= len(select_exprs):
                    raise SqlError(f"GROUP BY position {g.value} out of range")
                ge = select_exprs[idx]
                ge = ge.expr if isinstance(ge, ex.Alias) else ge
            else:
                ge = self._expr(g, in_schema, alias_map)
            group_exprs.append(ge)

        # aggregates appearing anywhere in select / having / order by
        agg_exprs: list[ex.AggregateExpr] = []

        def _collect(e: ex.Expr) -> None:
            for a in ex.find_aggregates(e):
                if not any(str(a) == str(b) for b in agg_exprs):
                    agg_exprs.append(a)

        for e in select_exprs:
            _collect(e)
        having_expr = (
            self._expr(q.having, in_schema, alias_map) if q.having is not None else None
        )
        if having_expr is not None:
            _collect(having_expr)
        order_exprs: list[ex.SortExpr] = []
        for oi in q.order_by:
            if isinstance(oi.expr, ast.NumberLit):
                idx = int(oi.expr.value) - 1
                if idx < 0 or idx >= len(select_exprs):
                    raise SqlError(f"ORDER BY position {oi.expr.value} out of range")
                base = select_exprs[idx]
                base = base.expr if isinstance(base, ex.Alias) else base
            else:
                base = self._expr(oi.expr, in_schema, alias_map)
            _collect(base)
            order_exprs.append(ex.SortExpr(base, oi.asc, oi.nulls_first))

        if group_exprs or agg_exprs:
            plan = lp.Aggregate(group_exprs, list(agg_exprs), plan)
            agg_schema = plan.schema

            # rewrite select/having/order exprs: aggregate and group-expr
            # occurrences become column refs into the aggregate output
            rewrite_map: dict[str, str] = {}
            for i, g in enumerate(group_exprs):
                rewrite_map[str(g)] = agg_schema.field(i).name
            for j, a in enumerate(agg_exprs):
                rewrite_map[str(a)] = agg_schema.field(len(group_exprs) + j).name

            def _rw(e: ex.Expr) -> ex.Expr:
                def fn(node: ex.Expr) -> ex.Expr:
                    key = str(node)
                    if key in rewrite_map and not isinstance(node, ex.Column):
                        return ex.col(rewrite_map[key])
                    return node

                return ex.transform(e, fn)

            select_exprs = [
                ex.Alias(_rw(e.expr), e.alias_name) if isinstance(e, ex.Alias) else _rw(e)
                for e in select_exprs
            ]
            # validate: non-aggregate select exprs must be grouping exprs
            for e in select_exprs:
                inner = e.expr if isinstance(e, ex.Alias) else e
                for c in ex.find_columns(inner):
                    try:
                        c.resolve_index(agg_schema)
                    except PlanError as err:
                        raise PlanError(
                            f"expression {e} is neither aggregated nor grouped"
                        ) from err
            if having_expr is not None:
                plan = lp.Filter(_rw(having_expr), plan)
            order_exprs = [
                ex.SortExpr(_rw(s.expr), s.asc, s.nulls_first) for s in order_exprs
            ]

        # WINDOW functions evaluate between aggregation and projection:
        # collect distinct window exprs from select/order, plant a Window
        # node, then rewrite occurrences into column refs on its output
        win_exprs: list[ex.WindowExpr] = []

        def _collect_wins(e: ex.Expr) -> None:
            for w in ex.find_windows(e):
                if not any(str(w) == str(x) for x in win_exprs):
                    win_exprs.append(w)

        for e in select_exprs:
            _collect_wins(e)
        for s in order_exprs:
            _collect_wins(s.expr)
        if win_exprs:
            plan = lp.Window(win_exprs, plan)
            wschema = plan.schema
            base = len(wschema) - len(win_exprs)
            wmap = {
                str(w): wschema.field(base + i).name
                for i, w in enumerate(win_exprs)
            }

            def _rww(e: ex.Expr) -> ex.Expr:
                def fn(node: ex.Expr) -> ex.Expr:
                    if isinstance(node, ex.WindowExpr):
                        return ex.col(wmap[str(node)])
                    return node

                return ex.transform(e, fn)

            select_exprs = [
                ex.Alias(_rww(e.expr), e.alias_name)
                if isinstance(e, ex.Alias)
                else _rww(e)
                for e in select_exprs
            ]
            order_exprs = [
                ex.SortExpr(_rww(s.expr), s.asc, s.nulls_first)
                for s in order_exprs
            ]

        plan = lp.Projection(select_exprs, plan)

        if q.distinct:
            plan = lp.Distinct(plan)

        if order_exprs:
            # a top-k sort may keep at most limit+offset rows — the Limit
            # above still applies the skip
            topk = (q.limit + (q.offset or 0)) if q.limit is not None else None
            # resolve sort keys against projection output where possible;
            # otherwise extend the projection, sort, and re-project
            proj_schema = plan.schema
            missing: list[ex.Expr] = []
            resolved: list[ex.SortExpr] = []
            for s in order_exprs:
                try:
                    # data_type alone is not enough: exprs with a fixed
                    # return type (UDFs) succeed without resolving their
                    # argument columns
                    for c in ex.find_columns(s.expr):
                        c.resolve_index(proj_schema)
                    s.expr.data_type(proj_schema)
                    resolved.append(s)
                except PlanError:
                    missing.append(s.expr)
                    # downstream of the widened projection the computed sort
                    # key exists as a named column — reference it by name
                    resolved.append(ex.SortExpr(ex.col(s.expr.name), s.asc, s.nulls_first))
            if missing and isinstance(plan, lp.Projection):
                wide = lp.Projection(plan.exprs + missing, plan.input)
                keep = [f.name for f in proj_schema]
                plan = lp.Projection(
                    [ex.col(n) for n in keep], lp.Sort(resolved, wide, fetch=topk)
                )
            else:
                plan = lp.Sort(resolved, plan, fetch=topk)

        if q.limit is not None or q.offset is not None:
            plan = lp.Limit(plan, q.offset or 0, q.limit)
        return plan

    # ----------------------------------------------------------- table refs
    def _plan_table_ref(self, ref: ast.TableRef) -> lp.LogicalPlan:
        # Inline-expansion fallback for CTEs reaching the builder directly
        # (context._sql_with_ctes materializes top-level CTEs once instead;
        # this path serves nested WITH and direct build_query callers)
        if isinstance(ref, ast.NamedTable) and ref.name.lower() in self._ctes:
            sub = self.build_query(self._ctes[ref.name.lower()])
            return lp.SubqueryAlias(sub, ref.alias or ref.name)
        if isinstance(ref, ast.NamedTable):
            provider = self.catalog.get(ref.name)
            scan = lp.TableScan(ref.name, provider)
            if ref.alias and ref.alias != ref.name:
                return lp.SubqueryAlias(scan, ref.alias)
            return scan
        if isinstance(ref, ast.DerivedTable):
            sub = self.build_query(ref.query)
            return lp.SubqueryAlias(sub, ref.alias)
        if isinstance(ref, ast.JoinClause):
            left = self._plan_table_ref(ref.left)
            right = self._plan_table_ref(ref.right)
            if ref.kind == "CROSS":
                return lp.CrossJoin(left, right)
            schema = pa.schema(list(left.schema) + list(right.schema))
            on_pairs, residual = self._extract_equijoin(
                ref.on, left.schema, right.schema, schema
            )
            if not on_pairs:
                raise NotImplementedYet("non-equi joins require an equality condition")
            jt = ref.kind.lower()
            return lp.Join(left, right, on_pairs, jt, residual)
        raise PlanError(f"unhandled table ref {ref}")

    def _extract_equijoin(
        self,
        on: Optional[ast.SqlExpr],
        left_schema: pa.Schema,
        right_schema: pa.Schema,
        joint: pa.Schema,
    ) -> tuple[list[tuple[ex.Column, ex.Column]], Optional[ex.Expr]]:
        pairs: list[tuple[ex.Column, ex.Column]] = []
        residual: list[ex.Expr] = []
        if on is None:
            return pairs, None
        for conj in _split_conjuncts(on):
            done = False
            if isinstance(conj, ast.Binary) and conj.op == "=":
                l = self._expr(conj.left, joint)
                r = self._expr(conj.right, joint)
                if isinstance(l, ex.Column) and isinstance(r, ex.Column):
                    l_in_left = _column_in(l, left_schema)
                    r_in_left = _column_in(r, left_schema)
                    if l_in_left and not r_in_left:
                        pairs.append((l, r))
                        done = True
                    elif r_in_left and not l_in_left:
                        pairs.append((r, l))
                        done = True
            if not done:
                residual.append(self._expr(conj, joint))
        return pairs, _conjoin(residual)

    def _plan_in_subquery(
        self, plan: lp.LogicalPlan, conj: ast.InSubquery
    ) -> lp.LogicalPlan:
        sub = self.build_query(conj.query)
        if len(sub.schema) != 1:
            raise SqlError("IN subquery must return one column")
        left_key = self._expr(conj.operand, plan.schema)
        if not isinstance(left_key, ex.Column):
            raise NotImplementedYet("IN subquery on computed expressions")
        right_field = sub.schema.field(0).name
        right_key = ex.col(right_field)
        jt = "anti" if conj.negated else "semi"
        return lp.Join(plan, sub, [(left_key, right_key)], jt, None)

    # ------------------------------------------------------- decorrelation
    def _sub_from(self, sub_q: ast.Query) -> lp.LogicalPlan:
        if not sub_q.from_:
            raise SqlError("subquery requires a FROM clause")
        sub_plan = self._plan_table_ref(sub_q.from_[0])
        for ref in sub_q.from_[1:]:
            sub_plan = lp.CrossJoin(sub_plan, self._plan_table_ref(ref))
        return sub_plan

    def _classify_correlated(
        self,
        where: Optional[ast.SqlExpr],
        inner_schema: pa.Schema,
        outer_schema: pa.Schema,
    ) -> tuple[list[ast.SqlExpr], list[tuple[ex.Column, ex.Column]], list[ast.SqlExpr]]:
        """Split a subquery WHERE into (local conjuncts, correlated equality
        pairs as (outer_col, inner_col), residual correlated conjuncts).

        SQL scoping rule: a name binds to the innermost (subquery) scope
        first and only falls back to the outer scope if unresolved — hence
        the try-inner-first classification.  Counterpart of DataFusion's
        decorrelation rules the reference relies on upstream.
        """
        local: list[ast.SqlExpr] = []
        pairs: list[tuple[ex.Column, ex.Column]] = []
        residual: list[ast.SqlExpr] = []
        if where is None:
            return local, pairs, residual
        for c in _split_conjuncts(where):
            try:
                self._expr(c, inner_schema)
                local.append(c)
                continue
            except (PlanError, SqlError):
                pass
            pair = None
            if isinstance(c, ast.Binary) and c.op == "=":
                for a, b in ((c.left, c.right), (c.right, c.left)):
                    try:
                        ie = self._expr(a, inner_schema)
                        oe = self._expr(b, outer_schema)
                    except (PlanError, SqlError):
                        continue
                    if isinstance(ie, ex.Column) and isinstance(oe, ex.Column):
                        pair = (oe, ie)
                        break
            if pair is not None:
                pairs.append(pair)
            else:
                residual.append(c)
        return local, pairs, residual

    def _plan_exists(self, plan: lp.LogicalPlan, conj: ast.Exists) -> lp.LogicalPlan:
        """Correlated [NOT] EXISTS → semi/anti hash join (TPC-H q4/q21/q22).

        Correlated equalities become join keys; other correlated conjuncts
        (e.g. q21's ``l2.l_suppkey <> l1.l_suppkey``) become the join's
        residual filter, evaluated over the combined outer+inner row.
        """
        sub_q = conj.query
        sub_plan = self._sub_from(sub_q)
        inner_schema = sub_plan.schema
        outer_schema = plan.schema
        local, pairs, residual = self._classify_correlated(
            sub_q.where, inner_schema, outer_schema
        )
        if not pairs:
            raise NotImplementedYet(
                "EXISTS subquery without a correlated equality predicate"
            )
        local_pred = _conjoin([self._expr(c, inner_schema) for c in local])
        if local_pred is not None:
            sub_plan = lp.Filter(local_pred, sub_plan)
        joint = pa.schema(list(outer_schema) + list(inner_schema))
        res_pred = _conjoin([self._expr(c, joint) for c in residual])
        jt = "anti" if conj.negated else "semi"
        return lp.Join(plan, sub_plan, pairs, jt, res_pred)

    def _decorrelate_scalar(
        self, plan: lp.LogicalPlan, conj: ast.Binary
    ) -> tuple[lp.LogicalPlan, ex.Expr]:
        """Rewrite ``expr CMP (correlated scalar aggregate subquery)`` into a
        group-by-correlation-keys aggregate joined back to the outer plan
        (TPC-H q2/q17/q20).  Returns (joined plan, comparison filter expr).

        Empty groups: the spec scalar subquery yields NULL there and the
        comparison is then not-true — the inner join drops those rows, which
        is equivalent for a WHERE conjunct.
        """
        left_is_sub = isinstance(conj.left, ast.ScalarSubquery)
        sub_ast = conj.left if left_is_sub else conj.right
        other_ast = conj.right if left_is_sub else conj.left
        assert isinstance(sub_ast, ast.ScalarSubquery)
        sub_q = sub_ast.query
        if sub_q.group_by or len(sub_q.select) != 1:
            raise NotImplementedYet(
                "correlated scalar subquery must be a single ungrouped aggregate"
            )
        sub_plan = self._sub_from(sub_q)
        inner_schema = sub_plan.schema
        outer_schema = plan.schema
        local, pairs, residual = self._classify_correlated(
            sub_q.where, inner_schema, outer_schema
        )
        if residual:
            raise NotImplementedYet(
                "non-equality correlated predicate in scalar subquery"
            )
        if not pairs:
            raise PlanError("scalar subquery is not correlated; cannot decorrelate")
        local_pred = _conjoin([self._expr(c, inner_schema) for c in local])
        if local_pred is not None:
            sub_plan = lp.Filter(local_pred, sub_plan)

        val = self._expr(sub_q.select[0].expr, inner_schema)
        aggs = list(ex.find_aggregates(val))
        if not aggs:
            raise NotImplementedYet("correlated scalar subquery without aggregate")
        group_exprs: list[ex.Expr] = [inner for _, inner in pairs]
        agg_plan = lp.Aggregate(group_exprs, aggs, sub_plan)
        agg_schema = agg_plan.schema
        rewrite: dict[str, str] = {}
        for j, a in enumerate(aggs):
            rewrite[str(a)] = agg_schema.field(len(group_exprs) + j).name

        def _rw(node: ex.Expr) -> ex.Expr:
            key = str(node)
            if key in rewrite and not isinstance(node, ex.Column):
                return ex.col(rewrite[key])
            return node

        n = self._sq_counter
        self._sq_counter += 1
        proj_exprs: list[ex.Expr] = [
            ex.Alias(ex.col(agg_schema.field(i).name), f"__sq{n}_k{i}")
            for i in range(len(pairs))
        ]
        proj_exprs.append(ex.Alias(ex.transform(val, _rw), f"__sq{n}_v"))
        proj = lp.Projection(proj_exprs, agg_plan)

        on = [
            (outer, ex.col(f"__sq{n}_k{i}"))
            for i, (outer, _) in enumerate(pairs)
        ]
        joined = lp.Join(plan, proj, on, "inner", None)
        other = self._expr(other_ast, outer_schema)
        v = ex.col(f"__sq{n}_v")
        cmp_expr = (
            ex.BinaryExpr(v, conj.op, other)
            if left_is_sub
            else ex.BinaryExpr(other, conj.op, v)
        )
        return joined, cmp_expr

    # ---------------------------------------------------------- expressions
    def _window_expr(
        self,
        e: ast.FunctionCall,
        schema: pa.Schema,
        alias_map: Optional[dict[str, ex.Expr]] = None,
    ) -> ex.WindowExpr:
        fname = e.name
        if e.distinct:
            raise SqlError(f"DISTINCT is not supported in window {fname}")
        offset = 1
        if fname in ex.WINDOW_RANKING_FUNCTIONS:
            if fname == "ntile":
                if len(e.args) != 1 or not isinstance(e.args[0], ast.NumberLit):
                    raise SqlError("ntile takes one literal integer argument")
                try:
                    offset = int(e.args[0].value)
                except ValueError as err:
                    raise SqlError(
                        f"ntile bucket count must be an integer, "
                        f"got {e.args[0].value!r}"
                    ) from err
                if offset < 1:
                    raise SqlError("ntile bucket count must be >= 1")
            elif e.args:
                raise SqlError(f"{fname}() takes no arguments")
            if not e.over.order_by:
                raise SqlError(f"{fname}() requires ORDER BY in its window")
            arg = None
        elif fname in ex.WINDOW_VALUE_FUNCTIONS:
            if not e.over.order_by:
                raise SqlError(f"{fname}() requires ORDER BY in its window")
            max_args = 2 if fname in ("lag", "lead") else 1
            if not 1 <= len(e.args) <= max_args:
                raise SqlError(f"bad argument count for window {fname}")
            arg = self._expr(e.args[0], schema, alias_map)
            if len(e.args) == 2:
                if not isinstance(e.args[1], ast.NumberLit):
                    raise SqlError(f"{fname} offset must be a literal integer")
                try:
                    offset = int(e.args[1].value)
                except ValueError as err:
                    raise SqlError(
                        f"{fname} offset must be a literal integer, "
                        f"got {e.args[1].value!r}"
                    ) from err
        elif fname in ("sum", "avg", "min", "max", "count"):
            if fname == "count" and len(e.args) == 1 and isinstance(
                e.args[0], ast.Star
            ):
                arg = None
            elif len(e.args) == 1:
                arg = self._expr(e.args[0], schema, alias_map)
            else:
                raise SqlError(f"window {fname} takes one argument")
        else:
            raise SqlError(f"unsupported window function {fname}")
        partition_by = tuple(
            self._expr(p, schema, alias_map) for p in e.over.partition_by
        )
        order_by = tuple(
            ex.SortExpr(
                self._expr(oi.expr, schema, alias_map), oi.asc, oi.nulls_first
            )
            for oi in e.over.order_by
        )
        frame = None
        if e.over.frame is not None:
            if fname not in ("sum", "avg", "min", "max", "count"):
                raise SqlError(
                    f"a ROWS frame applies to aggregate windows, not {fname}"
                )
            if not order_by:
                raise SqlError("a ROWS frame requires ORDER BY in its window")
            f = e.over.frame
            if (
                f.start is not None
                and f.end is not None
                and f.start > f.end
            ):
                raise SqlError("ROWS frame start is after its end")
            frame = (f.start, f.end)
        return ex.WindowExpr(fname, arg, partition_by, order_by, offset, frame)

    def _expr(
        self,
        e: ast.SqlExpr,
        schema: pa.Schema,
        alias_map: Optional[dict[str, ex.Expr]] = None,
    ) -> ex.Expr:
        if isinstance(e, ast.ColumnRef):
            c = ex.Column(e.name, e.qualifier)
            try:
                c.resolve_index(schema)
                return c
            except PlanError:
                if alias_map and e.qualifier is None and e.name in alias_map:
                    a = alias_map[e.name]
                    return a.expr if isinstance(a, ex.Alias) else a
                raise
        if isinstance(e, ast.NumberLit):
            if "." in e.value or "e" in e.value.lower():
                return ex.lit(float(e.value))
            return ex.lit(int(e.value))
        if isinstance(e, ast.StringLit):
            return ex.lit(e.value)
        if isinstance(e, ast.BoolLit):
            return ex.lit(e.value)
        if isinstance(e, ast.NullLit):
            return ex.lit(None)
        if isinstance(e, ast.DateLit):
            try:
                return ex.lit(_dt.date.fromisoformat(e.value))
            except ValueError as err:
                raise SqlError(f"bad date literal {e.value!r}") from err
        if isinstance(e, ast.IntervalLit):
            amount = int(float(e.value))
            if e.unit in _INTERVAL_UNIT_MONTHS:
                return ex.IntervalLiteral(months=amount * _INTERVAL_UNIT_MONTHS[e.unit])
            if e.unit in _INTERVAL_UNIT_DAYS:
                return ex.IntervalLiteral(days=amount * _INTERVAL_UNIT_DAYS[e.unit])
            raise NotImplementedYet(f"interval unit {e.unit}")
        if isinstance(e, ast.Binary):
            if e.op in ("AND", "OR"):
                return ex.BinaryExpr(
                    self._expr(e.left, schema, alias_map),
                    e.op,
                    self._expr(e.right, schema, alias_map),
                )
            return ex.BinaryExpr(
                self._expr(e.left, schema, alias_map),
                e.op,
                self._expr(e.right, schema, alias_map),
            )
        if isinstance(e, ast.Unary):
            if e.op == "NOT":
                return ex.NotExpr(self._expr(e.operand, schema, alias_map))
            inner = self._expr(e.operand, schema, alias_map)
            if isinstance(inner, ex.Literal) and isinstance(inner.value, (int, float)):
                return ex.Literal(-inner.value, inner.dtype)
            return ex.NegativeExpr(inner)
        if isinstance(e, ast.IsNull):
            return ex.IsNullExpr(self._expr(e.operand, schema, alias_map), e.negated)
        if isinstance(e, ast.Between):
            return ex.BetweenExpr(
                self._expr(e.operand, schema, alias_map),
                self._expr(e.low, schema, alias_map),
                self._expr(e.high, schema, alias_map),
                e.negated,
            )
        if isinstance(e, ast.InList):
            return ex.InListExpr(
                self._expr(e.operand, schema, alias_map),
                tuple(self._expr(i, schema, alias_map) for i in e.items),
                e.negated,
            )
        if isinstance(e, ast.Like):
            return ex.LikeExpr(
                self._expr(e.operand, schema, alias_map),
                self._expr(e.pattern, schema, alias_map),
                e.negated,
            )
        if isinstance(e, ast.Case):
            return ex.CaseExpr(
                self._expr(e.operand, schema, alias_map) if e.operand else None,
                tuple(
                    (self._expr(w, schema, alias_map), self._expr(t, schema, alias_map))
                    for w, t in e.whens
                ),
                self._expr(e.else_expr, schema, alias_map) if e.else_expr else None,
            )
        if isinstance(e, ast.CastExpr):
            return ex.CastExpr(
                self._expr(e.operand, schema, alias_map), sql_type_to_arrow(e.type_name)
            )
        if isinstance(e, ast.Extract):
            return ex.ScalarFunction(
                "date_part",
                (ex.lit(e.field.lower()), self._expr(e.operand, schema, alias_map)),
            )
        if isinstance(e, ast.Substring):
            args = [
                self._expr(e.operand, schema, alias_map),
                self._expr(e.start, schema, alias_map),
            ]
            if e.length is not None:
                args.append(self._expr(e.length, schema, alias_map))
            return ex.ScalarFunction("substr", tuple(args))
        if isinstance(e, ast.FunctionCall):
            fname = e.name
            if e.over is not None:
                return self._window_expr(e, schema, alias_map)
            if fname == "count" and e.distinct:
                fname = "count_distinct"
            # synonyms → canonical names; a user-registered UDF/UDAF with
            # the synonym's name keeps precedence (it resolved before the
            # synonyms existed, and hijacking it silently would change
            # that query's answer)
            if self.udfs is None or (
                self.udfs.scalar(fname) is None
                and self.udfs.aggregate(fname) is None
            ):
                fname = {
                    "stddev_samp": "stddev", "std": "stddev",
                    "var_samp": "var", "variance": "var",
                    "pow": "power",
                }.get(fname, fname)
            if fname in ex.AGGREGATE_FUNCTIONS:
                if e.distinct and fname not in ("count_distinct", "min", "max"):
                    # DISTINCT would silently be ignored: refuse instead
                    # (min/max are distinct-invariant and pass through)
                    raise SqlError(f"DISTINCT is not supported for {fname}")
                if fname == "corr":
                    if len(e.args) != 2:
                        raise SqlError("corr takes two arguments")
                    return ex.AggregateExpr(
                        fname,
                        self._expr(e.args[0], schema, alias_map),
                        False,
                        arg2=self._expr(e.args[1], schema, alias_map),
                    )
                if len(e.args) == 1 and isinstance(e.args[0], ast.Star):
                    return ex.AggregateExpr(fname, None, e.distinct)
                if len(e.args) != 1:
                    raise SqlError(f"{fname} takes one argument")
                return ex.AggregateExpr(
                    fname, self._expr(e.args[0], schema, alias_map), e.distinct
                )
            if fname in ex.SCALAR_FUNCTIONS:
                return ex.ScalarFunction(
                    fname, tuple(self._expr(a, schema, alias_map) for a in e.args)
                )
            # user-defined functions, resolved from the session registry
            if self.udfs is not None:
                u = self.udfs.scalar(fname)
                if u is not None:
                    if len(e.args) != len(u.input_types):
                        raise SqlError(
                            f"UDF {fname} takes {len(u.input_types)} "
                            f"argument(s), got {len(e.args)}"
                        )
                    return ex.ScalarUDFExpr(
                        u.name,
                        tuple(self._expr(a, schema, alias_map) for a in e.args),
                        u.return_type,
                    )
                ua = self.udfs.aggregate(fname)
                if ua is not None:
                    if len(e.args) != 1:
                        raise SqlError(f"UDAF {fname} takes one argument")
                    if e.distinct:
                        raise NotImplementedYet(
                            f"DISTINCT is not supported for UDAF {fname}"
                        )
                    return ex.AggregateExpr(
                        f"udaf:{ua.name}",
                        self._expr(e.args[0], schema, alias_map),
                        False,
                        udaf_type=ua.return_type,
                    )
            raise SqlError(f"unknown function {fname!r}")
        if isinstance(e, ast.ScalarSubquery):
            sub = self.build_query(e.query)
            if len(sub.schema) != 1:
                raise SqlError("scalar subquery must return one column")
            return ex.ScalarSubqueryExpr(sub)
        if isinstance(e, ast.Exists):
            raise NotImplementedYet("EXISTS outside of top-level WHERE conjunct")
        if isinstance(e, ast.Star):
            raise SqlError("* not allowed here")
        raise PlanError(f"unhandled AST expression {e}")


def _column_in(c: ex.Column, schema: pa.Schema) -> bool:
    try:
        c.resolve_index(schema)
        return True
    except PlanError:
        return False
