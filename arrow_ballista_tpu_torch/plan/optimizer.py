"""Logical plan optimizer.

The reference inherits DataFusion's optimizer; this rebuild implements the
rules that matter for its workload (TPC-H via ``benchmarks/queries``):

1. ``simplify_expressions`` — constant folding, notably ``DATE ± INTERVAL``.
2. ``rewrite_cross_joins`` — comma-style FROM lists arrive as CrossJoin
   chains under a Filter; equality conjuncts become hash-join keys.
3. ``push_down_predicates`` — split conjuncts and push each to the deepest
   side of joins it fully references; register scan-level filters for
   parquet row-group pruning.
4. ``push_down_projection`` — prune unused columns all the way into scans
   (critical on TPU: every pruned column is HBM bandwidth saved).
"""

from __future__ import annotations

import datetime as _dt
from typing import Optional

import pyarrow as pa

from ..errors import PlanError
from . import expressions as ex
from . import logical as lp


def optimize(plan: lp.LogicalPlan) -> lp.LogicalPlan:
    plan = simplify_expressions(plan)
    plan = factor_or_common(plan)
    plan = rewrite_cross_joins(plan)
    plan = push_down_predicates(plan)
    plan = push_down_projection(plan)
    return plan


# ------------------------------------------------------------ rule 1: folding
def _add_months(d: _dt.date, months: int) -> _dt.date:
    y, m = divmod(d.year * 12 + (d.month - 1) + months, 12)
    day = min(
        d.day,
        [31, 29 if y % 4 == 0 and (y % 100 != 0 or y % 400 == 0) else 28,
         31, 30, 31, 30, 31, 31, 30, 31, 30, 31][m],
    )
    return _dt.date(y, m + 1, day)


def fold_expr(e: ex.Expr) -> ex.Expr:
    def fn(node: ex.Expr) -> ex.Expr:
        if isinstance(node, ex.BinaryExpr) and node.op in ("+", "-"):
            l, r = node.left, node.right
            if (
                isinstance(l, ex.Literal)
                and isinstance(l.value, _dt.date)
                and isinstance(r, ex.IntervalLiteral)
            ):
                sign = 1 if node.op == "+" else -1
                d = l.value
                if r.months:
                    d = _add_months(d, sign * r.months)
                if r.days:
                    d = d + _dt.timedelta(days=sign * r.days)
                return ex.lit(d)
            if (
                isinstance(l, ex.Literal)
                and isinstance(r, ex.Literal)
                and isinstance(l.value, (int, float))
                and isinstance(r.value, (int, float))
            ):
                v = l.value + r.value if node.op == "+" else l.value - r.value
                return ex.lit(v)
        if isinstance(node, ex.BinaryExpr) and node.op in ("*", "/"):
            l, r = node.left, node.right
            if (
                isinstance(l, ex.Literal)
                and isinstance(r, ex.Literal)
                and isinstance(l.value, (int, float))
                and isinstance(r.value, (int, float))
            ):
                return ex.lit(l.value * r.value if node.op == "*" else l.value / r.value)
        return node

    return ex.transform(e, fn)


def _map_exprs(plan: lp.LogicalPlan, f) -> lp.LogicalPlan:
    import copy

    p = copy.copy(plan)
    if isinstance(p, lp.Projection):
        p.exprs = [f(e) for e in p.exprs]
    elif isinstance(p, lp.Filter):
        p.predicate = f(p.predicate)
    elif isinstance(p, lp.Aggregate):
        p.group_exprs = [f(e) for e in p.group_exprs]
        p.agg_exprs = [f(e) for e in p.agg_exprs]
    elif isinstance(p, lp.Sort):
        p.sort_exprs = [f(e) for e in p.sort_exprs]
    elif isinstance(p, lp.Join) and p.filter is not None:
        p.filter = f(p.filter)
    return p


def simplify_expressions(plan: lp.LogicalPlan) -> lp.LogicalPlan:
    return lp.transform_up(plan, lambda p: _map_exprs(p, fold_expr))


# ----------------------------------------------------- rule 2: cross → equi
def _schema_of(plans: list[lp.LogicalPlan]) -> pa.Schema:
    fields: list[pa.Field] = []
    for p in plans:
        fields.extend(p.schema)
    return pa.schema(fields)


def _refs_within(e: ex.Expr, schema: pa.Schema) -> bool:
    try:
        for c in ex.find_columns(e):
            c.resolve_index(schema)
        return True
    except PlanError:
        return False


def rewrite_cross_joins(plan: lp.LogicalPlan) -> lp.LogicalPlan:
    def fn(p: lp.LogicalPlan) -> lp.LogicalPlan:
        if not (isinstance(p, lp.Filter) and isinstance(p.input, lp.CrossJoin)):
            return p
        # flatten the cross-join tree
        rels: list[lp.LogicalPlan] = []

        def flatten(n: lp.LogicalPlan) -> None:
            if isinstance(n, lp.CrossJoin):
                flatten(n.left)
                flatten(n.right)
            else:
                rels.append(n)

        flatten(p.input)
        conjuncts: list[ex.Expr] = _split_expr_conjuncts(p.predicate)

        # equality conjuncts between two distinct relations become join edges
        joined = rels[0]
        remaining = rels[1:]
        residual: list[ex.Expr] = list(conjuncts)
        progress = True
        while remaining and progress:
            progress = False
            for cand in list(remaining):
                trial_schema = _schema_of([joined, cand])
                keys: list[tuple[ex.Column, ex.Column]] = []
                used: list[ex.Expr] = []
                for c in residual:
                    if (
                        isinstance(c, ex.BinaryExpr)
                        and c.op == "="
                        and isinstance(c.left, ex.Column)
                        and isinstance(c.right, ex.Column)
                    ):
                        l_in = _refs_within(c.left, joined.schema)
                        r_in = _refs_within(c.right, joined.schema)
                        l_cand = _refs_within(c.left, cand.schema)
                        r_cand = _refs_within(c.right, cand.schema)
                        if l_in and r_cand and not l_cand and not r_in:
                            keys.append((c.left, c.right))
                            used.append(c)
                        elif r_in and l_cand and not r_cand and not l_in:
                            keys.append((c.right, c.left))
                            used.append(c)
                if keys:
                    joined = lp.Join(joined, cand, keys, "inner", None)
                    remaining = [r for r in remaining if r is not cand]
                    # NB: identity-based removal — Expr.__eq__ is overloaded
                    # to build comparison expressions (DataFrame API), so
                    # list.remove() must never be used on Expr lists
                    used_ids = {id(u) for u in used}
                    residual = [r for r in residual if id(r) not in used_ids]
                    progress = True
        for cand in remaining:  # no join edge found — keep cartesian
            joined = lp.CrossJoin(joined, cand)
        pred = _conjoin(residual)
        return lp.Filter(pred, joined) if pred is not None else joined

    return lp.transform_up(plan, fn)


def _split_disjuncts(e: ex.Expr) -> list[ex.Expr]:
    if isinstance(e, ex.BinaryExpr) and e.op == "OR":
        return _split_disjuncts(e.left) + _split_disjuncts(e.right)
    return [e]


def factor_or_common(plan: lp.LogicalPlan) -> lp.LogicalPlan:
    """``(A and B) or (A and C)`` → ``A and (B or C)``.

    TPC-H q19's predicate repeats ``p_partkey = l_partkey`` inside every OR
    branch; factoring it out lets rewrite_cross_joins turn the cartesian
    product into a hash join (DataFusion does this as part of its filter
    simplification)."""

    def fix_pred(pred: ex.Expr) -> ex.Expr:
        branches = _split_disjuncts(pred)
        if len(branches) < 2:
            return pred
        per_branch = [_split_expr_conjuncts(b) for b in branches]
        common_keys = set(str(c) for c in per_branch[0])
        for cs in per_branch[1:]:
            common_keys &= {str(c) for c in cs}
        if not common_keys:
            return pred
        common: list[ex.Expr] = []
        seen: set[str] = set()
        for c in per_branch[0]:
            if str(c) in common_keys and str(c) not in seen:
                common.append(c)
                seen.add(str(c))
        rests: list[ex.Expr] = []
        for cs in per_branch:
            rest = [c for c in cs if str(c) not in common_keys]
            if not rest:
                # a branch that is exactly the common part: the OR is
                # implied true once common holds — drop the disjunction
                return _conjoin(common)  # type: ignore[return-value]
            rests.append(_conjoin(rest))  # type: ignore[arg-type]
        ored = rests[0]
        for r in rests[1:]:
            ored = ex.BinaryExpr(ored, "OR", r)
        return _conjoin(common + [ored])  # type: ignore[return-value]

    def fn(p: lp.LogicalPlan) -> lp.LogicalPlan:
        if isinstance(p, lp.Filter):
            new_pred = _conjoin(
                [fix_pred(c) for c in _split_expr_conjuncts(p.predicate)]
            )
            if new_pred is not None and str(new_pred) != str(p.predicate):
                return lp.Filter(new_pred, p.input)
        return p

    return lp.transform_up(plan, fn)


def _split_expr_conjuncts(e: ex.Expr) -> list[ex.Expr]:
    if isinstance(e, ex.BinaryExpr) and e.op == "AND":
        return _split_expr_conjuncts(e.left) + _split_expr_conjuncts(e.right)
    return [e]


def _conjoin(exprs: list[ex.Expr]) -> Optional[ex.Expr]:
    if not exprs:
        return None
    out = exprs[0]
    for e in exprs[1:]:
        out = ex.BinaryExpr(out, "AND", e)
    return out


# --------------------------------------------------- rule 3: predicate push
def push_down_predicates(plan: lp.LogicalPlan) -> lp.LogicalPlan:
    def fn(p: lp.LogicalPlan) -> lp.LogicalPlan:
        if not isinstance(p, lp.Filter):
            return p
        conjuncts = _split_expr_conjuncts(p.predicate)
        child = p.input
        if isinstance(child, lp.Join) and child.join_type == "inner":
            left_push: list[ex.Expr] = []
            right_push: list[ex.Expr] = []
            keep: list[ex.Expr] = []
            for c in conjuncts:
                in_l = _refs_within(c, child.left.schema)
                in_r = _refs_within(c, child.right.schema)
                if in_l and not in_r:
                    left_push.append(c)
                elif in_r and not in_l:
                    right_push.append(c)
                else:
                    keep.append(c)
            if left_push or right_push:
                new_left = (
                    fn(lp.Filter(_conjoin(left_push), child.left))
                    if left_push
                    else child.left
                )
                new_right = (
                    fn(lp.Filter(_conjoin(right_push), child.right))
                    if right_push
                    else child.right
                )
                new_join = lp.Join(
                    new_left, new_right, child.on, child.join_type, child.filter
                )
                kp = _conjoin(keep)
                return lp.Filter(kp, new_join) if kp is not None else new_join
            return p
        if isinstance(child, lp.TableScan):
            # register as scan filters (row-group pruning hint); keep Filter
            child = lp.TableScan(
                child.table_name, child.provider, child.projection,
                child.filters + conjuncts,
            )
            return lp.Filter(p.predicate, child)
        if isinstance(child, lp.SubqueryAlias):
            # translate alias-qualified refs to the inner schema positionally
            outer, inner = child.schema, child.input.schema

            def translate(e: ex.Expr) -> ex.Expr:
                def t(node: ex.Expr) -> ex.Expr:
                    if isinstance(node, ex.Column):
                        idx = node.resolve_index(outer)
                        return ex.col(inner.field(idx).name)
                    return node

                return ex.transform(e, t)

            try:
                inner_pred = translate(p.predicate)
            except PlanError:
                return p
            return lp.SubqueryAlias(fn(lp.Filter(inner_pred, child.input)), child.alias)
        return p

    return lp.transform_up(plan, fn)


# -------------------------------------------------- rule 4: projection push
def push_down_projection(plan: lp.LogicalPlan) -> lp.LogicalPlan:
    return _push_proj(plan, None)


def _required_from_exprs(exprs: list[ex.Expr], schema: pa.Schema) -> set[str]:
    req: set[str] = set()
    for e in exprs:
        for c in ex.find_columns(e):
            req.add(schema.field(c.resolve_index(schema)).name)
    return req


def _push_proj(plan: lp.LogicalPlan, required: Optional[set[str]]) -> lp.LogicalPlan:
    import copy

    if isinstance(plan, lp.Projection):
        p = copy.copy(plan)
        in_schema = p.input.schema
        req = _required_from_exprs(p.exprs, in_schema)
        p.input = _push_proj(p.input, req)
        return p
    if isinstance(plan, lp.Filter):
        p = copy.copy(plan)
        in_schema = p.input.schema
        req = None
        if required is not None:
            req = set(required) | _required_from_exprs([p.predicate], in_schema)
        p.input = _push_proj(p.input, req)
        return p
    if isinstance(plan, lp.Aggregate):
        p = copy.copy(plan)
        in_schema = p.input.schema
        req = _required_from_exprs(p.group_exprs + p.agg_exprs, in_schema)
        p.input = _push_proj(p.input, req)
        return p
    if isinstance(plan, lp.Sort):
        p = copy.copy(plan)
        in_schema = p.input.schema
        req = None
        if required is not None:
            req = set(required) | _required_from_exprs(list(p.sort_exprs), in_schema)
        p.input = _push_proj(p.input, req)
        return p
    if isinstance(plan, lp.Window):
        # Window passes every input column through and appends its own
        # outputs: keep the upstream requirement minus the window output
        # names, plus whatever the window exprs reference
        p = copy.copy(plan)
        in_schema = p.input.schema
        win_refs = _required_from_exprs(list(p.window_exprs), in_schema)
        req = None
        if required is not None:
            in_names = {f.name for f in in_schema}
            req = {r for r in required if r in in_names} | win_refs
        p.input = _push_proj(p.input, req)
        return p
    if isinstance(plan, (lp.Limit, lp.Distinct)):
        p = copy.copy(plan)
        p.input = _push_proj(p.input, required)
        return p
    if isinstance(plan, lp.SubqueryAlias):
        p = copy.copy(plan)
        inner_req = None
        if required is not None:
            outer, inner = p.schema, p.input.schema
            inner_req = set()
            for name in required:
                idx = outer.get_field_index(name)
                if idx >= 0:
                    inner_req.add(inner.field(idx).name)
        p.input = _push_proj(p.input, inner_req)
        return p
    if isinstance(plan, lp.Join):
        p = copy.copy(plan)
        lreq: Optional[set[str]] = None
        rreq: Optional[set[str]] = None
        if required is not None:
            ls, rs = p.left.schema, p.right.schema
            lreq, rreq = set(), set()
            for name in required:
                if ls.get_field_index(name) >= 0:
                    lreq.add(name)
                elif rs.get_field_index(name) >= 0:
                    rreq.add(name)
            for lk, rk in p.on:
                lreq.add(ls.field(lk.resolve_index(ls)).name)
                rreq.add(rs.field(rk.resolve_index(rs)).name)
            if p.filter is not None:
                for c in ex.find_columns(p.filter):
                    for s, tgt in ((ls, lreq), (rs, rreq)):
                        try:
                            tgt.add(s.field(c.resolve_index(s)).name)
                            break
                        except PlanError:
                            continue
        p.left = _push_proj(p.left, lreq)
        p.right = _push_proj(p.right, rreq)
        return p
    if isinstance(plan, lp.CrossJoin):
        p = copy.copy(plan)
        lreq: Optional[set[str]] = None
        rreq: Optional[set[str]] = None
        if required is not None:
            ls, rs = p.left.schema, p.right.schema
            lreq, rreq = set(), set()
            for name in required:
                if ls.get_field_index(name) >= 0:
                    lreq.add(name)
                elif rs.get_field_index(name) >= 0:
                    rreq.add(name)
        p.left = _push_proj(p.left, lreq)
        p.right = _push_proj(p.right, rreq)
        return p
    if isinstance(plan, lp.Union):
        p = copy.copy(plan)
        p.inputs = [_push_proj(c, None) for c in p.inputs]
        return p
    if isinstance(plan, lp.TableScan):
        if required is None:
            return plan
        # required holds qualified flat names; scan projection wants the
        # provider's unqualified names, in provider schema order
        unq = {n.split(".")[-1] for n in required}
        for f in plan.filters:
            for c in ex.find_columns(f):
                unq.add(c.cname)
        cols = [f.name for f in plan.provider.schema if f.name in unq]
        if not cols and len(plan.provider.schema) > 0:
            # a column-free scan would lose the row count (batches with no
            # arrays have num_rows 0) — count(*)-only queries need one
            # column kept; pick the narrowest
            def width(f: "object") -> int:
                try:
                    return f.type.bit_width
                except Exception:
                    return 1 << 16  # strings/nested sort last
            narrowest = min(plan.provider.schema, key=width)
            cols = [narrowest.name]
        return lp.TableScan(plan.table_name, plan.provider, cols, plan.filters)
    return plan
