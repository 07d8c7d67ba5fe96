"""Local (single-process) session context of the PyTorch port.

This is the single-node engine entry point — the role DataFusion's
``SessionContext`` plays under the reference's ``BallistaContext``
(``client/src/context.rs:78-460``).  It equals the JAX package's
``context.py`` except that a session carries the torch device its device
stages run on, and physical planning installs the port's
``TorchStageExec`` (no mesh pass: the mesh is not ported).
"""

from __future__ import annotations

import datetime as _dt
from typing import Optional

import pyarrow as pa

from .catalog import Catalog, CsvTable, MemoryTable, ParquetTable, TableProvider
from .config import BallistaConfig
from .errors import ExecutionError, PlanError, SqlError
from .exec.operators import ExecutionPlan, TaskContext, collect
from .exec.planner import PhysicalPlanner
from .plan import logical as lp
from .plan.builder import PlanBuilder, sql_type_to_arrow
from .plan.optimizer import optimize
from .sql import ast
from .sql.parser import parse_sql


class DataFrame:
    """Lazy query handle (reference: DataFusion DataFrame via
    BallistaContext::sql / read_parquet)."""

    def __init__(self, ctx: "SessionContext", plan: lp.LogicalPlan):
        self.ctx = ctx
        self.plan = plan

    # -- transformations -------------------------------------------------
    def select(self, *exprs) -> "DataFrame":
        from .plan import expressions as ex

        exprs = [ex.col(e) if isinstance(e, str) else e for e in exprs]
        return type(self)(self.ctx, lp.Projection(list(exprs), self.plan))

    def filter(self, predicate) -> "DataFrame":
        return type(self)(self.ctx, lp.Filter(predicate, self.plan))

    def aggregate(self, group_by: list, aggs: list) -> "DataFrame":
        return type(self)(self.ctx, lp.Aggregate(list(group_by), list(aggs), self.plan))

    def sort(self, *sort_exprs) -> "DataFrame":
        from .plan import expressions as ex

        fixed = []
        for e in sort_exprs:
            if isinstance(e, str):
                e = ex.col(e).sort()
            elif not isinstance(e, ex.SortExpr):
                e = e.sort()
            fixed.append(e)
        return type(self)(self.ctx, lp.Sort(fixed, self.plan))

    def limit(self, n: int, offset: int = 0) -> "DataFrame":
        return type(self)(self.ctx, lp.Limit(self.plan, offset, n))

    def join(self, right: "DataFrame", on: list, how: str = "inner") -> "DataFrame":
        from .plan import expressions as ex

        pairs = []
        for item in on:
            if isinstance(item, str):
                pairs.append((ex.col(item), ex.col(item)))
            else:
                l, r = item
                pairs.append(
                    (
                        ex.col(l) if isinstance(l, str) else l,
                        ex.col(r) if isinstance(r, str) else r,
                    )
                )
        return type(self)(self.ctx, lp.Join(self.plan, right.plan, pairs, how, None))

    def union(self, other: "DataFrame") -> "DataFrame":
        return type(self)(self.ctx, lp.Union([self.plan, other.plan]))

    def distinct(self) -> "DataFrame":
        return type(self)(self.ctx, lp.Distinct(self.plan))

    # -- actions ---------------------------------------------------------
    @property
    def schema(self) -> pa.Schema:
        return self.plan.schema

    def logical_plan(self) -> lp.LogicalPlan:
        return self.plan

    def optimized_plan(self) -> lp.LogicalPlan:
        return optimize(self.plan)

    def physical_plan(self) -> ExecutionPlan:
        return self.ctx.create_physical_plan(self.optimized_plan())

    def collect(self) -> pa.Table:
        return _unqualify(self.ctx.execute(self.physical_plan()))

    def to_pandas(self):
        return self.collect().to_pandas()

    def count(self) -> int:
        return self.collect().num_rows

    def explain(self) -> str:
        phys = self.physical_plan()
        return (
            "== Logical Plan ==\n"
            + self.optimized_plan().display()
            + "\n== Physical Plan ==\n"
            + phys.display()
        )

    def show(self, n: int = 20) -> None:
        print(self.limit(n).collect().to_pandas().to_string())


class SessionContext:
    def __init__(
        self, config: Optional[BallistaConfig] = None, device=None
    ):
        """``device`` is where the device stages run: None means
        ``"cuda"``, and a session without a CUDA device raises unless the
        caller asks for ``"cpu"`` (the stages then run the kernels' plain
        PyTorch versions) — it never drops to the CPU on its own."""
        from .udf import UdfRegistry, global_registry, load_udf_plugins

        self.device = _resolve_device(device)
        self.config = config or BallistaConfig()
        self.catalog = Catalog()
        self.session_id = _gen_id()
        self.variables: dict[str, str] = {}
        # session UDFs shadow the process-global registry (plugins)
        self.udfs = UdfRegistry(parent=global_registry())
        from .config import PLUGIN_DIR

        plugin_dir = self.config.settings.get(PLUGIN_DIR, "")
        if plugin_dir:
            load_udf_plugins(plugin_dir)

    def fork(self) -> "SessionContext":
        """Statement-scoped view of this session: shares config/UDFs/
        variables and SEES the same tables, but owns a private catalog
        copy so CTE registration (``_sql_with_ctes`` mutates the catalog)
        cannot race concurrent statements on a shared session — the
        FlightSQL front-end runs every query on a fork."""
        child = SessionContext.__new__(SessionContext)
        child.config = self.config
        child.device = self.device
        child.catalog = Catalog()
        child.catalog.tables = dict(self.catalog.tables)
        child.session_id = self.session_id
        child.variables = dict(self.variables)
        child.udfs = self.udfs
        return child

    # -- registration ----------------------------------------------------
    def register_table(self, name: str, provider: TableProvider) -> None:
        self.catalog.register(name, provider)

    def register_parquet(self, name: str, path: str) -> None:
        self.catalog.register(name, ParquetTable(path))

    def register_csv(
        self,
        name: str,
        path: str,
        schema: Optional[pa.Schema] = None,
        has_header: bool = True,
        delimiter: str = ",",
    ) -> None:
        self.catalog.register(name, CsvTable(path, schema, has_header, delimiter))

    def register_avro(self, name: str, path: str) -> None:
        from .catalog import AvroTable

        self.catalog.register(name, AvroTable(path))

    def read_avro(self, path: str) -> DataFrame:
        name = f"__anon_avro_{_gen_id()[:6]}"
        self.register_avro(name, path)
        return self.table(name)

    def register_record_batches(
        self, name: str, partitions: list[list[pa.RecordBatch]]
    ) -> None:
        self.catalog.register(name, MemoryTable(partitions))

    def register_arrow_table(self, name: str, table: pa.Table, partitions: int = 1) -> None:
        self.catalog.register(name, MemoryTable.from_table(table, partitions))

    def deregister_table(self, name: str) -> None:
        self.catalog.deregister(name)

    # -- user-defined functions ------------------------------------------
    def register_udf(self, udf) -> None:
        """Register a ScalarUDF for this session AND process-wide, so
        in-proc executors (standalone mode) can resolve it at evaluation
        time — the distributed analogue is the executor's plugin dir."""
        from .udf import global_registry

        self.udfs.register_scalar(udf)
        global_registry().register_scalar(udf)

    def register_udaf(self, udaf) -> None:
        from .udf import global_registry

        self.udfs.register_aggregate(udaf)
        global_registry().register_aggregate(udaf)

    def read_parquet(self, path: str) -> DataFrame:
        name = f"__anon_parquet_{_gen_id()[:6]}"
        self.register_parquet(name, path)
        return self.table(name)

    def read_csv(self, path: str, **kw) -> DataFrame:
        name = f"__anon_csv_{_gen_id()[:6]}"
        self.register_csv(name, path, **kw)
        return self.table(name)

    def table(self, name: str) -> DataFrame:
        provider = self.catalog.get(name)
        return DataFrame(self, lp.TableScan(name.lower(), provider))

    # -- SQL -------------------------------------------------------------
    def sql(self, query: str, stmt: Optional[ast.Statement] = None) -> DataFrame:
        """Run a SQL statement.  ``stmt`` lets a caller that already parsed
        the text (FlightSQL's Query/DDL dispatch) skip the second parse."""
        if stmt is None:
            stmt = parse_sql(query)
        if isinstance(stmt, ast.Query):
            if stmt.ctes:
                return self._sql_with_ctes(stmt)
            builder = PlanBuilder(self.catalog, self.udfs)
            return DataFrame(self, builder.build_query(stmt))
        if isinstance(stmt, ast.CreateExternalTable):
            return self._create_external_table(stmt)
        if isinstance(stmt, ast.ShowStmt):
            return self._show(stmt)
        if isinstance(stmt, ast.SetVariable):
            self.variables[stmt.name] = stmt.value
            if stmt.name.startswith("ballista."):
                settings = self.config.to_dict()
                settings[stmt.name] = stmt.value
                self.config = BallistaConfig.from_dict(settings)
            return self._values_df(pa.table({"result": pa.array(["ok"])}))
        if isinstance(stmt, ast.Explain):
            builder = PlanBuilder(self.catalog, self.udfs)
            df = DataFrame(self, builder.build_query(stmt.query))
            if stmt.analyze:
                # EXPLAIN ANALYZE (reference: DataFusion's analyze plan):
                # execute the physical plan, then render it annotated
                # with every operator's runtime metrics
                import time as _time

                phys = df.physical_plan()
                t0 = _time.perf_counter()
                self.execute(phys)
                elapsed = _time.perf_counter() - t0
                text = (
                    phys.display(with_metrics=True)
                    + f"\nelapsed: {elapsed:.6f}s"
                )
                return self._values_df(
                    pa.table(
                        {"plan_type": ["explain analyze"], "plan": [text]}
                    )
                )
            text = df.explain()
            return self._values_df(
                pa.table({"plan_type": ["explain"], "plan": [text]})
            )
        if isinstance(stmt, ast.DropTable):
            if stmt.name.lower() not in self.catalog.tables and not stmt.if_exists:
                raise PlanError(f"table {stmt.name!r} does not exist")
            self.deregister_table(stmt.name)
            return self._values_df(pa.table({"result": pa.array(["ok"])}))
        raise SqlError(f"unsupported statement {type(stmt).__name__}")

    def _sql_with_ctes(self, stmt: ast.Query) -> DataFrame:
        """Materialize each WITH-clause query ONCE and expose it as an
        in-memory table to the main query (and to later CTEs).

        Eager single evaluation (rather than inline expansion at every
        reference) both avoids recomputation and guarantees bit-identical
        results across references — q15's ``total_revenue = (select
        max(total_revenue) from revenue0)`` float equality depends on it.
        """
        import dataclasses

        # (name, previously-registered provider or None) so a CTE that
        # shadows a real table restores it afterwards
        registered: list[tuple[str, Optional[TableProvider]]] = []
        try:
            for name, sub in stmt.ctes:
                shadowed = self.catalog.tables.get(name.lower())
                sub_df = self.sql_query_ast(sub)
                tbl = sub_df.collect()
                self.catalog.register(
                    name,
                    MemoryTable.from_table(tbl, self.config.shuffle_partitions),
                )
                registered.append((name, shadowed))
            main = dataclasses.replace(stmt, ctes=[])
            builder = PlanBuilder(self.catalog, self.udfs)
            return DataFrame(self, builder.build_query(main))
        finally:
            for name, shadowed in registered:
                self.catalog.deregister(name)
                if shadowed is not None:
                    self.catalog.register(name, shadowed)

    def sql_query_ast(self, q: ast.Query) -> DataFrame:
        if q.ctes:
            return self._sql_with_ctes(q)
        return DataFrame(self, PlanBuilder(self.catalog, self.udfs).build_query(q))

    def _create_external_table(self, stmt: ast.CreateExternalTable) -> DataFrame:
        if stmt.name.lower() in self.catalog.tables and stmt.if_not_exists:
            return self._values_df(pa.table({"result": pa.array(["exists"])}))
        schema = None
        if stmt.columns:
            schema = pa.schema(
                [pa.field(n, sql_type_to_arrow(t)) for n, t in stmt.columns]
            )
        ft = stmt.file_type.upper()
        if ft == "PARQUET":
            self.register_parquet(stmt.name, stmt.location)
        elif ft == "CSV":
            self.catalog.register(
                stmt.name,
                CsvTable(stmt.location, schema, stmt.has_header, stmt.delimiter),
            )
        elif ft == "AVRO":
            self.register_avro(stmt.name, stmt.location)
        else:
            raise SqlError(f"unsupported file type {stmt.file_type}")
        return self._values_df(pa.table({"result": pa.array(["ok"])}))

    def _show(self, stmt: ast.ShowStmt) -> DataFrame:
        what = [p.upper() for p in stmt.variable]
        if what[:1] == ["TABLES"]:
            return self._values_df(
                pa.table({"table_name": pa.array(self.catalog.names())})
            )
        if what[:1] == ["COLUMNS"]:
            tname = stmt.variable[-1]
            schema = self.catalog.get(tname).schema
            return self._values_df(
                pa.table(
                    {
                        "column_name": pa.array(schema.names),
                        "data_type": pa.array([str(f.type) for f in schema]),
                        "is_nullable": pa.array(
                            ["YES" if f.nullable else "NO" for f in schema]
                        ),
                    }
                )
            )
        raise SqlError(f"unsupported SHOW {' '.join(stmt.variable)}")

    def _values_df(self, tbl: pa.Table) -> DataFrame:
        # ephemeral relation: not registered in the catalog so it never
        # leaks into SHOW TABLES or error messages
        provider = MemoryTable.from_table(tbl)
        return DataFrame(self, lp.TableScan("__result", provider))

    # -- execution -------------------------------------------------------
    def create_physical_plan(self, logical: lp.LogicalPlan) -> ExecutionPlan:
        phys = PhysicalPlanner(self.config).create_physical_plan(logical)
        from .ops.stage_compiler import maybe_accelerate

        return maybe_accelerate(phys, self.config, self.device)

    def execute(self, plan: ExecutionPlan) -> pa.Table:
        return collect(plan, self.task_context())

    def task_context(self) -> TaskContext:
        return TaskContext(session_id=self.session_id, config=self.config)


def _unqualify(tbl: pa.Table) -> pa.Table:
    """Strip relation qualifiers from output column names (user-facing
    results use bare names, like DataFusion's RecordBatch output)."""
    new = [n.split(".")[-1] for n in tbl.schema.names]
    if len(set(new)) != len(new):
        return tbl
    return tbl.rename_columns(new)


def _resolve_device(device):
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ExecutionError(
            "no CUDA device: pass device='cpu' to run the device stages "
            "on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ExecutionError(f"unsupported device {dev}")
    return dev


def _gen_id() -> str:
    """7-char alphanumeric id (reference: task_manager.rs:544-551)."""
    import random
    import string

    return "".join(random.choices(string.ascii_lowercase + string.digits, k=7))
