"""The PyTorch port's distributed path: ``BallistaContext.standalone``
through the port's own scheduler, executors, shuffle and Flight.

Twin of ``tests/test_standalone_cluster.py``: the same queries and flows
(pull and push mode, aggregate, join, q1, q6, the DataFrame API, SET, a
failed job, an empty result, SHOW TABLES, session config reaching the
executors), plus TPC-H q3, whose map stage hashes its shuffle partition
ids on the device (kernel B4).  The port's clusters run on
``device="cpu"`` (the kernels' plain twins) with ``tpu.min_rows=0``, so
every eligible stage takes the device route; each result is held against
the JAX package's standalone cluster (mesh off) and the local CPU
operators: floats within rel 1e-9, everything else exact.
"""

import os

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu.client import BallistaContext as JBallistaContext
from arrow_ballista_tpu_torch.client.context import BallistaDataFrame
from arrow_ballista_tpu_torch.config import TaskSchedulingPolicy
from arrow_ballista_tpu_torch.errors import ExecutionError
from arrow_ballista_tpu_torch.plan.expressions import col
from benchmarks.tpch.datagen import gen_table
from benchmarks.tpch.queries import QUERIES

REL = 1e-9
TPCH_TABLES = [
    "lineitem", "orders", "customer", "part", "supplier", "partsupp",
    "nation", "region",
]
SETTINGS = {"ballista.mesh.enable": "false", "ballista.tpu.min_rows": "0"}


@pytest.fixture(scope="module")
def tpch_parquet_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch-parquet")
    for name in TPCH_TABLES:
        tbl = gen_table(name, 0.01)
        tdir = d / name
        tdir.mkdir()
        n_parts = 2 if tbl.num_rows > 100 else 1
        per = (tbl.num_rows + n_parts - 1) // n_parts
        for i in range(n_parts):
            pq.write_table(tbl.slice(i * per, per), str(tdir / f"part-{i}.parquet"))
    return str(d)


def _register_all(ctx, d):
    for name in TPCH_TABLES:
        ctx.register_parquet(name, os.path.join(d, name))


def _port_cluster(d, policy=TaskSchedulingPolicy.PULL_STAGED, **settings):
    ctx = tbt.BallistaContext.standalone(
        tbt.BallistaConfig(dict(SETTINGS, **settings)),
        num_executors=2, concurrent_tasks=2, policy=policy, device="cpu",
    )
    _register_all(ctx, d)
    return ctx


@pytest.fixture(scope="module")
def pull_ctx(tpch_parquet_dir):
    ctx = _port_cluster(tpch_parquet_dir)
    yield ctx
    ctx.close()


@pytest.fixture(scope="module")
def push_ctx(tpch_parquet_dir):
    ctx = _port_cluster(tpch_parquet_dir, TaskSchedulingPolicy.PUSH_STAGED)
    yield ctx
    ctx.close()


@pytest.fixture(scope="module")
def ref_ctx(tpch_parquet_dir):
    """The JAX package's standalone cluster, mesh off."""
    ctx = JBallistaContext.standalone(
        jbt.BallistaConfig(dict(SETTINGS)), num_executors=1, concurrent_tasks=2
    )
    _register_all(ctx, tpch_parquet_dir)
    yield ctx
    ctx.close()


@pytest.fixture(scope="module")
def local_ctx(tpch_parquet_dir):
    """The port's local CPU operators."""
    ctx = tbt.SessionContext(
        tbt.BallistaConfig({"ballista.tpu.enable": "false"}), device="cpu"
    )
    _register_all(ctx, tpch_parquet_dir)
    return ctx


def _assert_same(got: pa.Table, want: pa.Table, what: str = ""):
    assert got.schema.names == want.schema.names, what
    assert got.num_rows == want.num_rows, what
    for name in got.schema.names:
        for x, y in zip(got.column(name).to_pylist(), want.column(name).to_pylist()):
            if isinstance(x, float) and y is not None:
                assert x == pytest.approx(y, rel=REL), (what, name)
            else:
                assert x == y, (what, name)


def _job_metrics(ctx, run) -> dict:
    """Run ``run()`` on the port's cluster; the new job's stage metrics,
    summed per operator name."""
    before = set(ctx._job_ids)
    out = run()
    (job_id,) = set(ctx._job_ids) - before
    scheduler, _ = ctx._standalone_handles
    detail = scheduler.server.state.task_manager.get_job_detail(job_id)
    sums: dict = {}
    for stage in detail["stages"]:
        for op, vals in (stage.get("metrics") or {}).items():
            acc = sums.setdefault(op, {})
            for k, v in vals.items():
                if isinstance(v, (int, float)):
                    acc[k] = acc.get(k, 0) + v
    return out, sums


QUERY_SQL = {
    "aggregate": (
        "SELECT l_returnflag, SUM(l_quantity) AS sum_qty, "
        "AVG(l_discount) AS avg_disc, COUNT(l_orderkey) AS n "
        "FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag"
    ),
    "filter_projection": (
        "SELECT l_orderkey, l_extendedprice * (1 - l_discount) AS revenue "
        "FROM lineitem WHERE l_quantity > 45 ORDER BY l_orderkey, revenue LIMIT 50"
    ),
    "join": (
        "SELECT c_mktsegment, COUNT(o_orderkey) AS n, SUM(o_totalprice) AS tp "
        "FROM customer JOIN orders ON c_custkey = o_custkey "
        "GROUP BY c_mktsegment ORDER BY c_mktsegment"
    ),
    "tpch_q1": QUERIES[1],
    "tpch_q6": QUERIES[6],
    "push_aggregate": (
        "SELECT l_shipmode, COUNT(l_orderkey) AS n FROM lineitem "
        "GROUP BY l_shipmode ORDER BY l_shipmode"
    ),
    "push_join": (
        "SELECT n_name, COUNT(c_custkey) AS n FROM nation "
        "JOIN customer ON n_nationkey = c_nationkey "
        "GROUP BY n_name ORDER BY n DESC, n_name LIMIT 5"
    ),
}


@pytest.mark.parametrize(
    "name", ["aggregate", "filter_projection", "join", "tpch_q1", "tpch_q6"]
)
def test_pull_mode_matches_reference(pull_ctx, ref_ctx, local_ctx, name):
    sql = QUERY_SQL[name]
    got = pull_ctx.sql(sql).collect()
    _assert_same(got, ref_ctx.sql(sql).collect(), f"{name} vs the JAX cluster")
    _assert_same(got, local_ctx.sql(sql).collect(), f"{name} vs the CPU operators")


@pytest.mark.parametrize("name", ["push_aggregate", "push_join"])
def test_push_mode_matches_reference(push_ctx, ref_ctx, local_ctx, name):
    sql = QUERY_SQL[name]
    got = push_ctx.sql(sql).collect()
    _assert_same(got, ref_ctx.sql(sql).collect(), f"{name} vs the JAX cluster")
    _assert_same(got, local_ctx.sql(sql).collect(), f"{name} vs the CPU operators")


def test_q1_runs_device_stages_with_host_pids(pull_ctx):
    """q1's keys are strings: its partial aggregate runs as TorchStageExec,
    and its shuffle ids stay on the host partitioner (the reference's own
    routing)."""
    _, metrics = _job_metrics(pull_ctx, lambda: pull_ctx.sql(QUERIES[1]).collect())
    stage = metrics.get("TorchStageExec", {})
    assert stage.get("input_rows", 0) > 0
    for k in ("tpu_fallback", "cpu_fallback", "highcard_fallback"):
        assert stage.get(k, 0) == 0, k
    assert metrics["ShuffleWriterExec"].get("device_pid_batches", 0) == 0


def test_tpch_q3_distributed_hashes_pids_on_device(pull_ctx, ref_ctx, local_ctx):
    got, metrics = _job_metrics(pull_ctx, lambda: pull_ctx.sql(QUERIES[3]).collect())
    _assert_same(got, ref_ctx.sql(QUERIES[3]).collect(), "q3 vs the JAX cluster")
    _assert_same(got, local_ctx.sql(QUERIES[3]).collect(), "q3 vs the CPU operators")
    stage = metrics.get("TorchStageExec", {})
    assert stage.get("input_rows", 0) > 0
    for k in ("tpu_fallback", "cpu_fallback", "highcard_fallback"):
        assert stage.get(k, 0) == 0, k
    # the aggregate reads the join of two shuffles: fragments coalesce
    assert stage.get("coalesced_source_batches", 0) > 0
    assert metrics["ShuffleWriterExec"].get("device_pid_batches", 0) > 0


def test_dataframe_api_distributed(pull_ctx, ref_ctx, local_ctx):
    def run(ctx):
        return (
            ctx.table("nation").filter(col("n_regionkey") == 1)
            .select("n_name", "n_regionkey").sort("n_name").collect()
        )

    got = run(pull_ctx)
    assert isinstance(pull_ctx.table("nation"), BallistaDataFrame)
    _assert_same(got, run(local_ctx))
    from arrow_ballista_tpu.plan.expressions import col as jcol

    want = (
        ref_ctx.table("nation").filter(jcol("n_regionkey") == 1)
        .select("n_name", "n_regionkey").sort("n_name").collect()
    )
    _assert_same(got, want)


def test_second_query_same_session(pull_ctx):
    a = pull_ctx.sql("SELECT COUNT(n_nationkey) AS c FROM nation").collect()
    b = pull_ctx.sql("SELECT COUNT(r_regionkey) AS c FROM region").collect()
    assert a.column("c")[0].as_py() == 25
    assert b.column("c")[0].as_py() == 5


def test_set_variable_roundtrip(pull_ctx):
    pull_ctx.sql("SET ballista.shuffle.partitions = 3")
    try:
        assert pull_ctx.config.shuffle_partitions == 3
        out = pull_ctx.sql(
            "SELECT l_linestatus, COUNT(l_orderkey) AS c FROM lineitem "
            "GROUP BY l_linestatus ORDER BY l_linestatus"
        ).collect()
        assert out.num_rows == 2
    finally:
        pull_ctx.sql("SET ballista.shuffle.partitions = 2")


def test_failed_job_propagates(pull_ctx, tmp_path):
    missing = str(tmp_path / "nope.parquet")
    pq.write_table(pa.table({"x": [1, 2, 3]}), missing)
    pull_ctx.register_parquet("doomed", missing)
    os.remove(missing)
    with pytest.raises(ExecutionError, match="failed"):
        pull_ctx.sql("SELECT SUM(x) AS s FROM doomed").collect()


def test_push_mode_sequential_jobs(push_ctx):
    for _ in range(3):
        out = push_ctx.sql("SELECT COUNT(s_suppkey) AS c FROM supplier").collect()
        assert out.column("c")[0].as_py() > 0


def test_empty_result_set_collects(pull_ctx):
    out = pull_ctx.sql(
        "SELECT l_orderkey FROM lineitem WHERE l_quantity > 1e9"
    ).collect()
    assert out.num_rows == 0
    assert "l_orderkey" in out.schema.names


def test_show_tables_stays_local(pull_ctx):
    df = pull_ctx.sql("SHOW TABLES")
    assert not isinstance(df, BallistaDataFrame)
    names = set(df.collect().column("table_name").to_pylist())
    assert {"lineitem", "orders"} <= names


def test_session_config_reaches_executors(tpch_parquet_dir):
    ctx = tbt.BallistaContext.standalone(
        tbt.BallistaConfig({"ballista.shuffle.partitions": "5"}),
        num_executors=1, device="cpu",
    )
    try:
        _register_all(ctx, tpch_parquet_dir)
        out = ctx.sql(
            "SELECT n_regionkey, COUNT(n_nationkey) AS c FROM nation "
            "GROUP BY n_regionkey ORDER BY n_regionkey"
        ).collect()
        assert out.num_rows == 5
        assert all(e.executor.device.type == "cpu" for e in ctx._standalone_handles[1])
    finally:
        ctx.close()
