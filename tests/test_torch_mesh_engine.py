"""The PyTorch port's mesh gang inside the engine, against the JAX package.

Twins of ``tests/test_mesh_engine.py``'s cases: the local ``SessionContext``
and the distributed planner put a ``MeshGangExec`` exactly where the JAX
package does (its default config turns the mesh on), the gang's answers
equal the CPU operators' and the reference gang's, its serde round trip,
the sort route, the gid and keyed high-cardinality gangs and the
sequential fallback.  The port's CPU mesh gets the reference's 8 shards
from a fixture, and its kernels run their plain twins.  Also: a kernel
failure inside a gang raises and is not re-run sequentially.  Tolerance:
floats within rel 1e-9 (1e-6 where the reference's own test allows it),
everything else exact.
"""

import glob
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.parallel import mesh as TM
from arrow_ballista_tpu_torch.parallel.mesh_stage import MeshGangExec
from benchmarks.tpch.datagen import gen_lineitem, gen_table
from benchmarks.tpch.queries import QUERIES

REL = 1e-9
OFF = {"ballista.mesh.enable": "false", "ballista.tpu.enable": "false"}


@pytest.fixture(autouse=True)
def cpu8(monkeypatch):
    """The port's CPU mesh spans 8 shards, as the reference's does here."""
    monkeypatch.setattr(TM, "CPU_DEVICES", 8)


def _settings(**extra):
    s = {"ballista.tpu.min_rows": "0", "ballista.shuffle.partitions": "2"}
    s.update({k: str(v) for k, v in extra.items()})
    return s


def _port(**extra):
    return tbt.SessionContext(tbt.BallistaConfig(_settings(**extra)), device="cpu")


def _ref(**extra):
    return jbt.SessionContext(jbt.BallistaConfig(_settings(**extra)))


def _register(ctx, names=("lineitem",), partitions=4):
    for name in names:
        ctx.register_arrow_table(name, gen_table(name, 0.01), partitions=partitions)


def _find(plan, cls_name):
    out, stack = [], [plan]
    while stack:
        n = stack.pop()
        if type(n).__name__ == cls_name:
            out.append(n)
        stack.extend(n.children())
    return out


def _shape(plan, depth=0) -> list:
    """The plan's operator tree as (depth, name), the two packages' device
    stages under one name."""
    name = type(plan).__name__.replace("Tpu", "Device").replace("Torch", "Device")
    out = [(depth, name)]
    for c in plan.children():
        out.extend(_shape(c, depth + 1))
    return out


def _assert_tables_close(got, want, rel=REL):
    assert got.num_rows == want.num_rows
    for name in want.schema.names:
        for x, y in zip(got.column(name).to_pylist(), want.column(name).to_pylist()):
            if isinstance(x, float) and x is not None and y is not None:
                assert y == pytest.approx(x, rel=rel), name
            else:
                assert x == y, name


def _sorted(t, keys):
    return t.sort_by([(k, "ascending") for k in keys])


# ------------------------------------------------------------ local engine
H2O_SQL = "select id1, sum(v1) as s, count(*) as c from x group by id1"


def _h2o(n=3000, seed=7):
    rng = np.random.default_rng(seed)
    return pa.table({
        "id1": pa.array([f"id{k:03d}" for k in rng.integers(0, 50, n)]),
        "v1": pa.array(rng.integers(1, 6, n), pa.int64()),
    })


@pytest.mark.parametrize("q", ["q1", "q3", "h2o"])
@pytest.mark.parametrize("mesh", [True, False])
def test_local_plan_matches_reference_plan(q, mesh):
    """Default config (mesh on): the same operator tree as the JAX
    package's, MeshGangExec where it has one; mesh off: none in either."""
    extra = {} if mesh else {"ballista.mesh.enable": "false"}
    plans = []
    for ctx in (_port(**extra), _ref(**extra)):
        if q == "h2o":
            ctx.register_arrow_table("x", _h2o(), partitions=4)
            plans.append(ctx.sql(H2O_SQL).physical_plan())
        else:
            _register(ctx, ("lineitem", "orders", "customer"))
            plans.append(ctx.sql(QUERIES[int(q[1:])]).physical_plan())
    assert _shape(plans[0]) == _shape(plans[1])
    has_gang = any(n == "MeshGangExec" for _, n in _shape(plans[0]))
    # q3's gang wraps a join-folded stage, which runs partition by partition
    assert has_gang == mesh


def test_local_plan_contains_mesh_gang():
    ctx = _port()
    _register(ctx)
    assert "MeshGangExec" in ctx.sql(QUERIES[1]).explain()


def test_local_q1_mesh_uses_collectives_and_matches():
    ctx = _port()
    _register(ctx)
    plan = ctx.sql(QUERIES[1]).physical_plan()
    got = ctx.execute(plan)
    gangs = _find(plan, "MeshGangExec")
    assert gangs, "no MeshGangExec in executed plan"
    m = gangs[0].metrics.to_dict()
    assert m.get("mesh_devices") == 8, m
    assert m.get("mesh_rows_in", 0) > 0, m
    assert "mesh_fallback" not in m, m

    off = _port(**OFF)
    _register(off)
    _assert_tables_close(got, off.sql(QUERIES[1]).collect())
    ref = _ref()
    _register(ref)
    _assert_tables_close(got, ref.sql(QUERIES[1]).collect())


# ------------------------------------------------------- distributed plan
def _stages(pkg, sql, settings, names=("lineitem",)):
    from importlib import import_module

    ctx = (tbt.SessionContext(pkg.BallistaConfig(settings), device="cpu")
           if pkg is tbt else pkg.SessionContext(pkg.BallistaConfig(settings)))
    if names == ("x",):
        ctx.register_arrow_table("x", _h2o(), partitions=4)
    else:
        _register(ctx, names)
    root = pkg.__name__
    phys = import_module(f"{root}.exec.planner").PhysicalPlanner(
        ctx.config
    ).create_physical_plan(ctx.sql(sql).optimized_plan())
    planner = import_module(f"{root}.scheduler.planner").DistributedPlanner
    return planner("/tmp/unused", ctx.config).plan_query_stages("jobx", phys)


def test_distributed_planner_gangs_partial_agg_stage():
    stages = _stages(tbt, QUERIES[1], _settings(**{"ballista.tpu.enable": "true"}))
    gang_stages = [s for s in stages if isinstance(s.input, MeshGangExec)]
    assert gang_stages, "partial-agg stage was not gang-wrapped"
    for s in gang_stages:
        assert s.output_partitioning().n == 1  # one task for the scheduler


@pytest.mark.parametrize("q", ["q1", "q3", "h2o"])
@pytest.mark.parametrize("mesh", [True, False])
def test_distributed_stages_match_reference(q, mesh):
    """The port's distributed planner emits the JAX package's stages: the
    same operator trees (MeshGangExec / MeshRepartitionExec with the mesh
    on, neither with it off) and the same output partitionings."""
    settings = _settings() if mesh else _settings(**{"ballista.mesh.enable": "false"})
    if q == "h2o":
        sql, names = H2O_SQL, ("x",)
    else:
        sql, names = QUERIES[int(q[1:])], ("lineitem", "orders", "customer")
    got = _stages(tbt, sql, settings, names)
    want = _stages(jbt, sql, settings, names)
    assert [_shape(s) for s in got] == [_shape(s) for s in want]
    assert [s.output_partitioning().n for s in got] == [
        s.output_partitioning().n for s in want
    ]
    mesh_nodes = [n for s in got for _, n in _shape(s)
                  if n in ("MeshGangExec", "MeshRepartitionExec")]
    assert bool(mesh_nodes) == mesh


def test_mesh_gang_serde_roundtrip():
    from arrow_ballista_tpu_torch.serde import BallistaCodec

    stages = _stages(tbt, QUERIES[6], _settings())
    gang = next(s for s in stages if isinstance(s.input, MeshGangExec))
    blob = BallistaCodec.encode_physical(gang)
    back = BallistaCodec.decode_physical(blob, "/tmp/unused")
    assert isinstance(back.input, MeshGangExec)
    assert back.input.n_devices == gang.input.n_devices
    assert str(back.input.input.schema) == str(gang.input.input.schema)


# ------------------------------------------------- distributed end-to-end
def test_distributed_q1_zero_shuffle_files_matches_flight_path(tmp_path):
    """q1 through the port's BallistaContext with the mesh gang and the
    memory data plane writes NO shuffle files and matches the disk+Flight
    answer (and the reference cluster's)."""
    from arrow_ballista_tpu_torch.shuffle import memory_store

    pq.write_table(gen_lineitem(0.01), str(tmp_path / "lineitem.parquet"))

    def run(mesh: bool, work_dir: str):
        flag = str(mesh).lower()
        cfg = tbt.BallistaConfig(_settings(**{
            "ballista.mesh.enable": flag, "ballista.shuffle.to_memory": flag,
            "ballista.tpu.enable": flag,
        }))
        bctx = tbt.BallistaContext.standalone(config=cfg, work_dir=work_dir, device="cpu")
        try:
            bctx.register_parquet("lineitem", str(tmp_path / "lineitem.parquet"))
            out = bctx.sql(QUERIES[1]).collect()
            return out, memory_store.job_ids()
        finally:
            bctx.close()

    flight_dir = str(tmp_path / "wd_flight")
    mesh_dir = str(tmp_path / "wd_mesh")
    want, _ = run(False, flight_dir)
    memory_store.clear()
    got, mem_jobs = run(True, mesh_dir)

    assert glob.glob(os.path.join(flight_dir, "**", "*.arrow"), recursive=True)
    assert not glob.glob(os.path.join(mesh_dir, "**", "*.arrow"), recursive=True)
    assert mem_jobs
    assert not memory_store.job_ids()
    keys = got.column_names[:2]
    _assert_tables_close(_sorted(got, keys), _sorted(want, keys))


def test_gang_streaming_shards_unequal_partitions():
    """Unequal partition sizes and 5 partitions over 8 shards: three
    shards hold nothing and reduce as identities; answers still match."""
    from arrow_ballista_tpu_torch.catalog import MemoryTable

    rng = np.random.default_rng(3)
    n = 10_000
    t = pa.table({
        "g": pa.array(rng.integers(0, 7, n), pa.int64()),
        "v": pa.array(rng.uniform(0, 100, n)),
    })
    sql = "select g, sum(v), count(*), min(v), max(v) from t group by g order by g"
    ctx = _port()
    ctx.register_table("t", MemoryTable.from_table(t, 5))
    off = _port(**OFF)
    off.register_table("t", MemoryTable.from_table(t, 5))
    plan = ctx.sql(sql).physical_plan()
    got = ctx.execute(plan)
    gangs = _find(plan, "MeshGangExec")
    assert gangs and "mesh_fallback" not in gangs[0].metrics.to_dict()
    assert gangs[0].metrics.to_dict().get("mesh_devices") == 8
    _assert_tables_close(got, off.sql(sql).collect())


def test_memory_partitions_served_over_flight(tmp_path):
    """Cross-executor reads of memory partitions go through DoGet."""
    from arrow_ballista_tpu_torch.flight.client import BallistaClient
    from arrow_ballista_tpu_torch.flight.server import FlightServerHandle
    from arrow_ballista_tpu_torch.shuffle import memory_store

    batch = pa.record_batch({"x": pa.array([1, 2, 3], pa.int64())})
    path = memory_store.put("jobf", 1, 0, 0, batch.schema, [batch])
    handle = FlightServerHandle(str(tmp_path), "127.0.0.1", 0).start()
    try:
        client = BallistaClient.get("127.0.0.1", handle.port)
        got = list(client.fetch_partition("jobf", 1, 0, path))
        assert sum(b.num_rows for b in got) == 3
    finally:
        handle.shutdown()
        memory_store.delete_job("jobf")


def test_mesh_gang_with_sort_algorithm():
    """Forced sort route: each shard reduces through the radix sort and
    segmented scan, then the cross-shard reduce."""
    TK.set_agg_algorithm("sort")
    try:
        ctx = _port()
        _register(ctx)
        plan = ctx.sql(QUERIES[1]).physical_plan()
        got = ctx.execute(plan)
        gangs = _find(plan, "MeshGangExec")
        assert gangs
        assert "mesh_fallback" not in gangs[0].metrics.to_dict()
    finally:
        TK.set_agg_algorithm(None)
    off = _port(**OFF)
    _register(off)
    key = ["l_returnflag", "l_linestatus"]
    _assert_tables_close(_sorted(got, key), _sorted(off.sql(QUERIES[1]).collect(), key), rel=1e-6)


def test_mesh_gang_highcard_gid_mode():
    """highcard_mode=gid pins a groups~rows aggregate on the gang's
    GID-TABLE path (no mesh_fallback, no keyed gang) with the sort route."""
    rng = np.random.default_rng(13)
    n = 1 << 15
    tbl = pa.table({
        "g": pa.array(rng.permutation(n).astype(np.int64)),
        "v": pa.array(rng.uniform(0, 100, n)),
    })
    sql = "select g, sum(v) as s, count(*) as c from t group by g"
    off = _port(**OFF)
    off.register_arrow_table("t", tbl, partitions=4)
    want = _sorted(off.sql(sql).collect(), ["g"])
    TK.set_agg_algorithm("sort")
    try:
        ctx = _port(**{"ballista.tpu.highcard_mode": "gid",
                       "ballista.tpu.max_capacity": str(1 << 17)})
        ctx.register_arrow_table("t", tbl, partitions=4)
        plan = ctx.sql(sql).physical_plan()
        got = ctx.execute(plan)
        gangs = _find(plan, "MeshGangExec")
        assert gangs
        m = gangs[0].metrics.to_dict()
        assert "mesh_fallback" not in m, m
        assert "mesh_keyed" not in m, m
    finally:
        TK.set_agg_algorithm(None)
    _assert_tables_close(_sorted(got, ["g"]), want, rel=1e-6)


def _highcard_table(n, seed, with_w=False):
    rng = np.random.default_rng(seed)
    g = np.arange(n) % (n // 8)  # every group in every partition
    cols = {"g": pa.array(g.astype(np.int64)), "v": pa.array(rng.uniform(0, 100, n))}
    if with_w:
        cols["w"] = pa.array(rng.integers(0, 1000, n).astype(np.int64))
    return pa.table(cols)


def test_mesh_gang_highcard_keyed_across_shards(monkeypatch):
    """highcard_mode=device: a groups~rows gang runs the KEYED route per
    shard and merges the shards' states by key on the host (mesh_keyed);
    groups straddle shards.  The reference's keyed gang gives the same."""
    from arrow_ballista_tpu.ops import stage_compiler as JSC
    from arrow_ballista_tpu_torch.ops import stage_compiler as TSC

    monkeypatch.setattr(TSC, "HIGHCARD_MIN_GROUPS", 1024)
    monkeypatch.setattr(JSC, "_HIGHCARD_MIN_GROUPS", 1024)
    tbl = _highcard_table(1 << 15, 31, with_w=True)
    sql = ("select g, sum(v) as s, count(*) as c, min(w) as mn, max(w) as mx "
           "from t group by g")
    off = _port(**OFF)
    off.register_arrow_table("t", tbl, partitions=4)
    want = _sorted(off.sql(sql).collect(), ["g"])
    extra = {"ballista.tpu.max_capacity": str(1 << 17),
             "ballista.tpu.highcard_mode": "device"}
    ctx = _port(**extra)
    ctx.register_arrow_table("t", tbl, partitions=4)
    plan = ctx.sql(sql).physical_plan()
    got = ctx.execute(plan)
    gangs = _find(plan, "MeshGangExec")
    assert gangs
    m = gangs[0].metrics.to_dict()
    assert m.get("mesh_keyed", 0) >= 1, m
    assert "mesh_fallback" not in m, m
    assert m.get("mesh_devices") == 8, m
    _assert_tables_close(_sorted(got, ["g"]), want, rel=1e-6)
    ref = _ref(**extra)
    ref.register_arrow_table("t", tbl, partitions=4)
    _assert_tables_close(_sorted(got, ["g"]), _sorted(ref.sql(sql).collect(), ["g"]), rel=1e-6)


def test_mesh_gang_highcard_auto_cpu_sequential_fallback(monkeypatch):
    """'auto' does not take the keyed route here: a groups~rows gang falls
    back to the sequential path (each partition to the CPU hash
    aggregate), NOT the keyed gang, and results still match."""
    from arrow_ballista_tpu_torch.ops import stage_compiler as TSC

    monkeypatch.setattr(TSC, "HIGHCARD_MIN_GROUPS", 1024)
    tbl = _highcard_table(1 << 14, 37)
    sql = "select g, sum(v) as s, count(*) as c from t group by g"
    off = _port(**OFF)
    off.register_arrow_table("t", tbl, partitions=4)
    want = _sorted(off.sql(sql).collect(), ["g"])
    ctx = _port()
    ctx.register_arrow_table("t", tbl, partitions=4)
    plan = ctx.sql(sql).physical_plan()
    got = ctx.execute(plan)
    gangs = _find(plan, "MeshGangExec")
    assert gangs
    m = gangs[0].metrics.to_dict()
    assert m.get("mesh_fallback", 0) >= 1, m
    assert "mesh_keyed" not in m, m
    _assert_tables_close(_sorted(got, ["g"]), want, rel=1e-6)


# ----------------------------------------------------- device errors raise
def test_reduce_failure_inside_gang_raises_without_rerun(monkeypatch):
    """A RuntimeError from the cross-shard reduce (as a failed launch
    raises) propagates out of the gang: no mesh_fallback, and the stage
    never re-runs partition by partition (the reference would)."""
    from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec

    def boom(specs, states):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    reruns = []
    real_execute = TorchStageExec.execute

    def counting_execute(self, partition, ctx):
        reruns.append(partition)
        return real_execute(self, partition, ctx)

    monkeypatch.setattr(TM, "mesh_reduce", boom)
    monkeypatch.setattr(TorchStageExec, "execute", counting_execute)
    ctx = _port()
    _register(ctx)
    plan = ctx.sql(QUERIES[1]).physical_plan()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        ctx.execute(plan)
    gang = _find(plan, "MeshGangExec")[0]
    assert "mesh_fallback" not in gang.metrics.to_dict()
    assert reruns == []
