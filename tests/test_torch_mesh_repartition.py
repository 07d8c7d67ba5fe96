"""The PyTorch port's MeshRepartitionExec against the JAX package.

Twins of ``tests/test_mesh_repartition.py``'s cases: the distributed
planner routes hash-repartition stages through the mesh exchange (q3's
lineitem and orders exchanges run on the port's 8-shard CPU mesh with no
shuffle files and match the Flight answer), serde, the type gate, exact
round trips, the capacity boundary and its retry, the row-ceiling
fallback and the pass-through.  The port's kernels run their plain twins;
the exchange's batches must equal the reference exchanger's exactly.
"""

import glob
import os

import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu.parallel import mesh as JM
from arrow_ballista_tpu_torch.parallel import mesh as TM
from arrow_ballista_tpu_torch.parallel.mesh_stage import (
    MeshGangExec,
    MeshRepartitionExec,
    exchange_supported,
)
from benchmarks.tpch.datagen import gen_table
from benchmarks.tpch.queries import QUERIES


@pytest.fixture(autouse=True)
def cpu8(monkeypatch):
    """The port's CPU mesh spans 8 shards, as the reference's does here;
    the reference exchanger pinned to x64."""
    assert len(jax.devices()) >= 8
    monkeypatch.setattr(TM, "CPU_DEVICES", 8)
    old = JK._PRECISION["mode"]
    JK.set_precision("x64")
    try:
        yield
    finally:
        JK.set_precision(old)


def _cfg(partitions=2, **extra):
    settings = {
        "ballista.tpu.min_rows": "0",
        "ballista.shuffle.partitions": str(partitions),
    }
    settings.update({k: str(v) for k, v in extra.items()})
    return tbt.BallistaConfig(settings)


def _stages_for(sql: str, cfg) -> list:
    from arrow_ballista_tpu_torch.exec.planner import PhysicalPlanner
    from arrow_ballista_tpu_torch.scheduler.planner import DistributedPlanner

    ctx = tbt.SessionContext(cfg, device="cpu")
    for name in ("lineitem", "orders", "customer"):
        ctx.register_arrow_table(name, gen_table(name, 0.01), partitions=4)
    phys = PhysicalPlanner(ctx.config).create_physical_plan(
        ctx.sql(sql).optimized_plan()
    )
    return DistributedPlanner("/tmp/unused", cfg).plan_query_stages("jobr", phys)


def test_planner_wraps_join_repartition_stages():
    stages = _stages_for(QUERIES[3], _cfg())
    mesh_parts = [s for s in stages if isinstance(s.input, MeshRepartitionExec)]
    assert mesh_parts, "no repartition stage was mesh-wrapped for q3"
    for s in mesh_parts:
        assert s.output_partitioning().n == 1
    q1_stages = _stages_for(QUERIES[1], _cfg())
    assert any(isinstance(s.input, MeshGangExec) for s in q1_stages)


def test_serde_roundtrip_mesh_repartition():
    from arrow_ballista_tpu_torch.serde import BallistaCodec

    stages = _stages_for(QUERIES[3], _cfg())
    writer = next(s for s in stages if isinstance(s.input, MeshRepartitionExec))
    blob = BallistaCodec.encode_physical(writer)
    back = BallistaCodec.decode_physical(blob, "/tmp/unused")
    assert isinstance(back.input, MeshRepartitionExec)
    assert back.input.partitioning.n == writer.input.partitioning.n
    assert [str(e) for e in back.input.partitioning.exprs] == [
        str(e) for e in writer.input.partitioning.exprs
    ]


def test_exchange_supported_gates_types():
    ok = pa.schema([("a", pa.int64()), ("b", pa.string()), ("c", pa.float64())])
    bad = pa.schema([("a", pa.decimal128(10, 2))])
    assert exchange_supported(ok)
    assert not exchange_supported(bad)


@pytest.fixture(scope="module")
def q3_parquet(tmp_path_factory):
    d = tmp_path_factory.mktemp("q3-parquet")
    for name in ("lineitem", "orders", "customer"):
        pq.write_table(gen_table(name, 0.01), str(d / f"{name}.parquet"))
    return d


def _q3_distributed(d, mesh: bool, work_dir: str, partitions=2, **extra):
    from arrow_ballista_tpu_torch.shuffle import memory_store

    flag = str(mesh).lower()
    cfg = _cfg(partitions=partitions, **{
        "ballista.mesh.enable": flag, "ballista.shuffle.to_memory": flag,
        "ballista.tpu.enable": flag, **extra,
    })
    bctx = tbt.BallistaContext.standalone(config=cfg, work_dir=work_dir, device="cpu")
    try:
        for name in ("lineitem", "orders", "customer"):
            bctx.register_parquet(name, str(d / f"{name}.parquet"))
        return bctx.sql(QUERIES[3]).collect()
    finally:
        bctx.close()
        memory_store.clear()


def _assert_tables_match(got, want):
    assert got.num_rows == want.num_rows
    keys = [(n, "ascending") for n in want.column_names]
    got, want = got.sort_by(keys), want.sort_by(keys)
    for name in want.column_names:
        for x, y in zip(got.column(name).to_pylist(), want.column(name).to_pylist()):
            if isinstance(x, float):
                assert y == pytest.approx(x, rel=1e-9), name
            else:
                assert x == y, name


def test_distributed_q3_exchange_zero_files_matches_flight(q3_parquet, tmp_path):
    flight_dir = str(tmp_path / "wd_flight")
    mesh_dir = str(tmp_path / "wd_mesh")
    want = _q3_distributed(q3_parquet, False, flight_dir)
    before = MeshRepartitionExec.exchanges_completed
    got = _q3_distributed(q3_parquet, True, mesh_dir)
    assert glob.glob(os.path.join(flight_dir, "**", "*.arrow"), recursive=True)
    assert not glob.glob(os.path.join(mesh_dir, "**", "*.arrow"), recursive=True)
    assert MeshRepartitionExec.exchanges_completed > before
    _assert_tables_match(got, want)


def test_distributed_q3_exchange_n_out_not_n_devices(q3_parquet, tmp_path):
    """n_out (3) != mesh shards (8): the destination column splits one
    shard's received rows into several output partitions."""
    want = _q3_distributed(q3_parquet, False, str(tmp_path / "wd_f3"), partitions=3)
    got = _q3_distributed(q3_parquet, True, str(tmp_path / "wd_m3"), partitions=3)
    _assert_tables_match(got, want)


def _both_exchangers(n_dev, schema, cap):
    return (JM.BatchExchanger(JM.make_mesh(n_dev), schema, capacity=cap),
            TM.BatchExchanger(TM.make_mesh(n_dev, "cpu"), schema, capacity=cap))


def _assert_batches_equal(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.equals(w)


def test_exchanged_rows_exact_roundtrip_f64():
    """Pass-through payloads survive the exchange EXACTLY: int64 past 2^53,
    f64 with all its bits, strings as dictionary codes; the received
    batches equal the reference exchanger's."""
    rng = np.random.default_rng(5)
    n = 128
    schema = pa.schema([("k", pa.int64()), ("v", pa.float64()), ("s", pa.string())])
    ks = rng.integers(0, 2**62, n)
    vs = rng.normal(size=n) * 1e15 + rng.normal(size=n)
    ss = [f"s{i % 7}" for i in range(n)]
    batch = pa.record_batch(
        {"k": pa.array(ks), "v": pa.array(vs), "s": pa.array(ss, pa.string())}
    )
    jex, tex = _both_exchangers(4, schema, n)
    dest = (ks % 4).astype(np.int32)
    jrc, jrv, jd = jex.exchange(dest, np.ones(n, bool), jex.to_columns(batch))
    rc, rv, dropped = tex.exchange(dest, np.ones(n, bool), tex.to_columns(batch))
    assert dropped == 0 == jd
    got_batches = tex.to_batches(rc, rv)
    _assert_batches_equal(got_batches, jex.to_batches(jrc, jrv))
    out = pa.Table.from_batches(got_batches)
    assert out.num_rows == n
    got = dict(zip(out.column("k").to_pylist(), out.column("v").to_pylist()))
    for k, v in zip(ks.tolist(), vs.tolist()):
        assert got[k] == v  # EXACT, not approx


def test_exchanger_capacity_boundary_exact_fill_and_retry():
    """A (src, dst) bucket filled to EXACTLY capacity routes with zero
    drops; one row past it is counted in n_dropped; the capacity retry
    (share_from) then delivers every row — as the reference's does."""
    n_dev, cap = 8, 32
    n = n_dev * 128
    ks = np.arange(n, dtype=np.int64)
    schema = pa.schema([("k", pa.int64()), ("v", pa.float64())])
    batch = pa.record_batch({"k": pa.array(ks), "v": pa.array(ks.astype(np.float64) * 0.5)})
    jex, ex = _both_exchangers(n_dev, schema, cap)
    cols = ex.to_columns(batch)
    jcols = jex.to_columns(batch)
    dest = ((np.arange(n) % (n_dev - 2)) + 2).astype(np.int32)
    dest[:cap] = 1
    assert ex.exchange(dest, np.ones(n, bool), cols)[2] == 0

    dest[cap] = 1  # one past the ceiling
    rc, rv, dropped = ex.exchange(dest, np.ones(n, bool), cols)
    jrc, jrv, jd = jex.exchange(dest, np.ones(n, bool), jcols)
    assert dropped == 1 == jd
    _assert_batches_equal(ex.to_batches(rc, rv), jex.to_batches(jrc, jrv))

    retry = TM.BatchExchanger(ex.mesh, schema, capacity=cap * 2, share_from=ex)
    rc, rv, dropped = retry.exchange(dest, np.ones(n, bool), cols)
    assert dropped == 0
    out = pa.Table.from_batches(retry.to_batches(rc, rv))
    assert out.num_rows == n
    assert sorted(out.column("k").to_pylist()) == ks.tolist()


def test_exchange_megarow_exact():
    """A 2^20-row exchange over 8 shards survives exactly, in the order the
    reference's exchange delivers it."""
    n_dev = 8
    n = 1 << 20
    rng = np.random.default_rng(11)
    ks = rng.integers(0, 1 << 62, n)
    vs = rng.normal(size=n) * 1e12
    schema = pa.schema([("k", pa.int64()), ("v", pa.float64())])
    batch = pa.record_batch({"k": pa.array(ks), "v": pa.array(vs)})
    ex = TM.BatchExchanger(TM.make_mesh(n_dev, "cpu"), schema,
                           capacity=(n // n_dev // n_dev) * 4)
    dest = (ks % n_dev).astype(np.int32)
    rc, rv, dropped = ex.exchange(dest, np.ones(n, bool), ex.to_columns(batch))
    assert dropped == 0
    got_batches = ex.to_batches(rc, rv)
    out = pa.Table.from_batches(got_batches)
    assert out.num_rows == n
    for d, b in enumerate(got_batches):
        # destination d holds its rows in source-shard, then input order
        np.testing.assert_array_equal(b.column("k").to_numpy(), ks[dest == d])
        np.testing.assert_array_equal(b.column("v").to_numpy(), vs[dest == d])


def test_exchange_row_ceiling_falls_back_correctly(q3_parquet, tmp_path):
    """A stage over mesh.exchange_max_rows falls back to the streaming
    hash-split (same answer, no exchange) instead of buffering it all."""
    before = MeshRepartitionExec.exchanges_completed
    want = _q3_distributed(q3_parquet, False, str(tmp_path / "wd_fc"))
    got = _q3_distributed(q3_parquet, True, str(tmp_path / "wd_mc"),
                          **{"ballista.mesh.exchange_max_rows": "10"})
    assert MeshRepartitionExec.exchanges_completed == before
    _assert_tables_match(got, want)


def test_mesh_repartition_execute_passthrough():
    """Direct execute() (no writer) yields the input rows unchanged."""
    from arrow_ballista_tpu_torch.catalog import MemoryTable
    from arrow_ballista_tpu_torch.exec.expressions import Col
    from arrow_ballista_tpu_torch.exec.operators import Partitioning, ScanExec, TaskContext

    t = pa.table({"a": pa.array(range(100), pa.int64())})
    scan = ScanExec("t", MemoryTable.from_table(t, 4))
    node = MeshRepartitionExec(scan, Partitioning("hash", 2, (Col(0, "a"),)))
    ctx = TaskContext(tbt.BallistaConfig({}))
    assert sum(b.num_rows for b in node.execute(0, ctx)) == 100


def test_execute_exchanged_matches_host_hash_split():
    """execute_exchanged on the CPU mesh hands each output partition
    exactly the rows the host hash partitioner sends there, in input
    order, with the exchange's metrics."""
    from arrow_ballista_tpu_torch.catalog import MemoryTable
    from arrow_ballista_tpu_torch.exec.expressions import Col
    from arrow_ballista_tpu_torch.exec.operators import Partitioning, ScanExec, TaskContext
    from arrow_ballista_tpu_torch.shuffle.execution_plans import partition_indices

    rng = np.random.default_rng(9)
    n = 5000
    t = pa.table({
        "a": pa.array(rng.integers(0, 1000, n), pa.int64()),
        "s": pa.array([f"x{i % 13}" for i in range(n)]),
        "d": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1),
    })
    part = Partitioning("hash", 3, (Col(0, "a"),))
    node = MeshRepartitionExec(ScanExec("t", MemoryTable.from_table(t, 5)), part,
                               device="cpu")
    out = list(node.execute_exchanged(TaskContext(tbt.BallistaConfig({}))))
    m = node.metrics.to_dict()
    assert m["mesh_exchange_rows"] == n and m["mesh_devices"] == 8
    pid = np.concatenate(
        [partition_indices(b, list(part.exprs), 3) for b in t.to_batches()]
    )
    for p in range(3):
        got = pa.Table.from_batches([b for q, b in out if q == p]).rename_columns(
            t.column_names
        )
        want = t.filter(pa.array(pid == p))
        assert sorted(got.column("a").to_pylist()) == sorted(want.column("a").to_pylist())
        assert got.num_rows == want.num_rows
        assert sorted(map(str, got.column("d").to_pylist())) == sorted(
            map(str, want.column("d").to_pylist()))


def test_exchange_every_column_type_matches_reference():
    """Every type the exchange takes (int32, float32, bool, date32,
    timestamp, strings), each with nulls, over 8 shards and 3 destinations:
    the port's received batches equal the reference exchanger's."""
    import datetime

    rng = np.random.default_rng(17)
    n = 3000
    nulls = lambda: rng.random(n) < 0.1  # noqa: E731
    base = datetime.date(1995, 1, 1)
    batch = pa.record_batch({
        "i": pa.array(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32), mask=nulls()),
        "f": pa.array(rng.normal(size=n).astype(np.float32), mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
        "d": pa.array([base + datetime.timedelta(days=int(k)) for k in rng.integers(0, 3000, n)],
                      pa.date32(), mask=nulls()),
        "t": pa.array(rng.integers(0, 2**50, n), pa.timestamp("us"), mask=nulls()),
        "s": pa.array([f"v{k}" for k in rng.integers(0, 40, n)], mask=nulls()),
    })
    jex, tex = _both_exchangers(8, batch.schema, n)
    dest = rng.integers(0, 3, n).astype(np.int32)
    valid = rng.random(n) >= 0.05
    jrc, jrv, jd = jex.exchange(dest, valid, jex.to_columns(batch))
    rc, rv, dropped = tex.exchange(dest, valid, tex.to_columns(batch))
    assert dropped == jd == 0
    got = tex.to_batches(rc, rv)
    _assert_batches_equal(got, jex.to_batches(jrc, jrv))
    assert sum(b.num_rows for b in got) == int(valid.sum())
