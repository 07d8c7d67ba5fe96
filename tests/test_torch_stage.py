"""The PyTorch port's device stage against the JAX package and the CPU path.

Twin of the applicable cases of ``tests/test_tpu_stage.py``: each query
runs three ways — the port's ``SessionContext(device="cpu")`` with its
``TorchStageExec`` (the kernels' plain PyTorch versions), the JAX
package's ``SessionContext`` with its ``TpuStageExec``, and the JAX
package's CPU operator path (``ballista.tpu.enable=false``) — and the
three tables must agree: floats within rel 1e-9, everything else exact.
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pytest

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec, _ReadAhead
from benchmarks.tpch.datagen import ALL_TABLES, gen_table
from benchmarks.tpch.queries import QUERIES

_TPCH: dict = {}


def _tpch_tables(sf: float = 0.01) -> dict:
    if sf not in _TPCH:
        _TPCH[sf] = {name: gen_table(name, sf) for name in ALL_TABLES}
    return _TPCH[sf]


def _register_tpch(ctx):
    for name, tbl in _tpch_tables().items():
        ctx.register_arrow_table(name, tbl, partitions=2)


def _settings(tpu: bool, extra: dict) -> dict:
    # min_rows=0: these tests exercise the device stage on small fixtures,
    # so the small-input CPU fallback must stay out of the way
    s = {
        "ballista.tpu.enable": "true" if tpu else "false",
        "ballista.tpu.min_rows": "0",
    }
    s.update({k: str(v) for k, v in extra.items()})
    return s


def _port(**extra) -> "tbt.SessionContext":
    return tbt.SessionContext(tbt.BallistaConfig(_settings(True, extra)), device="cpu")


def _jax(tpu: bool, **extra) -> "jbt.SessionContext":
    return jbt.SessionContext(jbt.BallistaConfig(_settings(tpu, extra)))


def _assert_tables_equal(a: pa.Table, b: pa.Table, rel=1e-9):
    assert a.schema.names == b.schema.names
    assert a.num_rows == b.num_rows
    for name in a.schema.names:
        av, bv = a.column(name).to_pylist(), b.column(name).to_pylist()
        for x, y in zip(av, bv):
            if isinstance(x, float) and x is not None and y is not None:
                assert y == pytest.approx(x, rel=rel), name
            else:
                assert x == y, name


def _three(sql: str, register, sort_by=None, **extra):
    """(cpu, jax device stage, port) results of ``sql``; asserts all agree
    and that the port planned a TorchStageExec."""
    cpu, jax_dev, port = _jax(False, **extra), _jax(True, **extra), _port(**extra)
    for c in (cpu, jax_dev, port):
        register(c)
    assert "TorchStageExec" in port.sql(sql).explain()
    out = [c.sql(sql).collect() for c in (cpu, jax_dev, port)]
    if sort_by:
        out = [t.sort_by(sort_by) for t in out]
    _assert_tables_equal(out[0], out[1])
    _assert_tables_equal(out[0], out[2])
    return out


def _stage_metrics(plan) -> dict:
    agg: dict = {}
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, TorchStageExec):
            for k, v in node.metrics.to_dict().items():
                agg[k] = agg.get(k, 0) + v
        stack.extend(node.children())
    return agg


def _run_port(ctx, sql):
    plan = ctx.sql(sql).physical_plan()
    return ctx.execute(plan), _stage_metrics(plan)


# ------------------------------------------------------------- TPC-H
@pytest.mark.parametrize("q", [1, 3, 6, 12])
def test_tpch_query_matches_jax_and_cpu(q):
    """q1/q6 (the main path), q12 (CASE over a host string leaf) and q3
    (the aggregate on the device above a CPU join)."""
    _three(QUERIES[q], _register_tpch)
    # the stage's own route and metrics: with the mesh on (the default,
    # which _three holds to the reference) q1, q6 and q12 run as a gang
    ctx = _port(**{"ballista.mesh.enable": "false"})
    _register_tpch(ctx)
    _, m = _run_port(ctx, QUERIES[q])
    for k in ("tpu_fallback", "cpu_fallback", "highcard_fallback"):
        assert k not in m, m
    for k in ("tpu_stage_time_ns", "device_time_ns", "bridge_time_ns",
              "tpu_execute_ns"):
        assert m.get(k, 0) > 0, (k, m)
    if q != 6:
        assert m.get("key_encode_time_ns", 0) > 0, m


def test_tpu_disable_flag_keeps_cpu_operators():
    ctx = tbt.SessionContext(
        tbt.BallistaConfig(_settings(False, {})), device="cpu"
    )
    _register_tpch(ctx)
    assert "TorchStageExec" not in ctx.sql(QUERIES[6]).explain()


# ------------------------------------------------------------- semantics
def test_nulls_in_agg_args_and_keys():
    tbl = pa.table(
        {
            "g": pa.array(["a", None, "a", "b", None, "b"], pa.string()),
            "v": pa.array([1.0, 2.0, None, 4.0, None, 6.0], pa.float64()),
        }
    )
    sql = (
        "select g, sum(v) as s, count(v) as cv, count(*) as c, avg(v) as m, "
        "min(v) as lo, max(v) as hi from t group by g order by g nulls last"
    )
    _, _, port = _three(sql, lambda c: c.register_arrow_table("t", tbl, partitions=2))
    assert port.column("s").to_pylist() == [1.0, 10.0, 2.0]
    assert port.column("c").to_pylist() == [2, 2, 2]
    assert port.column("cv").to_pylist() == [1, 2, 1]


def test_all_rows_filtered_group_dropped():
    tbl = pa.table({"g": pa.array(["x", "y"]), "v": pa.array([1.0, 100.0])})
    sql = "select g, sum(v) as s from t where v < 50 group by g"
    _, _, port = _three(sql, lambda c: c.register_arrow_table("t", tbl))
    assert port.num_rows == 1


@pytest.mark.parametrize("partitions", [1, 4])
def test_global_agg_empty_input_and_empty_partition(partitions):
    """An empty input gives the SQL empty row; an empty partition among
    live ones must not add a second row."""
    empty = pa.table({"v": pa.array([], pa.float64())})
    sql = "select sum(v) as s, count(*) as c from t"
    _, _, port = _three(sql, lambda c: c.register_arrow_table("t", empty))
    assert port.column("s").to_pylist() == [None]
    assert port.column("c").to_pylist() == [0]
    three = pa.table({"v": pa.array([1.0, 2.0, 3.0])})
    _, _, port = _three(
        sql, lambda c: c.register_arrow_table("t", three, partitions=partitions)
    )
    assert port.column("s").to_pylist() == [6.0]
    assert port.column("c").to_pylist() == [3]


def test_int_sum_exact():
    tbl = pa.table({"v": pa.array(np.arange(1, 100001, dtype=np.int64))})
    sql = "select sum(v) as s from t"
    _, _, port = _three(sql, lambda c: c.register_arrow_table("t", tbl, partitions=3))
    assert port.column("s").to_pylist() == [100000 * 100001 // 2]


def test_int_sum_exact_past_2_53():
    """The port sums integers in int64 and matches the CPU operators
    exactly where an f64 sum would round."""
    v = np.full(64, 2**53 + 1, dtype=np.int64)
    tbl = pa.table({"g": pa.array(np.arange(64) % 2), "v": pa.array(v)})
    sql = "select g, sum(v) as s from t group by g order by g"
    cpu, port = _jax(False), _port()
    for c in (cpu, port):
        c.register_arrow_table("t", tbl)
    want = cpu.sql(sql).collect()
    got = port.sql(sql).collect()
    assert got.column("s").to_pylist() == want.column("s").to_pylist() == [
        32 * (2**53 + 1)
    ] * 2


def test_aggregates_over_distinct_computed_args():
    """avg over two integer expressions with a float sum between them:
    each aggregate keeps its own argument."""
    rng = np.random.default_rng(5)
    n = 3000
    tbl = pa.table(
        {
            "g": pa.array(rng.integers(0, 5, n), pa.int64()),
            "a": pa.array(rng.integers(0, 1000, n), pa.int64()),
            "b": pa.array(rng.integers(10**6, 2 * 10**6, n), pa.int64()),
            "x": pa.array(rng.normal(0, 1, n), pa.float64()),
            "y": pa.array(rng.normal(0, 1, n), pa.float64()),
        }
    )
    sql = (
        "select g, avg(a + 1) as ma, sum(x * y) as sxy, avg(b + 1) as mb, "
        "sum(a + 1) as sa from t group by g order by g"
    )
    _three(sql, lambda c: c.register_arrow_table("t", tbl, partitions=2))


@pytest.mark.parametrize("key_type", [pa.int64(), pa.int32(), pa.date32()])
def test_negative_group_keys_stay_on_device(key_type):
    """Negative integer keys and pre-1970 dates group on the device
    route: no fallback, same result as the CPU operators."""
    rng = np.random.default_rng(9)
    n = 2000
    k = rng.integers(-500, 500, n)
    keys = pa.array(k.astype("datetime64[D]") if pa.types.is_date32(key_type) else k)
    tbl = pa.table(
        {
            "k": pa.array(keys.to_pylist(), key_type, mask=rng.random(n) < 0.05),
            "v": pa.array(rng.normal(0, 1, n), pa.float64()),
        }
    )
    sql = "select k, sum(v) as s, count(*) as c from t group by k order by k"
    _three(sql, lambda c: c.register_arrow_table("t", tbl, partitions=2))
    ctx = _port()
    ctx.register_arrow_table("t", tbl, partitions=2)
    _, m = _run_port(ctx, sql)
    for key in ("tpu_fallback", "cpu_fallback", "highcard_fallback"):
        assert key not in m, m


def test_case_null_semantics_match_cpu():
    tbl = pa.table(
        {
            "p": pa.array([1, 0, 1, 0], pa.int64()),
            "a": pa.array([None, 2.0, 3.0, None], pa.float64()),
        }
    )
    sql = (
        "select sum(case when p = 1 then a else 0 end) as s, "
        "count(case when p = 1 then a end) as c from t"
    )
    _, _, port = _three(sql, lambda c: c.register_arrow_table("t", tbl))
    assert port.column("s").to_pylist() == [3.0]
    assert port.column("c").to_pylist() == [1]


def test_four_plus_group_keys_on_device():
    rng = np.random.default_rng(11)
    n = 4000
    tbl = pa.table(
        {
            "a": pa.array(np.array(["x", "y", "z"], object)[rng.integers(0, 3, n)].tolist()),
            "b": pa.array(rng.integers(0, 4, n), pa.int64()),
            "c": pa.array(np.array(["m", "n"], object)[rng.integers(0, 2, n)].tolist()),
            "d": pa.array(rng.integers(0, 5, n), pa.int64()),
            "e": pa.array(rng.integers(0, 3, n), pa.int64()),
            "v": pa.array(rng.uniform(0, 100, n), pa.float64()),
        }
    )
    sql = (
        "select a, b, c, d, e, sum(v) as s, count(*) as n from t "
        "group by a, b, c, d, e order by a, b, c, d, e"
    )
    _three(sql, lambda c: c.register_arrow_table("t", tbl, partitions=2))


def test_narrow_types_min_max_and_dates():
    """int32/float32/date32 leaves widen to the x64 device dtypes; integer
    and date extrema stay exact."""
    rng = np.random.default_rng(2)
    n = 3000
    tbl = pa.table(
        {
            "g": pa.array(rng.integers(0, 9, n).astype(np.int32)),
            "i": pa.array(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)),
            "f": pa.array(rng.normal(0, 1, n).astype(np.float32)),
            "d": pa.array(rng.integers(0, 20000, n).astype(np.int32), pa.date32()),
            "w": pa.array(rng.integers(-(2**62), 2**62, n), pa.int64()),
        }
    )
    sql = (
        "select g, min(i) as a, max(f) as b, min(d) as c, max(d) as e, "
        "min(w) as lo, max(w) as hi, sum(i) as s, avg(f) as m from t "
        "where d > date '1990-01-01' group by g order by g"
    )
    _three(sql, lambda c: c.register_arrow_table("t", tbl, partitions=2))


def test_unported_aggregates_stay_on_cpu_operators():
    """Median, the variance family and count distinct are ported: grouped,
    each plans a device stage exactly where the JAX package plans one (the
    keyed route for median and count distinct); their global forms are not
    lowered by either package and stay on the CPU operators.  Every answer
    matches the CPU operators'."""
    rng = np.random.default_rng(4)
    tbl = pa.table(
        {"g": pa.array(rng.integers(0, 5, 500)), "v": pa.array(rng.normal(0, 1, 500))}
    )
    for agg in ("median(v)", "stddev(v)", "count(distinct v)"):
        for sql, lowered in (
            (f"select g, {agg} as x from t group by g order by g", True),
            (f"select {agg} as x from t", agg == "stddev(v)"),
        ):
            cpu, jax_dev, port = _jax(False), _jax(True), _port()
            for c in (cpu, jax_dev, port):
                c.register_arrow_table("t", tbl)
            assert ("TorchStageExec" in port.sql(sql).explain()) == lowered, sql
            assert ("TpuStageExec" in jax_dev.sql(sql).explain()) == lowered, sql
            want = cpu.sql(sql).collect()
            _assert_tables_equal(want, port.sql(sql).collect())
            _assert_tables_equal(want, jax_dev.sql(sql).collect())


# -------------------------------------------------- capacity and routing
def _groups_table(n_rows: int, n_groups: int) -> pa.Table:
    return pa.table(
        {
            "g": pa.array(np.arange(n_rows) % n_groups, pa.int64()),
            "v": pa.array(np.ones(n_rows), pa.float64()),
        }
    )


def _register_chunked(ctx, tbl: pa.Table, rows: int = 512):
    """One partition streamed as ``rows``-row batches."""
    ctx.register_record_batches("t", [tbl.to_batches(max_chunksize=rows)])


def test_group_key_past_the_table_falls_back_to_cpu():
    """A key whose code needs more than the group table's 62 bits is a
    capacity fallback: counted, and the CPU operators give the answer."""
    tbl = pa.table(
        {
            "k": pa.array([1, -(2**62), 1, 2**62, 5], pa.int64()),
            "v": pa.array([1.0, 2.0, 3.0, 4.0, 5.0]),
        }
    )
    sql = "select k, sum(v) as s from t group by k order by k"
    _three(sql, lambda c: c.register_arrow_table("t", tbl))
    ctx = _port()
    ctx.register_arrow_table("t", tbl)
    got, m = _run_port(ctx, sql)
    assert m.get("tpu_fallback", 0) == 1, m
    assert got.column("k").to_pylist() == [-(2**62), 1, 5, 2**62]


def test_uint64_leaves_stay_on_the_host():
    """uint64 has values with no int64 image: an aggregate over it keeps
    the CPU operators at plan time rather than failing on the data."""
    u = np.array([1, 2**63 + 5, 7, 2**64 - 1], np.uint64)
    tbl = pa.table({"u": pa.array(u), "v": pa.array([1.0, 2.0, 3.0, 4.0])})
    sql = "select max(u) as m, sum(v) as s, count(*) as c from t"
    cpu, port = _jax(False), _port()
    for c in (cpu, port):
        c.register_arrow_table("t", tbl)
    assert "TorchStageExec" not in port.sql(sql).explain()
    got = port.sql(sql).collect()
    _assert_tables_equal(cpu.sql(sql).collect(), got)
    assert got.column("m").to_pylist() == [2**64 - 1]


def test_kernel_failure_raises_without_cpu_fallback(monkeypatch):
    from arrow_ballista_tpu_torch.errors import ExecutionError
    from arrow_ballista_tpu_torch.ops import kernels as TK

    def broken(*args, **kwargs):
        raise ExecutionError("kernel failed")

    # the one-batch kernel (cache off) and the multi-entry kernel (the
    # default column cache's fused run) alike
    monkeypatch.setattr(TK, "segment_agg", broken)
    monkeypatch.setattr(TK, "segment_agg_entries", broken)
    ctx = _port()
    _register_tpch(ctx)
    plan = ctx.sql(QUERIES[6]).physical_plan()
    with pytest.raises(ExecutionError, match="kernel failed"):
        ctx.execute(plan)
    m = _stage_metrics(plan)
    assert "tpu_fallback" not in m and "cpu_fallback" not in m, m


def test_capacity_grows_without_fallback():
    """Cardinality beyond the initial segment capacity grows the state in
    4x buckets on the device rather than falling back to the CPU."""
    tbl = _groups_table(5000, 3000)
    sql = "select g, sum(v) as s from t group by g order by g"
    extra = {"ballista.tpu.segment_capacity": 256}
    _three(sql, lambda c: _register_chunked(c, tbl, 100), **extra)
    ctx = _port(**extra)
    _register_chunked(ctx, tbl, 100)
    out, m = _run_port(ctx, sql)
    assert out.num_rows == 3000
    assert m.get("capacity_growths", 0) >= 1, m
    assert "tpu_fallback" not in m, m


def test_max_capacity_falls_back_to_cpu():
    """Groups outgrowing tpu.max_capacity mid-stream re-run the partition
    on the CPU operators, with the right answer."""
    extra = {
        "ballista.tpu.segment_capacity": 64,
        "ballista.tpu.max_capacity": 1024,
    }
    tbl = _groups_table(3000, 3000)
    sql = "select g, sum(v) as s from t group by g order by g"
    _three(sql, lambda c: _register_chunked(c, tbl), **extra)
    ctx = _port(**extra)
    _register_chunked(ctx, tbl)
    out, m = _run_port(ctx, sql)
    assert out.num_rows == 3000
    assert m.get("tpu_fallback", 0) >= 1, m


@pytest.mark.parametrize("mode", ["cpu", "gid", "device"])
def test_highcard_routing(mode):
    """groups ~ rows: 'cpu' (and 'auto') hand the stage to the CPU hash
    aggregate; 'gid' and 'device' keep it on the device group table (the
    keyed route is not ported)."""
    rng = np.random.default_rng(5)
    n = 1 << 17  # past HIGHCARD_MIN_GROUPS distinct keys
    tbl = pa.table(
        {
            "g": pa.array(rng.permutation(n).astype(np.int64)),
            "v": pa.array(rng.uniform(0, 100, n)),
        }
    )
    sql = "select g, sum(v) as s, count(*) as c from t group by g"
    cpu = _jax(False)
    cpu.register_arrow_table("t", tbl)
    want = cpu.sql(sql).collect().sort_by([("g", "ascending")])
    ctx = _port(**{"ballista.tpu.highcard_mode": mode})
    ctx.register_arrow_table("t", tbl)
    got, m = _run_port(ctx, sql)
    _assert_tables_equal(want, got.sort_by([("g", "ascending")]))
    if mode == "cpu":
        assert m.get("highcard_fallback", 0) >= 1, m
    else:
        assert "highcard_fallback" not in m and "tpu_fallback" not in m, m


def test_highcard_mode_validated():
    from arrow_ballista_tpu_torch.errors import BallistaError

    with pytest.raises((BallistaError, ValueError)):
        tbt.BallistaConfig({"ballista.tpu.highcard_mode": "sort"})
    assert (
        tbt.BallistaConfig({"ballista.tpu.highcard_mode": "Device"}).tpu_highcard_mode
        == "device"
    )


# -------------------------------------------------------------- readahead
def test_readahead_prefetcher_transparent():
    items = list(range(100))
    assert list(_ReadAhead(iter(items), depth=2)) == items
    assert list(_ReadAhead(iter([]), depth=1)) == []

    def boom():
        yield 1
        yield 2
        raise ValueError("source failed")

    ra = _ReadAhead(boom(), depth=2)
    assert next(ra) == 1 and next(ra) == 2
    with pytest.raises(ValueError, match="source failed"):
        next(ra)


def test_readahead_on_off_same_results():
    key = [("l_returnflag", "ascending"), ("l_linestatus", "ascending")]
    out = []
    for depth in ("0", "2"):
        ctx = _port(**{"ballista.tpu.readahead": depth})
        lineitem = _tpch_tables()["lineitem"]
        ctx.register_record_batches(
            "lineitem", [lineitem.to_batches(max_chunksize=4096)]
        )
        out.append(ctx.sql(QUERIES[1]).collect().sort_by(key))
    _assert_tables_equal(out[0], out[1])


def test_readahead_exhaustion_and_close():
    ra = _ReadAhead(iter([1]), depth=1)
    assert list(ra) == [1]
    with pytest.raises(StopIteration):
        next(ra)

    def boom():
        yield 1
        raise ValueError("dead")

    rb = _ReadAhead(boom(), depth=1)
    assert next(rb) == 1
    with pytest.raises(ValueError):
        next(rb)
    with pytest.raises(StopIteration):
        next(rb)

    pulled = []

    def slow_source():
        for i in range(1000):
            pulled.append(i)
            yield i

    rc = _ReadAhead(slow_source(), depth=1)
    assert next(rc) == 0
    rc.close()
    n_after_close = len(pulled)
    time.sleep(0.1)
    assert len(pulled) == n_after_close, "pump kept reading after close()"
    assert not rc._thread.is_alive()
    with pytest.raises(StopIteration):
        next(rc)


def test_capacity_fallback_closes_prefetcher():
    """A capacity CPU re-run must stop the prefetch pump (no concurrent
    double-read of the source, no leaked blocked thread)."""
    before = threading.active_count()
    n = 4096
    rng = np.random.default_rng(9)
    tbl = pa.table(
        {"g": pa.array(np.arange(n, dtype=np.int64)), "v": pa.array(rng.uniform(0, 1, n))}
    )
    ctx = _port(
        **{
            "ballista.tpu.segment_capacity": "64",
            "ballista.tpu.max_capacity": "1024",
            "ballista.tpu.readahead": "2",
        }
    )
    _register_chunked(ctx, tbl)
    out, m = _run_port(ctx, "select g, sum(v) s from t group by g")
    assert out.num_rows == n
    assert m.get("tpu_fallback", 0) >= 1, m
    for _ in range(50):
        if threading.active_count() <= before:
            break
        time.sleep(0.05)
    assert threading.active_count() <= before + 1


def test_sort_indices_matches_per_key_null_placement():
    """The port's sort helper gives pyarrow's per-key null placement (nulls
    outermost, then NaNs) through plain (column, order) pairs."""
    import pyarrow.compute as pc

    from arrow_ballista_tpu_torch.exec.operators import sort_indices

    rng = np.random.default_rng(8)
    for _ in range(200):
        n = 40
        t = pa.table(
            {
                "a": pa.array(
                    [None if rng.random() < 0.2 else
                     float("nan") if rng.random() < 0.15 else
                     float(rng.integers(0, 5)) for _ in range(n)]
                ),
                "b": pa.array(
                    [None if rng.random() < 0.2 else int(rng.integers(0, 3))
                     for _ in range(n)]
                ),
                "c": pa.array(
                    [None if rng.random() < 0.2 else str(rng.integers(0, 3))
                     for _ in range(n)]
                ),
            }
        )
        cols = list(rng.permutation(["a", "b", "c"]))[: rng.integers(1, 4)]
        keys = [
            (str(c), str(rng.choice(["ascending", "descending"])),
             str(rng.choice(["at_start", "at_end"])))
            for c in cols
        ]
        want = pc.sort_indices(t, sort_keys=keys).to_pylist()
        assert sort_indices(t, keys).to_pylist() == want, keys

