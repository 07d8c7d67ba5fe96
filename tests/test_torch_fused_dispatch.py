"""The PyTorch port's column cache and single-dispatch runner against the
JAX package, on the CPU.

Twins of ``tests/test_fused_dispatch.py``: a cache-eligible stage (join
free, over a scan) retains its batches and folds them in ONE multi-entry
launch (``fused_dispatches``), a repeated query replays the retained
entries from the device column cache (``cache_hits``), and past
``_FUSED_MAX_ENTRIES`` entries the runner streams one launch per entry.
Each query runs on the port's ``SessionContext(device="cpu")`` (the
kernels' plain twins), the JAX package's device stage and its CPU
operators over the same seeded tables; results agree within
``tests/test_tpu_stage.py:_assert_tables_equal``'s bar (floats rel 1e-9,
everything else exact) and the route counters agree with the reference's.
Also: the cache's own cases (projected columns, staging bytes, the LRU
budget, provider eviction), the fused runner's refusal of a join stage,
and the multi-entry kernel's twin against B1's twin and the reference's
``_fused_for``.
"""

import gc
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu.catalog import MemoryTable as JMemoryTable
from arrow_ballista_tpu_torch.catalog import MemoryTable as TMemoryTable
from arrow_ballista_tpu_torch.ops import device_cache
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
REL = 1e-9


def _settings(tpu: bool, extra: dict) -> dict:
    s = {
        "ballista.tpu.enable": "true" if tpu else "false",
        "ballista.tpu.min_rows": "0",
        "ballista.shuffle.partitions": "1",
        "ballista.mesh.enable": "false",
    }
    s.update({k: str(v) for k, v in extra.items()})
    return s


def _port(**extra) -> "tbt.SessionContext":
    return tbt.SessionContext(tbt.BallistaConfig(_settings(True, extra)), device="cpu")


def _jax(tpu: bool, **extra) -> "jbt.SessionContext":
    return jbt.SessionContext(jbt.BallistaConfig(_settings(tpu, extra)))


def _reg(ctx, name, table, partitions=1):
    mt = TMemoryTable if isinstance(ctx, tbt.SessionContext) else JMemoryTable
    ctx.register_table(name, mt.from_table(table, partitions))


def _reg_batches(ctx, name, batches, schema):
    mt = TMemoryTable if isinstance(ctx, tbt.SessionContext) else JMemoryTable
    ctx.register_table(name, mt([batches], schema))


def _assert_tables_equal(a: pa.Table, b: pa.Table, rel=REL):
    assert a.schema.names == b.schema.names
    assert a.num_rows == b.num_rows
    a = a.sort_by([(c, "ascending") for c in a.column_names
                   if not pa.types.is_floating(a.schema.field(c).type)])
    b = b.sort_by([(c, "ascending") for c in b.column_names
                   if not pa.types.is_floating(b.schema.field(c).type)])
    for name in a.schema.names:
        for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
            if isinstance(x, float) and x is not None and y is not None:
                assert y == pytest.approx(x, rel=rel), name
            else:
                assert x == y, name


def _stage_metrics(plan) -> dict:
    from arrow_ballista_tpu.ops.stage_compiler import TpuStageExec

    agg: dict = {}
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, TorchStageExec):
            vals = node.metrics.to_dict()
        elif isinstance(node, TpuStageExec):
            vals = node.metrics.values
        else:
            vals = {}
        for k, v in vals.items():
            agg[k] = agg.get(k, 0) + v
        stack.extend(node.children())
    return agg


def _run(ctx, sql):
    plan = ctx.sql(sql).physical_plan()
    table = ctx.execute(plan)
    return table, _stage_metrics(plan)


def _three(sql, register, **extra):
    """(cpu, jax, port) results and the jax and port stage metrics; the
    three results must agree."""
    cpu, jax_dev, port = _jax(False, **extra), _jax(True, **extra), _port(**extra)
    for c in (cpu, jax_dev, port):
        register(c)
    want, _ = _run(cpu, sql)
    jres, jm = _run(jax_dev, sql)
    tres, tm = _run(port, sql)
    _assert_tables_equal(want, jres)
    _assert_tables_equal(want, tres)
    return tm, jm


def _mktable(n=5000, groups=7, nulls=False, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, groups, n)
    v = rng.uniform(-100, 100, n)
    q = rng.integers(1, 50, n).astype(np.float64)
    varr = pa.array(v, pa.float64())
    if nulls:
        mask = rng.uniform(size=n) < 0.1
        varr = pa.array(v, pa.float64(), mask=mask)
    return pa.table({"k": pa.array(k, pa.int64()), "v": varr,
                     "q": pa.array(q, pa.float64())})


GROUPED = "select k, sum(v), count(v), min(q), max(v) from t group by k"
SCALAR = "select sum(v), count(*), min(v) from t where q < 25"


# ---------------------------------------------------- twins of the queries
@pytest.mark.parametrize("sql", [GROUPED, SCALAR])
@pytest.mark.parametrize("nulls", [False, True])
def test_fused_matches_cpu(sql, nulls):
    t = _mktable(nulls=nulls)
    tm, jm = _three(sql, lambda c: _reg(c, "t", t))
    assert tm.get("fused_dispatches", 0) >= 1, tm
    assert tm.get("fused_dispatches") == jm.get("fused_dispatches"), (tm, jm)


def test_fused_multi_batch_matches_cpu():
    # several batches per partition: every entry folds in ONE launch
    t = _mktable(n=20000)
    tm, jm = _three(GROUPED, lambda c: _reg(c, "t", t),
                    **{"ballista.batch.size": 4096})
    assert tm.get("fused_dispatches", 0) >= 1, tm
    assert tm.get("fused_dispatches") == jm.get("fused_dispatches"), (tm, jm)


def test_fused_cache_hit_matches():
    # the second execution serves the retained entries through the same
    # fused run; both results must be identical
    t = _mktable(n=8000)
    for ctx in (_port(), _jax(True)):
        _reg(ctx, "t", t)
        first, _ = _run(ctx, GROUPED)
        second, m2 = _run(ctx, GROUPED)
        assert first.equals(second)
        assert m2.get("cache_hits", 0) >= 1, m2
        assert m2.get("fused_dispatches", 0) >= 1, m2


def test_fused_capacity_growth():
    # cardinality outruns the initial capacity: the fused run folds every
    # entry at the FINAL capacity, and still matches the CPU operators
    n = 30000
    rng = np.random.default_rng(1)
    t = pa.table({
        "k": pa.array(rng.integers(0, 3000, n), pa.int64()),
        "v": pa.array(rng.uniform(-10, 10, n), pa.float64()),
        "q": pa.array(rng.integers(1, 50, n).astype(np.float64)),
    })
    tm, jm = _three(GROUPED, lambda c: _reg(c, "t", t),
                    **{"ballista.batch.size": 4096})
    assert tm.get("fused_dispatches", 0) >= 1, tm
    assert tm.get("capacity_growths", 0) >= 1, tm
    for k in ("fused_dispatches", "capacity_growths"):
        assert tm.get(k) == jm.get(k), (k, tm, jm)


def test_entry_cap_streams_instead_of_unrolling():
    # more retained batches than _FUSED_MAX_ENTRIES: one launch per entry
    # (fused_dispatches stays 0), in both packages, and the same answer
    from arrow_ballista_tpu.ops import stage_compiler as JSC
    from arrow_ballista_tpu_torch.ops import stage_compiler as TSC

    assert TSC._FUSED_MAX_ENTRIES == JSC._FUSED_MAX_ENTRIES == 32
    t = _mktable(n=40 * 256)
    batches = pa.Table.from_batches(t.to_batches()).to_batches(max_chunksize=256)
    tm, jm = _three(GROUPED, lambda c: _reg_batches(c, "t", batches, t.schema))
    assert tm.get("fused_dispatches", 0) == 0, tm
    assert tm.get("fused_dispatches", 0) == jm.get("fused_dispatches", 0), (tm, jm)
    assert tm.get("input_rows") == 40 * 256


def test_streamed_join_still_correct():
    # join stages keep the per-batch path: no retention, no fused run
    n = 6000
    rng = np.random.default_rng(2)
    fact = pa.table({
        "fk": pa.array(rng.integers(0, 100, n), pa.int64()),
        "grp": pa.array(rng.integers(0, 5, n), pa.int64()),
        "x": pa.array(rng.uniform(0, 1, n), pa.float64()),
    })
    dim = pa.table({
        "pk": pa.array(np.arange(100), pa.int64()),
        "dv": pa.array(np.linspace(0.5, 1.5, 100)),
    })
    sql = ("select grp, sum(x * dv), count(*) from dim, fact "
           "where pk = fk group by grp")

    def register(c):
        _reg(c, "fact", fact)
        _reg(c, "dim", dim)

    tm, _jm = _three(sql, register)
    assert tm.get("fused_dispatches", 0) == 0, tm
    assert tm.get("cache_hits", 0) == 0, tm


def test_repeat_query_hits_the_cache_in_both_packages():
    """The same query twice on one session: the second run is a cache hit
    in both packages (no host encode, no bridge in the port), and every
    answer agrees."""
    t = _mktable(n=12000, nulls=True, seed=11)
    extra = {"ballista.batch.size": 2048}
    port, jax_dev = _port(**extra), _jax(True, **extra)
    for c in (port, jax_dev):
        _reg(c, "t", t)
    p1, pm1 = _run(port, GROUPED)
    p2, pm2 = _run(port, GROUPED)
    j1, _ = _run(jax_dev, GROUPED)
    j2, jm2 = _run(jax_dev, GROUPED)
    assert pm1.get("cache_hits", 0) == 0, pm1
    assert pm2.get("cache_hits", 0) >= 1 and jm2.get("cache_hits", 0) >= 1, (pm2, jm2)
    assert pm2.get("key_encode_time_ns", 0) == 0 and pm2.get("bridge_time_ns", 0) == 0, pm2
    assert p1.equals(p2)  # the replay folds the same entries in the same order
    _assert_tables_equal(j1, p1)
    _assert_tables_equal(j2, p2)


def test_cache_off_keeps_the_per_batch_path():
    """With ``cache_columns=false`` (and fusion off) nothing is retained:
    one launch per batch into the running state, no fused run, no cache
    entry, and the same answer."""
    t = _mktable(n=9000, seed=5)
    extra = {"ballista.batch.size": 2048, "ballista.tpu.cache_columns": "false"}
    tm, jm = _three(GROUPED, lambda c: _reg(c, "t", t), **extra)
    for k in ("fused_dispatches", "cache_hits", "fused_segments"):
        assert tm.get(k, 0) == 0 and jm.get(k, 0) == 0, (k, tm, jm)
    before = device_cache.stats()["entries"]
    ctx = _port(**extra)
    _reg(ctx, "t", t)
    _run(ctx, GROUPED)
    _, m = _run(ctx, GROUPED)
    assert m.get("cache_hits", 0) == 0
    assert device_cache.stats()["entries"] == before


# ------------------------------------------------------- the cache's cases
def test_device_cache_distinguishes_projected_columns():
    """Two queries over DIFFERENT columns of the same table must not share
    a device-cache entry (scan-relative leaf indices collide)."""
    tbl = pa.table({
        "g": pa.array([1, 1, 2], pa.int64()),
        "v": pa.array([1.0, 2.0, 3.0], pa.float64()),
        "w": pa.array([100.0, 200.0, 300.0], pa.float64()),
    })
    for ctx in (_port(**{"ballista.tpu.cache_columns": "true"}),
                _jax(True, **{"ballista.tpu.cache_columns": "true"})):
        ctx.register_arrow_table("t", tbl)
        out_v = ctx.sql("select g, sum(v) as s from t group by g order by g").collect()
        out_w = ctx.sql("select g, sum(w) as s from t group by g order by g").collect()
        assert out_v.column("s").to_pylist() == [pytest.approx(3.0), pytest.approx(3.0)]
        assert out_w.column("s").to_pylist() == [pytest.approx(300.0), pytest.approx(300.0)]


def test_staging_bytes_returns_to_zero():
    """The port's ``device_cache.staging_bytes`` reads the shuffle
    fetcher's staging counter, which settles back once a fetch is drained,
    and ``stats()`` carries it."""
    from arrow_ballista_tpu_torch.serde.scheduler_types import (
        ExecutorMetadata,
        PartitionId,
        PartitionLocation,
        PartitionStats,
    )
    from arrow_ballista_tpu_torch.shuffle import (
        FetchPolicy,
        ShuffleFetcher,
        ShuffleReaderExec,
    )
    from arrow_ballista_tpu_torch.shuffle import memory_store

    schema = pa.schema([pa.field("k", pa.int64()), pa.field("v", pa.float64())])
    meta = ExecutorMetadata("e1", "127.0.0.1", 1)
    rng = np.random.default_rng(7)
    locs = []
    for i in range(6):
        batches = [
            pa.record_batch({"k": pa.array(np.full(64, i * 1000 + b), pa.int64()),
                             "v": pa.array(rng.normal(size=64), pa.float64())},
                            schema=schema)
            for b in range(2)
        ]
        path = memory_store.put("jobTorchT", 1, 0, i, schema, batches)
        locs.append(PartitionLocation(PartitionId("jobTorchT", 1, 0), meta,
                                      PartitionStats(128, 2, 0), path))
    metrics = ShuffleReaderExec(1, schema, [locs]).metrics
    base = device_cache.staging_bytes()
    assert device_cache.stats()["staging_bytes"] == base
    out = list(ShuffleFetcher(locs, FetchPolicy(concurrency=3), metrics))
    assert sum(b.num_rows for b in out) == 6 * 128
    assert device_cache.staging_bytes() == base


class _Provider:
    """A weakref-able stand-in for a TableProvider."""


def _cache_value(n_bytes: int):
    t = torch.zeros(n_bytes // 8, dtype=torch.int64)
    return ([(t, None, [None])], None, None, 0, 64)


@pytest.fixture
def _isolated_cache():
    saved = (dict(device_cache._CACHE), set(device_cache._REGISTERED),
             device_cache._total_bytes, device_cache._budget)
    device_cache.clear()
    try:
        yield
    finally:
        device_cache.clear()
        device_cache._CACHE.update(saved[0])
        device_cache._REGISTERED.update(saved[1])
        device_cache._total_bytes = saved[2]
        device_cache._budget = saved[3]


def test_cache_budget_evicts_least_recently_used(_isolated_cache):
    assert device_cache.DEFAULT_BUDGET_BYTES == 4 << 30
    device_cache.set_budget(3000)
    prov = _Provider()
    for part in range(3):
        device_cache.put(prov, part, "sig", _cache_value(1000))
    assert device_cache.stats()["bytes"] == 3000
    assert device_cache.get(prov, 0, "sig") is not None  # 0 is now the newest
    device_cache.put(prov, 3, "sig", _cache_value(1000))  # over: evicts 1
    assert device_cache.get(prov, 1, "sig") is None
    for part in (0, 2, 3):
        assert device_cache.get(prov, part, "sig") is not None
    assert device_cache.stats() == dict(
        entries=3, bytes=3000, budget=3000,
        staging_bytes=device_cache.staging_bytes(),
    )
    device_cache.put(prov, 9, "sig", _cache_value(4000))  # past the budget: skipped
    assert device_cache.get(prov, 9, "sig") is None
    device_cache.set_budget(1000)  # shrinking evicts oldest first
    assert [device_cache.get(prov, p, "sig") is not None for p in (0, 2, 3)] == [
        False, False, True]


def test_dropping_the_provider_drops_its_entries(_isolated_cache):
    keep, drop = _Provider(), _Provider()
    device_cache.put(keep, 0, "a", _cache_value(800))
    device_cache.put(drop, 0, "a", _cache_value(800))
    device_cache.put(drop, 1, "b", _cache_value(800))
    assert device_cache.stats()["entries"] == 3
    del drop
    gc.collect()
    assert device_cache.stats() == dict(
        entries=1, bytes=800, budget=device_cache.DEFAULT_BUDGET_BYTES,
        staging_bytes=device_cache.staging_bytes(),
    )
    assert device_cache.get(keep, 0, "a") is not None


def test_cache_survives_concurrent_task_threads(_isolated_cache):
    """Executor task threads share the cache: many threads putting,
    getting and dropping providers at once leave the byte count equal to
    the entries it holds and within the budget (a lost update breaks it)."""
    import threading

    device_cache.set_budget(40 * 800)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def work(seed):
        try:
            rng = np.random.default_rng(seed)
            provs = [_Provider() for _ in range(3)]
            for i in range(100):
                p = provs[int(rng.integers(0, 3))]
                device_cache.put(p, int(rng.integers(0, 8)), "s", _cache_value(800))
                device_cache.get(p, int(rng.integers(0, 8)), "s")
                if i % 25 == 24:
                    provs[0] = _Provider()  # the old one goes: its finalizer evicts
                    gc.collect()
        except Exception as e:  # reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    with device_cache._LOCK:
        held = sum(nb for _v, nb in device_cache._CACHE.values())
        assert device_cache._total_bytes == held <= 40 * 800


def test_repeat_query_entries_leave_with_the_table():
    """A session's cached entries go when its table's provider is dropped."""
    t = _mktable(n=3000, seed=8)
    ctx = _port()
    _reg(ctx, "t", t)
    before = device_cache.stats()["entries"]
    _run(ctx, GROUPED)
    assert device_cache.stats()["entries"] == before + 1
    ctx.deregister_table("t")
    del ctx
    gc.collect()
    assert device_cache.stats()["entries"] == before


# ---------------------------------------------- the runner refuses a join
JOIN_RUNNER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np, pyarrow as pa
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu_torch.errors import ExecutionError
from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec

ctx = tbt.SessionContext(tbt.BallistaConfig({"ballista.tpu.min_rows": "0"}),
                         device="cpu")
ctx.register_arrow_table("dim", pa.table({"pk": pa.array(np.arange(10)),
                                          "dv": pa.array(np.ones(10))}))
ctx.register_arrow_table("fact", pa.table({"fk": pa.array(np.arange(50) % 10),
                                           "g": pa.array(np.arange(50) % 3),
                                           "x": pa.array(np.ones(50))}))
plan = ctx.sql("select g, sum(x * dv) from dim, fact where pk = fk group by g").physical_plan()
stack, stage = [plan], None
while stack:
    node = stack.pop()
    if isinstance(node, TorchStageExec):
        stage = node
    stack.extend(node.children())
assert stage is not None and stage.fused.join is not None
try:
    stage._run_fused([], 64, None, None, False)
except ExecutionError as e:
    print("RAISED", e)
"""


@pytest.mark.parametrize("optimize", [False, True], ids=["plain", "python -O"])
def test_fused_runner_raises_on_a_join_stage(optimize):
    """A join-fused stage that reached the fused runner raises
    ExecutionError, also under ``python -O`` (where an assert would be
    gone)."""
    cmd = [sys.executable] + (["-O"] if optimize else []) + ["-c", JOIN_RUNNER, ROOT]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "RAISED" in r.stdout, r.stdout


# ----------------------------------------- the multi-entry kernel's twin
_AGG_SQL = ("select g, count(*), count(v), sum(v), avg(v), min(v), max(v), "
            "sum(i), min(i), max(i) from t where k > -0.5 group by g")


def _entry_batch(n: int, cap: int, seed: int):
    """One entry's rows: nulls, NaN, ±0.0 and int64 sums past 2^53."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1e3, 1e3, n)
    v[rng.random(n) < 0.02] = np.nan
    v[rng.random(n) < 0.05] = -0.0
    i = rng.integers(-(10**12), 10**12, n)
    k = rng.uniform(-1, 1, n)
    gid = rng.integers(0, cap, n).astype(np.int32)
    batch = pa.RecordBatch.from_pydict({
        "g": pa.array(gid.astype(np.int64)),
        "v": pa.array(v, pa.float64(), mask=rng.random(n) < 0.1),
        "i": pa.array(i, pa.int64(), mask=rng.random(n) < 0.1),
        "k": pa.array(k, pa.float64(), mask=rng.random(n) < 0.05),
    })
    return batch, gid


def _find(plan, cls):
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, cls):
            return node
        stack.extend(node.children())
    raise AssertionError(f"no {cls.__name__}")


def _stages(schema):
    """The port's and the reference's device stages of _AGG_SQL over a
    table of ``schema``."""
    from arrow_ballista_tpu.ops.stage_compiler import TpuStageExec

    empty = schema.empty_table()
    port, jax_dev = _port(), _jax(True)
    for c in (port, jax_dev):
        c.register_arrow_table("t", empty)
    tst = _find(port.sql(_AGG_SQL).physical_plan(), TorchStageExec)
    jst = _find(jax_dev.sql(_AGG_SQL).physical_plan(), TpuStageExec)
    return tst, jst


def _port_entries(tst, batches, gids):
    from arrow_ballista_tpu_torch.ops.bridge import DeviceStaging

    entries = []
    for batch, gid in zip(batches, gids):
        args = tst._kernel_args(batch, batch.num_rows, gid, DeviceStaging(CPU), None)
        entries.append((args.pop(), None, args))
    return entries


def _twin_rows(tst, entries):
    """The (gid, tail, pred, pvalid, values, valids) rows of each entry, and
    the field layout, as the multi-entry stage function builds them."""
    closures, columns, ops, cols = TK._agg_layout(tst.specs, tst._arg_closures)
    program = TK.ExprProgram(tst._filter_closure, closures, columns)
    rows = []
    for gid, tail, arrays in entries:
        env = dict(zip(tst._flat_names, arrays))
        pred, pvalid, values, valids = TK.expr_eval(program, env, gid.shape[0], CPU)
        rows.append((gid, tail, pred, pvalid, values, valids))
    return rows, ops, cols


CASES = [(e, cap) for e in (1, 3, 32) for cap in (1, 64, 4096)]


@pytest.mark.parametrize("n_entries,cap", CASES)
def test_entries_twin_equals_a_loop_of_b1_twins(n_entries, cap):
    """The multi-entry twin folds bit-identically to one B1 twin call per
    entry in entry order (ragged entry sizes)."""
    rng = np.random.default_rng(n_entries * 7 + cap)
    sizes = rng.integers(1, 300, n_entries)
    parts = [_entry_batch(int(n), cap, seed=100 + j) for j, n in enumerate(sizes)]
    tst, _ = _stages(parts[0][0].schema)
    entries = _port_entries(tst, [b for b, _ in parts],
                            [np.asarray(g) for _, g in parts])
    rows, ops, cols = _twin_rows(tst, entries)
    loop = TK.init_states(tst.specs, cap, CPU)
    for r in rows:
        TK.segment_agg_reference(*r, ops, cols, loop)
    got = TK.segment_agg_entries(rows, ops, cols, TK.init_states(tst.specs, cap, CPU))
    assert torch.equal(got, loop)
    # the stage function (closures per entry, then the one call) agrees too
    assert torch.equal(tst._entries_kernel(cap)(entries), loop)


@pytest.mark.parametrize("n_entries,cap", CASES)
def test_entries_twin_matches_the_reference_fused_for(n_entries, cap):
    """The port's multi-entry stage function against the reference's
    ``_fused_for`` (every entry's kernel, ``combine_states``,
    ``pack_states`` in one jitted program) over the same entries: floats
    within rel 1e-9, everything else exact."""
    from arrow_ballista_tpu.ops import kernels as JK

    old_mode = JK._PRECISION["mode"]
    JK.set_precision("x64")
    JK.set_agg_algorithm("scatter")
    try:
        rng = np.random.default_rng(n_entries * 11 + cap)
        sizes = rng.integers(1, 300, n_entries)
        parts = [_entry_batch(int(n), cap, seed=200 + j) for j, n in enumerate(sizes)]
        tst, jst = _stages(parts[0][0].schema)
        batches = [b for b, _ in parts]
        gids = [g for _, g in parts]
        state = tst._entries_kernel(cap)(_port_entries(tst, batches, gids))
        got = TK.unpack_host(tst.specs, TK.fetch_states(state))

        flat, shapes = [], []
        for batch, gid in zip(batches, gids):
            n = batch.num_rows
            args, trivial = jst._kernel_args(batch, n, n, None)
            tail = np.ones(n, dtype=bool)
            args = [tail if j in trivial else a for j, a in enumerate(args)]
            flat += [gid, tail, *args]
            shapes.append(n)
        fn = jst._fused_for(cap, tuple(shapes), len(args), None)
        want = JK.unpack_host(jst.specs, np.asarray(fn(*flat)), "x64")
    finally:
        JK.set_agg_algorithm(None)
        JK._PRECISION["mode"] = old_mode
    roles = [r for s in tst.specs for r in TK.state_fields(s)] + ["add"]
    assert len(got) == len(want) == len(roles)
    for f, (w, g, role) in enumerate(zip(want, got, roles)):
        w, g = np.asarray(w), np.asarray(g)
        if w.dtype.kind == "f" or g.dtype.kind == "f":
            w, g = w.astype(np.float64), g.astype(np.float64)
            assert np.array_equal(np.isnan(w), np.isnan(g)), f
            ok = ~np.isnan(w)
            if role == "add":
                np.testing.assert_allclose(g[ok], w[ok], rtol=REL, atol=0, err_msg=str(f))
            else:
                assert np.array_equal(w[ok].view(np.int64), g[ok].view(np.int64)), f
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(f))


def test_sort_route_capacity_replays_entries_one_by_one():
    """At a capacity whose route is the sort route the multi-entry
    (scatter) kernel does not run: the retained entries replay one
    one-batch launch each (``fused_streamed``), on the cache path and on a
    cache hit, with the same answer."""
    t = _mktable(n=9000, groups=40, seed=9)
    extra = {"ballista.batch.size": 2048}
    want, _ = _run(_reg_and(_jax(False, **extra), t), GROUPED)
    TK.set_agg_algorithm("sort")
    try:
        ctx = _reg_and(_port(**extra), t)
        cold, m1 = _run(ctx, GROUPED)
        warm, m2 = _run(ctx, GROUPED)
    finally:
        TK.set_agg_algorithm(None)
    for m in (m1, m2):
        assert m.get("fused_streamed", 0) == 1 and m.get("fused_dispatches", 0) == 0, m
    assert m2.get("cache_hits", 0) == 1, m2
    _assert_tables_equal(want, cold)
    assert cold.equals(warm)


def _reg_and(ctx, t):
    _reg(ctx, "t", t)
    return ctx
