"""The PyTorch port's x32 mode on every route the JAX package takes in it,
against the JAX package in x32, on the CPU.

Both packages are forced to x32 (``set_precision("x32")``); the port runs
on ``device="cpu"`` (the kernels' plain twins), the JAX package's device
stage on its CPU backend, the same seeded tables go to both and to the
JAX package's CPU operators, and both device answers must meet the CPU
operators' at the reference's x32 bar: floats within rel 1e-6, integers
and f64 extrema exact.  The two device stages must also route alike: the
same fold decision, ``keyed_path`` (taken or not), ``tpu_fallback``,
``join_fallback`` and ``highcard_fallback``.

Cases here: the 6 of ``tests/test_precision_x32.py`` that need the keyed
route, the statistical aggregates and the join fold (the TPC-H sweep, one
case a query; the keyed f64 min/max; the variance family on the three
routes; its cancellation guard), ``tests/test_i64_x32.py``'s q3 over
order keys past 2^31, the x32 cases of ``tests/test_device_median.py``,
the x32 draws of ``tests/test_property_oracle.py`` and the x32 pass-through
exchange of ``tests/test_mesh_repartition.py``.  ``x32_three`` is shared
by the other ``test_torch_x32_*`` files.
"""

import numpy as np
import pyarrow as pa
import pytest

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu.ops import stage_compiler as JSC
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops import stage_compiler as TSC
from benchmarks.tpch.datagen import gen_table
from benchmarks.tpch.queries import QUERIES

REL = 1e-6  # the reference's x32 bar
ROUTE_KEYS = ("tpu_fallback", "join_fallback", "highcard_fallback", "cpu_fallback")
_TPCH: dict = {}


@pytest.fixture(autouse=True)
def x32_both(monkeypatch):
    """Both packages in x32, both groups~rows detectors shrunk so small
    tables route keyed; modes and routes restored after."""
    monkeypatch.setattr(TSC, "HIGHCARD_MIN_GROUPS", 16)
    monkeypatch.setattr(JSC, "_HIGHCARD_MIN_GROUPS", 16)
    old = JK._PRECISION["mode"]
    JK.set_precision("x32")
    TK.set_precision("x32")
    try:
        yield
    finally:
        TK.set_precision(None)
        TK.set_agg_algorithm(None)
        JK.set_agg_algorithm(None)
        JK._PRECISION["mode"] = old


def tpch(name: str, sf: float = 0.01) -> pa.Table:
    if (name, sf) not in _TPCH:
        _TPCH[(name, sf)] = gen_table(name, sf)
    return _TPCH[(name, sf)]


def settings(tpu: bool, extra: dict) -> dict:
    s = {"ballista.tpu.enable": str(tpu).lower(), "ballista.tpu.min_rows": "0",
         "ballista.mesh.enable": "false"}
    s.update({k: str(v) for k, v in extra.items()})
    return s


def stages(plan, cls) -> list:
    out, stack = [], [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, cls):
            out.append(node)
        stack.extend(node.children())
    return out


def metrics(nodes) -> dict:
    m: dict = {}
    for s in nodes:
        for k, v in s.metrics.to_dict().items():
            m[k] = m.get(k, 0) + v
    return m


def assert_x32_equal(want: pa.Table, got: pa.Table, what: str = "", rel: float = REL,
                     exact=()) -> None:
    """Same rows in any order: floats within ``rel`` (the columns in
    ``exact`` bit for bit, NaN matching NaN), everything else exact."""
    assert want.schema.names == got.schema.names, what
    assert want.num_rows == got.num_rows, (what, want.num_rows, got.num_rows)
    names = want.column_names
    key = [(c, "ascending") for c in names
           if not pa.types.is_floating(want.schema.field(c).type)]
    key += [(c, "ascending") for c in names if (c, "ascending") not in key]
    try:
        want, got = want.sort_by(key), got.sort_by(key)
    except Exception:  # noqa: BLE001 - unsortable types: engine order
        pass
    for name in names:
        for x, y in zip(want.column(name).to_pylist(), got.column(name).to_pylist()):
            if isinstance(x, float) and x is not None and y is not None and name not in exact:
                assert y == pytest.approx(x, rel=rel, nan_ok=True), (what, name, x, y)
            elif isinstance(x, float) and x != x:
                assert y != y, (what, name)
            else:
                assert x == y, (what, name, x, y)


def x32_three(sql: str, tables: dict, parts: int = 1, batches=None, budget=None,
              exact=(), routes: bool = True, **extra):
    """Run ``sql`` on the port in x32, the JAX device stage in x32 and the
    JAX CPU operators over the same tables; assert both device answers
    meet the CPU operators' and (``routes``) that the two device stages
    fold and route alike.  ``batches`` cuts each table into record
    batches of that many rows, ``budget`` sets every device stage's keyed
    buffer budget in bytes.  Returns (port metrics, JAX metrics, port
    answer).

    pyarrow's hash join cuts its output into chunks as its pool threads
    finish, and a stage routes on its first batch (groups ~ rows), so the
    three runs use one pool thread: both device stages then see the same
    batches and the route comparison compares like with like."""
    from arrow_ballista_tpu.catalog import MemoryTable as JMem
    from arrow_ballista_tpu_torch.catalog import MemoryTable as TMem

    out = []
    threads = pa.cpu_count()
    pa.set_cpu_count(1)
    try:
        for mod, mem, cls, tpu in ((tbt, TMem, TSC.TorchStageExec, True),
                                   (jbt, JMem, JSC.TpuStageExec, True),
                                   (jbt, JMem, None, False)):
            cfg = mod.BallistaConfig(settings(tpu, extra))
            ctx = (mod.SessionContext(cfg, device="cpu") if mod is tbt
                   else mod.SessionContext(cfg))
            for name, t in tables.items():
                if batches:
                    ctx.register_table(name, mem([t.to_batches(max_chunksize=batches)],
                                                 t.schema))
                else:
                    ctx.register_table(name, mem.from_table(t, parts))
            plan = ctx.sql(sql).physical_plan()
            found = stages(plan, cls) if cls else []
            if budget is not None:
                for s in found:
                    s.keyed_buffer_bytes = budget
            out.append((ctx.execute(plan), found))
    finally:
        pa.set_cpu_count(threads)
    (port, pst), (jgot, jst), (want, _) = out
    assert_x32_equal(want, port, "port vs the CPU operators", exact=exact)
    assert_x32_equal(want, jgot, "JAX vs the CPU operators", exact=exact)
    pm, jm = metrics(pst), metrics(jst)
    if routes:
        assert [s.fused.join is not None for s in pst] == [
            s.fused.join is not None for s in jst], "fold decisions differ"
        assert bool(pm.get("keyed_path", 0)) == bool(jm.get("keyed_path", 0)), (pm, jm)
        assert {k: pm.get(k, 0) for k in ROUTE_KEYS} == {k: jm.get(k, 0) for k in ROUTE_KEYS}, (
            pm, jm)
    assert all(s._mode == "x32" for s in pst)
    return pm, jm, port


# --------------------------------------------- tests/test_precision_x32.py
def _tpch_tables() -> dict:
    return {n: tpch(n) for n in ("lineitem", "orders", "customer", "part", "partsupp",
                                 "supplier", "nation", "region")}


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_tpch_x32_sweep_matches_oracle(q):
    """Twin of test_all_tpch_x32_device_path_matches_oracle, one case a
    query: every query on the device path in x32 (joins folded where the
    reference folds them) meets the CPU operators at rel 1e-6."""
    x32_three(QUERIES[q], _tpch_tables(), parts=2)


def _minmax_adversarial_table(n=6000, n_groups=30, seed=13) -> pa.Table:
    rng = np.random.default_rng(seed)
    k = rng.integers(0, n_groups, n)
    base = rng.uniform(1.0, 100.0, n_groups)[k]
    v = base * (1.0 + rng.integers(-4, 5, n) * 1e-13)
    vmask = rng.uniform(size=n) < 0.05
    return pa.table({"k": pa.array(k.astype(np.int64)),
                     "v": pa.array(v, pa.float64(), mask=vmask)})


def test_x32_minmax_f64_bit_exact_keyed():
    """Twin of test_x32_minmax_f64_bit_exact_keyed: the f64 extrema of
    sub-f32-ulp spreads, bit-exact through the keyed route."""
    pm, jm, _ = x32_three("select k, min(v) as mn, max(v) as mx from t group by k",
                          {"t": _minmax_adversarial_table(n=4000, n_groups=1200)},
                          exact=("mn", "mx"), **{"ballista.tpu.highcard_mode": "device"})
    assert pm.get("keyed_path", 0) >= 1 and pm.get("tpu_fallback", 0) == 0, pm


@pytest.mark.parametrize("algo", ["matmul", "scatter", "sort"])
def test_x32_variance_family_on_device(algo):
    """Twin of test_x32_variance_family_on_device: the square pair (B12f)
    and the double-float moments; x32 forces the sort route whatever
    ``algo`` says, as the reference does."""
    rng = np.random.default_rng(21)
    n = 8000
    t = pa.table({"k": pa.array(rng.integers(0, 40, n).astype(np.int64)),
                  "v": pa.array(rng.uniform(0, 1000, n), pa.float64(),
                                mask=rng.uniform(size=n) < 0.05)})
    sql = ("select k, stddev(v) as sd, var(v) as vr, stddev_pop(v) as sdp, "
           "var_pop(v) as vrp, avg(v) as a from t group by k order by k")
    JK.set_agg_algorithm(algo)
    TK.set_agg_algorithm(algo)
    pm, _jm, _ = x32_three(sql, {"t": t}, parts=2)
    assert pm.get("tpu_fallback", 0) == 0 and pm.get("device_time_ns", 0) > 0, pm


def test_x32_variance_stage_forces_the_sort_route():
    ctx = tbt.SessionContext(tbt.BallistaConfig(settings(True, {})), device="cpu")
    ctx.register_arrow_table("t", pa.table({"k": [1, 2], "v": [1.0, 2.0]}))
    plan = ctx.sql("select k, var(v) as vr, sum(v) as s from t group by k").physical_plan()
    (stage,) = stages(plan, TSC.TorchStageExec)
    TK.set_agg_algorithm("matmul")
    assert stage._force_sort and stage._kernel_for(64, 100) is stage._kernels[
        (64, "sort", False) + TK.algo_cache_token()]
    plan = ctx.sql("select k, sum(v) as s from t group by k").physical_plan()
    assert not stages(plan, TSC.TorchStageExec)[0]._force_sort


def test_x32_variance_cancellation_guard_falls_back():
    """Twin of test_x32_variance_cancellation_guard_falls_back: a tiny
    spread around a huge mean cancels past x32's moments (the guard's
    1e-6), so both packages re-run on the CPU operators."""
    rng = np.random.default_rng(22)
    n = 4000
    t = pa.table({"k": pa.array(rng.integers(0, 8, n).astype(np.int64)),
                  "v": pa.array(1e9 + rng.uniform(0, 1e-3, n))})
    pm, jm, _ = x32_three("select k, var(v) as vr from t group by k order by k", {"t": t})
    assert pm.get("tpu_fallback", 0) >= 1, (pm, jm)  # equal to the JAX count


def test_x32_variance_guard_threshold_is_1e6():
    """Conditioned just inside x32's guard (var above 1e-6 of the mean
    square) the device answers; x64's guard is 1e-8."""
    rng = np.random.default_rng(23)
    n = 4000
    t = pa.table({"k": pa.array(rng.integers(0, 4, n).astype(np.int64)),
                  "v": pa.array(100.0 + rng.uniform(-1.0, 1.0, n))})
    pm, _jm, _ = x32_three("select k, var_pop(v) as vr from t group by k", {"t": t})
    assert pm.get("tpu_fallback", 0) == 0, pm


def test_q3_with_big_orderkeys_no_fallback():
    """Twin of tests/test_i64_x32.py::test_q3_with_big_orderkeys_no_fallback:
    order keys past int32 keep both packages' answers exact; the join
    build keys past 2^31 join on the CPU (``join_fallback``), as the
    reference's x32 rule says."""
    off = 1 << 40
    li, od = tpch("lineitem"), tpch("orders")
    li = li.set_column(li.schema.get_field_index("l_orderkey"), "l_orderkey",
                       pa.array(li.column("l_orderkey").to_numpy() + off, pa.int64()))
    od = od.set_column(od.schema.get_field_index("o_orderkey"), "o_orderkey",
                       pa.array(od.column("o_orderkey").to_numpy() + off, pa.int64()))
    pm, _jm, _ = x32_three(QUERIES[3], {"lineitem": li, "orders": od,
                                        "customer": tpch("customer")})
    assert pm.get("cpu_fallback", 0) == 0, pm


# --------------------------------------------- tests/test_device_median.py
def _median_data(n=5000, n_groups=37, seed=17, null_frac=0.07) -> pa.Table:
    rng = np.random.default_rng(seed)
    k = rng.integers(0, n_groups, n)
    v = rng.uniform(0, 1000, n)
    vmask = rng.uniform(size=n) < null_frac
    iv = rng.integers(-500, 500, n)
    return pa.table({"k": pa.array(k.astype(np.int64)),
                     "v": pa.array(v, pa.float64(), mask=vmask),
                     "iv": pa.array(iv.astype(np.int64))})


def _corr_data() -> pa.Table:
    rng = np.random.default_rng(29)
    n = 6000
    x = rng.uniform(0, 100, n)
    return pa.table({
        "k": pa.array(rng.integers(0, 30, n).astype(np.int64)),
        "x": pa.array(x, pa.float64(), mask=rng.uniform(size=n) < 0.05),
        "y": pa.array(3.0 * x + rng.normal(0, 25, n), pa.float64(),
                      mask=rng.uniform(size=n) < 0.05),
    })


def _collision_data() -> pa.Table:
    vals = [1.0, 1.000000001, 1.0, 1.000000001, 1.0000000005, 1.0, 1.000000002]
    return pa.table({"k": pa.array([1] * len(vals) + [2, 2, 2], pa.int64()),
                     "v": pa.array(vals + [5.0, 5.000000001, 5.0], pa.float64())})


MEDIAN_CASES = {
    # name: (sql, table, columns compared bit for bit)
    "median_exact": ("select k, median(v) as md, count(*) as c from t group by k",
                     _median_data, ("md",)),
    "median_mixed_with_stddev_and_sums": (
        "select k, median(v) as md, stddev(v) as sd, avg(v) as a, sum(iv) as s "
        "from t group by k", _median_data, ("md",)),
    "median_int_column_and_two_medians": (
        "select k, median(v) as mv, median(iv) as mi from t group by k", _median_data,
        ("mv", "mi")),
    "count_distinct": ("select k, count(distinct iv) as cd, count(distinct v) as cdv, "
                       "count(*) as c from t group by k", _median_data, ()),
    "corr": ("select k, corr(x, y) as r, count(*) as c from t group by k", _corr_data, ()),
    "median_distinct_hi_word_collision": (
        "select k, median(v) as md, count(distinct v) as cd from t group by k",
        _collision_data, ("md",)),
}


@pytest.mark.parametrize("case", sorted(MEDIAN_CASES))
def test_statistical_aggregate_x32_case(case):
    """The x32 cases of tests/test_device_median.py: the keyed route at
    any cardinality, medians and distinct counts exact (order pairs with
    int32 indices), corr at rel 1e-6 (double-float passes, f32 centring)."""
    sql, make, exact = MEDIAN_CASES[case]
    pm, _jm, _ = x32_three(sql, {"t": make()}, exact=exact)
    assert pm.get("keyed_path", 0) >= 1 and pm.get("tpu_fallback", 0) == 0, pm


# ----------------------------------------- tests/test_property_oracle.py
def _random_table(rng, n):
    return pa.table({
        "k1": pa.array(rng.integers(0, int(rng.integers(2, 60)), n).astype(np.int64)),
        "k2": pa.array(rng.choice(["a", "b", "c", "d"], n).tolist()),
        # positive floats: x32 ships f32 inputs
        "v": pa.array(rng.uniform(0.5, 100.0, n), mask=rng.random(n) < 0.05),
        "w": pa.array(rng.integers(-1000, 1000, n).astype(np.int64)),
    })


_PROPERTY_SQL = (
    "select k1, sum(v) as s, count(*) as c, min(w) as mn, max(v) as mx, avg(w) as a "
    "from t where w > {lo} group by k1",
    "select k1, k2, sum(w) as s, count(v) as c from t group by k1, k2",
    "select k2, median(v) as md, count(distinct k1) as cd from t group by k2",
    "select k1, stddev_pop(v) as sd, var(v) as vr from t group by k1",
)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_property_oracle_x32_draw(seed):
    """The x32 draws of tests/test_property_oracle.py: a random table, a
    random query shape and route, the device answer at the oracle's 3e-6."""
    rng = np.random.default_rng(1000 + seed)
    t = _random_table(rng, int(rng.integers(500, 3000)))
    sql = _PROPERTY_SQL[seed % len(_PROPERTY_SQL)].format(lo=int(rng.integers(-900, 900)))
    extra = {"ballista.tpu.highcard_mode": "device"} if rng.random() < 0.5 else {}
    x32_three(sql, {"t": t}, parts=int(rng.integers(1, 3)), **extra)


# --------------------------------------- tests/test_mesh_repartition.py:172
def test_mesh_repartition_x32_pass_through_exact(monkeypatch):
    """Pass-through payloads (int64 past int32, f64, timestamps) survive
    the mesh exchange exactly in x32 (the i64pair layout), as the
    reference's do, on an 8-shard CPU mesh."""
    from arrow_ballista_tpu.parallel import mesh as JM
    from arrow_ballista_tpu_torch.parallel import mesh as TM

    monkeypatch.setattr(TM, "CPU_DEVICES", 8)
    rng = np.random.default_rng(5)
    n = 4000
    batch = pa.RecordBatch.from_pydict({
        "k": pa.array(rng.integers(0, 97, n).astype(np.int64)),
        "big": pa.array(rng.integers(2**40, 2**62, n).astype(np.int64)),
        "f": pa.array(rng.normal(0, 1e200, n)),
        "ts": pa.array(rng.integers(0, 2**60, n).astype("datetime64[ns]"), pa.timestamp("ns")),
    })
    dest = (batch.column("k").to_numpy() % 8).astype(np.int32)
    outs = []
    for M, mesh in ((JM, JM.make_mesh(8)), (TM, TM.make_mesh(8, "cpu"))):
        ex = M.BatchExchanger(mesh, batch.schema, 1024)
        recv, rv, dropped = ex.exchange(dest, np.ones(n, bool), ex.to_columns(batch))
        assert dropped == 0
        outs.append(pa.Table.from_batches(ex.to_batches(recv, rv)).sort_by(
            [("k", "ascending"), ("big", "ascending")]))
    want = pa.Table.from_batches([batch]).sort_by([("k", "ascending"), ("big", "ascending")])
    for got in outs:
        assert got.column("big").equals(want.column("big"))
        assert got.column("ts").equals(want.column("ts"))
        assert np.array_equal(got.column("f").to_numpy().view(np.int64),
                              want.column("f").to_numpy().view(np.int64))
