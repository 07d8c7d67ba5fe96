"""The PyTorch port's x32 mode against the JAX package's, on the CPU.

Twins of 10 of the 16 cases of ``tests/test_precision_x32.py``: q1 and
q6, the plan still accelerating, the double-float sum beating a naive f32
one, the non-pow2 mesh shards (8 CPU shards), the int64 range re-run, the
timestamp that does not lower, and the bit-exact f64 min/max over the
matmul, scatter and sort routes.  The other six (the TPC-H sweep, the
keyed min/max, the variance family three ways and its cancellation
guard) run x32 on the keyed route, the statistical aggregates and the
join fold, which the port's x32 mode takes as the reference's does; their
twins are in ``tests/test_torch_x32_routes.py`` beside the other cases of
those routes.

Both packages are forced to x32 (``set_precision("x32")``), the port on
``device="cpu"`` (the kernels' plain twins), the same seeded inputs go to
both, and both are held to the CPU operators at the reference's x32 bar:
floats within rel 1e-6, integers and f64 extrema exact.
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec
from arrow_ballista_tpu_torch.parallel.mesh_stage import MeshGangExec
from benchmarks.tpch.datagen import gen_table
from benchmarks.tpch.queries import QUERIES

REL = 1e-6  # the reference's x32 bar
_TPCH: dict = {}


@pytest.fixture(autouse=True)
def x32_both():
    """Both packages in x32; both modes and routes restored after."""
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


def settings(tpu: bool, **extra) -> dict:
    out = {"ballista.tpu.enable": str(tpu).lower(), "ballista.tpu.min_rows": "0"}
    out.update({k: str(v) for k, v in extra.items()})
    return out


def port_metrics(plan) -> dict:
    """The summed metrics of the plan's device nodes (stages and gangs)."""
    out: dict = {}
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, (TorchStageExec, MeshGangExec)):
            for k, v in node.metrics.to_dict().items():
                out[k] = out.get(k, 0) + v
        stack.extend(node.children())
    return out


def three(sql: str, tables: dict, partitions: int = 2, algo=None, **extra):
    """``(cpu operators, JAX x32, port x32 on the CPU, port metrics)`` over
    the same tables, ``algo`` forced on both device legs."""
    jcpu = jbt.SessionContext(jbt.BallistaConfig(settings(False, **extra)))
    jdev = jbt.SessionContext(jbt.BallistaConfig(settings(True, **extra)))
    port = tbt.SessionContext(tbt.BallistaConfig(settings(True, **extra)), device="cpu")
    for name, t in tables.items():
        for c in (jcpu, jdev, port):
            c.register_arrow_table(name, t, partitions=partitions)
    want = jcpu.sql(sql).collect()
    JK.set_agg_algorithm(algo)
    TK.set_agg_algorithm(algo)
    try:
        jgot = jdev.sql(sql).collect()
        plan = port.sql(sql).physical_plan()
        got = port.execute(plan)
    finally:
        JK.set_agg_algorithm(None)
        TK.set_agg_algorithm(None)
    return want, jgot, got, port_metrics(plan)


def assert_close(a: pa.Table, b: pa.Table, what: str, rel: float = REL) -> None:
    assert a.schema.names == b.schema.names, what
    assert a.num_rows == b.num_rows, what
    keys = [(c, "ascending") for c in a.column_names]
    try:
        a, b = a.sort_by(keys), b.sort_by(keys)
    except Exception:  # noqa: BLE001 - unsortable types: engine order
        pass
    for name in a.schema.names:
        for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
            if isinstance(x, float) and x is not None and y is not None:
                assert y == pytest.approx(x, rel=rel), (what, name)
            else:
                assert x == y, (what, name)


def assert_no_fallback(m: dict) -> None:
    for k in ("tpu_fallback", "cpu_fallback", "highcard_fallback", "mesh_fallback"):
        assert not m.get(k, 0), m
    assert "device_time_ns" in m or "mesh_stage_time_ns" in m, m


@pytest.mark.parametrize("q", [1, 6])
def test_tpch_x32_matches_oracle_at_1e6(q):
    """Twin of test_q1_x32_matches_oracle_at_1e6 / test_q6_..."""
    want, jgot, got, m = three(QUERIES[q], {"lineitem": tpch("lineitem")})
    assert_close(want, jgot, "jax")
    assert_close(want, got, "port")
    assert_no_fallback(m)


def test_x32_plan_still_accelerates():
    ctx = tbt.SessionContext(tbt.BallistaConfig(settings(True)), device="cpu")
    ctx.register_arrow_table("lineitem", tpch("lineitem"), partitions=2)
    plan = ctx.sql(QUERIES[1]).physical_plan()
    stages = []
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, TorchStageExec):
            stages.append(node)
        stack.extend(node.children())
    assert stages and all(s._mode == "x32" for s in stages)
    assert "TorchStageExec" in ctx.sql(QUERIES[1]).explain()


def test_df32_segment_sum_beats_naive_f32():
    """4M adversarially spread positive values in one group: the double-
    float sum (D's scatter form, the CPU block rule) tracks the f64 sum
    where a sequential f32 sum drifts, and meets the reference's."""
    import jax

    rng = np.random.default_rng(0)
    n = 1 << 22
    v = rng.uniform(0.001, 105000.0, n)
    seg = np.zeros(n, dtype=np.int32)
    oracle = v.sum()
    f32 = v.astype(np.float32)
    jhi, jlo = jax.jit(lambda x, s: JK._segment_sum_df32(x, s, 4))(f32, seg)
    jdf = float(np.asarray(jhi, np.float64)[0] + np.asarray(jlo, np.float64)[0])
    g = torch.from_numpy(seg)
    hi, lo, _ = TK.df32_agg(g, None, None, None, [torch.from_numpy(f32)], [None],
                            [(0, -1)], [], 4, TK.df32_scatter_block(n, 4, "cpu"))
    df = float(hi[0, 0].double() + lo[0, 0].double())
    naive = float(np.cumsum(f32, dtype=np.float32)[-1])
    assert abs(df - oracle) / oracle < 1e-6
    assert abs(df - oracle) <= abs(naive - oracle)
    assert df == pytest.approx(jdf, rel=REL)


def test_x32_mesh_agg_non_pow2_shards():
    """1000-row shards (not pow2) on an 8-shard CPU mesh: the df32 sum pads
    internally; equal to the reference's 8-device step."""
    from arrow_ballista_tpu.parallel import mesh as JM
    from arrow_ballista_tpu_torch.parallel import mesh as TM

    n = 8 * 1000
    rng = np.random.default_rng(3)
    vals = rng.uniform(0.0, 100.0, n)
    seg = rng.integers(0, 5, n).astype(np.int32)
    valid = np.ones(n, bool)
    outs = []
    for K, M, Spec in ((JK, JM, JK.KernelAggSpec), (TK, TM, TK.KernelAggSpec)):
        def closure(env):
            return env["v"], env["v__valid"]

        closure.node = TK.ExprNode("leaf", torch.float32, (), ("v", "v__valid"))
        specs = [Spec("sum", True), Spec("count_star", False)]
        if K is JK:
            kernel = K.make_partial_agg_kernel(None, [closure, None], specs, 8, ["v", "v__valid"])
            step = M.make_distributed_agg_step(kernel, specs, M.make_mesh(8), 8)
            out = step(*M.shard_batch(M.make_mesh(8), [seg, valid, vals.astype(np.float32),
                                                       valid]))
            outs.append([np.asarray(o) for o in out])
        else:
            kernel = K.make_partial_agg_kernel(None, [closure, None], specs, 8,
                                               ["v", "v__valid"], mode="x32")
            mesh = M.make_mesh(8, "cpu")
            step = M.make_distributed_agg_step(kernel, specs, mesh, 8, "x32")
            state = step(M.shard_batch(mesh, [seg, valid, vals.astype(np.float32), valid]))
            outs.append(K.unpack_host(specs, K.fetch_states(state)))
    want = np.array([vals[seg == g].sum() for g in range(5)])
    for out in outs:
        got = (out[0].astype(np.float64) + out[1])[:5]
        np.testing.assert_allclose(got, want, rtol=REL)
        assert out[2][:5].tolist() == [int((seg == g).sum()) for g in range(5)]
    np.testing.assert_array_equal(outs[0][2], outs[1][2])


def test_int64_overflow_guard_falls_back():
    """int64 values past int32 must not wrap: the bridge raises the x32
    range error and the stage re-runs the partition on the CPU operators
    (``tpu_fallback``), exactly."""
    big = 5_000_000_000
    t = pa.table({"k": pa.array([1, 1, 2, 2], pa.int64()),
                  "v": pa.array([big, big + 1, big + 2, big + 3], pa.int64())})
    sql = "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k"
    want, jgot, got, m = three(sql, {"t": t}, partitions=1,
                               **{"ballista.mesh.enable": "false"})
    assert got.column("s").to_pylist() == [2 * big + 1, 2 * big + 5]
    assert jgot.column("s").to_pylist() == got.column("s").to_pylist()
    assert m.get("tpu_fallback", 0) == 1, m


def test_timestamp_not_lowered_in_x32():
    t = pa.table({
        "ts": pa.array([datetime.datetime(2020, 1, 1), datetime.datetime(2021, 1, 1)],
                       pa.timestamp("us")),
        "v": pa.array([1.0, 2.0]),
    })
    sql = "SELECT SUM(v) AS s FROM t WHERE ts >= TIMESTAMP '2020-06-01 00:00:00'"
    want, jgot, got, _ = three(sql, {"t": t}, partitions=1)
    assert got.column("s").to_pylist() == jgot.column("s").to_pylist() == [2.0]
    comp = TK.TorchExprCompiler(t.schema, "x32")
    from arrow_ballista_tpu_torch.exec import expressions as pe

    with pytest.raises(TK.NotLowerable):
        comp._lower(pe.Col(0, "ts"))


def minmax_adversarial_table(n=6000, n_groups=30, seed=13) -> pa.Table:
    """f64 values whose differences vanish under f32 rounding: only an exact
    64-bit order comparison picks the right extremum."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, n_groups, n)
    base = rng.uniform(1.0, 100.0, n_groups)[k]
    v = base * (1.0 + rng.integers(-4, 5, n) * 1e-13)
    vmask = rng.uniform(size=n) < 0.05
    return pa.table({"k": pa.array(k.astype(np.int64)),
                     "v": pa.array(v, pa.float64(), mask=vmask)})


@pytest.mark.parametrize("algo", ["matmul", "scatter", "sort"])
def test_x32_minmax_f64_bit_exact(algo):
    """min/max over an f64 column bit-exact in x32 (the order-pair route,
    kernel E or K2's unsigned pair folds) on every route."""
    sql = ("select k, min(v) as mn, max(v) as mx, count(v) as c "
           "from t group by k order by k")
    want, jgot, got, m = three(sql, {"t": minmax_adversarial_table()}, algo=algo)
    assert_no_fallback(m)
    for name in ("mn", "mx", "c"):
        assert want.column(name).to_pylist() == got.column(name).to_pylist(), name
        assert jgot.column(name).to_pylist() == got.column(name).to_pylist(), name
