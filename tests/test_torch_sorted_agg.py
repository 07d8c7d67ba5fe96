"""The PyTorch port's sort route of the partial aggregate against the JAX
package's.

Twin of ``tests/test_sorted_agg.py``: the JAX package is forced to its sort
route with ``arrow_ballista_tpu.ops.kernels.set_agg_algorithm("sort")`` and
runs in x64 on the CPU, the port is forced with its own
``set_agg_algorithm("sort")`` and runs on ``device="cpu"`` (the radix sort's
and the segmented scan's plain twins), and both are held to the CPU
operators: floats within rel 1e-9, everything else exact.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec
from benchmarks.tpch.datagen import ALL_TABLES, gen_table
from benchmarks.tpch.queries import QUERIES
from radix_cases import RADIX_EDGE_CASES, radix_edge_keys, radix_edge_rows

REL = 1e-9
_TPCH: dict = {}


@pytest.fixture(autouse=True)
def _force_sort():
    old = JK._PRECISION["mode"]
    JK.set_precision("x64")
    JK.set_agg_algorithm("sort")
    TK.set_agg_algorithm("sort")
    try:
        yield
    finally:
        JK.set_agg_algorithm(None)
        TK.set_agg_algorithm(None)
        JK._PRECISION["mode"] = old


def _tables(sf: float) -> dict:
    if sf not in _TPCH:
        _TPCH[sf] = {name: gen_table(name, sf) for name in ALL_TABLES}
    return _TPCH[sf]


def _settings(tpu: bool) -> dict:
    return {"ballista.tpu.enable": str(tpu).lower(), "ballista.tpu.min_rows": "0"}


def _assert_tables_equal(a: pa.Table, b: pa.Table, what: str):
    assert a.schema.names == b.schema.names, what
    assert a.num_rows == b.num_rows, what
    for name in a.schema.names:
        for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
            if isinstance(x, float) and x is not None and y is not None:
                assert y == pytest.approx(x, rel=REL), (what, name)
            else:
                assert x == y, (what, name)


def _sort_launches(monkeypatch) -> list:
    """Counts the port's sort-route calls."""
    calls = []
    inner = TK.sorted_segment_agg

    def counted(*args):
        calls.append(args[0].shape[0])
        return inner(*args)

    monkeypatch.setattr(TK, "sorted_segment_agg", counted)
    return calls


def _three(sql: str, sf: float, monkeypatch, partitions=2):
    """(cpu, jax sort route, port sort route), sorted on every column."""
    jcpu = jbt.SessionContext(jbt.BallistaConfig(_settings(False)))
    jdev = jbt.SessionContext(jbt.BallistaConfig(_settings(True)))
    port = tbt.SessionContext(tbt.BallistaConfig(_settings(True)), device="cpu")
    for name, t in _tables(sf).items():
        for c in (jcpu, jdev, port):
            c.register_arrow_table(name, t, partitions=partitions)
    calls = _sort_launches(monkeypatch)
    plan = port.sql(sql).physical_plan()
    stages = []
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, TorchStageExec):
            stages.append(node)
        stack.extend(node.children())
    assert stages, "no TorchStageExec in the port's plan"
    got = port.execute(plan)
    assert calls, "the sort route never ran"
    for s in stages:
        m = s.metrics.to_dict()
        for k in ("tpu_fallback", "cpu_fallback", "highcard_fallback"):
            assert k not in m, m
    JK.set_agg_algorithm(None)  # the CPU leg runs no device kernel anyway
    want = jcpu.sql(sql).collect()
    JK.set_agg_algorithm("sort")
    jgot = jdev.sql(sql).collect()
    keys = [(c, "ascending") for c in want.column_names]
    want, jgot, got = (t.sort_by(keys) for t in (want, jgot, got))
    _assert_tables_equal(want, jgot, "jax sort route vs cpu")
    _assert_tables_equal(want, got, "port sort route vs cpu")
    return got


# the cases of tests/test_sorted_agg.py
_SQL = {
    "q1": QUERIES[1],
    "min_max_count_mixed": (
        "select l_returnflag, min(l_discount), max(l_tax), count(*), "
        "count(l_quantity), sum(l_extendedprice) "
        "from lineitem group by l_returnflag"
    ),
    "high_cardinality": (
        "select l_orderkey, sum(l_extendedprice), count(*), "
        "min(l_linenumber) from lineitem group by l_orderkey"
    ),
}


@pytest.mark.parametrize("name", sorted(_SQL))
def test_sorted_route_matches_jax_and_cpu(name, monkeypatch):
    _three(_SQL[name], 0.01, monkeypatch)


def test_q3_sf01_sorted_route(monkeypatch):
    """q3 at SF0.1: the aggregate above the CPU join on the sort route."""
    got = _three(QUERIES[3], 0.1, monkeypatch)
    assert got.num_rows == 10


def _segment_inputs(n, cap, seed):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, cap - 50, n).astype(np.int32)  # some groups empty
    base = rng.random(n) < 0.9
    vals = rng.uniform(-1e3, 1e3, n)
    vals[rng.random(n) < 0.001] = np.nan
    z = (seg % 7 == 3) & (rng.random(n) < 0.5)  # signed zeros
    vals[z] = np.where(rng.random(int(z.sum())) < 0.5, -0.0, 0.0)
    valid = rng.random(n) < 0.8
    iv = rng.integers(-(2**62), 2**62, n)
    return seg, base, vals, valid, iv


def test_sorted_segment_agg_matches_jax():
    """``_sorted_segment_agg`` (x64 kinds: f64 sum, counts, f64 and i64
    min/max) against the port's sort route into a fresh state: empty and
    all-masked groups, NaN, ±0.0, int64 extrema."""
    n, cap = 200_001, 512
    seg, base, vals, valid, iv = _segment_inputs(n, cap, 7)
    m = base & valid
    inf = float("inf")
    imax, imin = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    kinds = ["f64", "i32", ("min", inf), ("max", -inf), ("min", imax), ("max", imin)]
    cols = [np.where(m, vals, 0.0), m.astype(np.int64), np.where(m, vals, inf),
            np.where(m, vals, -inf), np.where(m, iv, imax), np.where(m, iv, imin)]
    key = np.where(base, seg, cap).astype(np.int32)
    totals, presence = JK._sorted_segment_agg(
        jnp.asarray(key), cap, kinds, [jnp.asarray(c) for c in cols])

    specs = [TK.KernelAggSpec("sum", True), TK.KernelAggSpec("min", True),
             TK.KernelAggSpec("max", True),
             TK.KernelAggSpec("min", True, int_minmax=True),
             TK.KernelAggSpec("max", True, int_minmax=True)]
    ops = [TK.OP_ADD_F64, TK.OP_COUNT, TK.OP_MIN_F64, TK.OP_COUNT, TK.OP_MAX_F64,
           TK.OP_COUNT, TK.OP_MIN_I64, TK.OP_COUNT, TK.OP_MAX_I64, TK.OP_COUNT,
           TK.OP_COUNT]
    fcols = [0, 0, 0, 0, 0, 0, 1, 1, 1, 1, -1]
    t = torch.from_numpy
    state = TK.init_states(specs, cap, torch.device("cpu"))
    TK.sorted_segment_agg(t(seg), t(base), None, None, [t(vals), t(iv)],
                          [t(valid), t(valid)], ops, fcols, state)
    got = TK.unpack_host(specs, TK.fetch_states(state))
    want = {0: totals[0], 1: totals[1], 2: totals[2], 4: totals[3],
            6: totals[4], 8: totals[5], 10: presence}
    for f, w in want.items():
        w = np.asarray(w)
        if f == 0:
            np.testing.assert_allclose(got[f], w, rtol=REL, atol=1e-9)
        elif w.dtype.kind == "f":
            # NaN payloads bit for bit; a zero compares by value, because
            # JAX's associative_scan interleaves partial results by adding
            # zero padding (-0.0 comes back +0.0 there)
            g = got[f]
            zero = (g == 0) & (w == 0)
            assert np.array_equal(g[~zero].view(np.int64), w[~zero].view(np.int64)), f
        else:
            np.testing.assert_array_equal(got[f], w, err_msg=str(f))
    for f in (3, 5, 7, 9):  # the per-aggregate counts
        np.testing.assert_array_equal(got[f], np.asarray(totals[1]))


def test_sorted_route_equals_scatter_route_bit_for_bit():
    """Both routes merge into the same [n_fields, capacity] state over
    several batches: counts and extrema bit-equal, f64 sums within rel
    1e-9."""
    cap = 1024
    specs = [TK.KernelAggSpec("count_star", False), TK.KernelAggSpec("sum", True),
             TK.KernelAggSpec("min", True), TK.KernelAggSpec("max", True, int_minmax=True)]
    ops = [TK.OP_COUNT, TK.OP_ADD_F64, TK.OP_COUNT, TK.OP_MIN_F64, TK.OP_COUNT,
           TK.OP_MAX_I64, TK.OP_COUNT, TK.OP_COUNT]
    fcols = [-1, 0, 0, 0, 0, 1, 1, -1]
    t = torch.from_numpy
    states = [TK.init_states(specs, cap, torch.device("cpu")) for _ in range(2)]
    for seed in range(3):
        seg, base, vals, valid, iv = _segment_inputs(50_000, cap, seed)
        pred = t(np.random.default_rng(seed).random(50_000) < 0.7)
        for fn, s in zip((TK.segment_agg, TK.sorted_segment_agg), states):
            fn(t(seg), t(base), pred, None, [t(vals), t(iv)], [t(valid), None],
               ops, fcols, s)
    a, b = states[0].numpy(), states[1].numpy()
    np.testing.assert_allclose(a[1].view(np.float64), b[1].view(np.float64),
                               rtol=REL, atol=1e-9)
    for f in range(len(ops)):
        if f != 1:
            np.testing.assert_array_equal(a[f], b[f], err_msg=str(f))


def test_sorted_route_with_capacity_growth(monkeypatch):
    """Streaming batches grow the capacity; every batch runs the sort
    route and the result equals the CPU operators'."""
    rng = np.random.default_rng(3)
    n = 6000
    tbl = pa.table({
        "k": pa.array(rng.permutation(n) % 3000, pa.int64()),
        "x": pa.array(rng.normal(0, 1, n), pa.float64()),
    })
    batches = tbl.to_batches(max_chunksize=500)
    sql = "select k, sum(x) as s, count(*) as c from t group by k"
    out = []
    calls = _sort_launches(monkeypatch)
    for tpu in (False, True):
        cfg = dict(_settings(tpu), **{"ballista.tpu.segment_capacity": "64"})
        ctx = tbt.SessionContext(tbt.BallistaConfig(cfg), device="cpu")
        ctx.register_record_batches("t", [batches])
        plan = ctx.sql(sql).physical_plan()
        out.append(ctx.execute(plan).sort_by([("k", "ascending")]))
        if tpu:
            growths, stack = 0, [plan]
            while stack:
                node = stack.pop()
                if isinstance(node, TorchStageExec):
                    growths += node.metrics.to_dict().get("capacity_growths", 0)
                stack.extend(node.children())
            assert growths >= 1
    assert len(calls) == len(batches)
    _assert_tables_equal(out[0], out[1], "growth")


def test_segment_algo_routes_by_device_and_capacity():
    TK.set_agg_algorithm(None)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert TK.segment_algo(1 << 20, 1 << 23, cpu) == "scatter"
    assert TK.segment_algo(8192, 1 << 23, cuda) == "scatter"
    assert TK.segment_algo(8193, 1024, cuda) == "sort"
    assert TK.segment_algo(4096, (1 << 36) // 4096 + 1, cuda) == "sort"
    assert TK.segment_algo(4096, None, cuda) == "scatter"
    TK.set_agg_algorithm("sort")
    assert TK.segment_algo(1, 10, cpu) == "sort"
    TK.set_agg_algorithm("scatter")
    assert TK.segment_algo(1 << 20, 1 << 23, cuda) == "scatter"
    assert TK.algo_cache_token()[0] == "scatter"
    # "matmul" is x32's route: forced under x64 it runs scatter, as in the
    # reference; an unknown route is refused
    TK.set_agg_algorithm("matmul")
    assert TK.segment_algo(64, 10, cuda) == "scatter"
    assert TK.segment_algo(64, 10, cuda, "x32") == "matmul"
    with pytest.raises(ValueError):
        TK.set_agg_algorithm("onehot")


def _mixed_keys(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 3, n).astype(np.int32),
            rng.integers(-(2**62), 2**62, n) // (2**58),
            rng.integers(-5, 5, n).astype(np.int32)]


# the card tests' shapes
_EDGE_ROWS = radix_edge_rows(TK.RADIX_TILE, TK.RADIX_SMALL_ROWS)


@pytest.mark.parametrize("case,n", [("mixed", 5000)] + [
    (case, n) for case in ("mixed", *RADIX_EDGE_CASES) for n in _EDGE_ROWS])
def test_radix_argsort_twin_is_lax_sort_order(case, n):
    """The radix sort's twin gives ``lax.sort(keys + (iota,))``'s order."""
    import jax

    keys = _mixed_keys(n, 1) if case == "mixed" else radix_edge_keys(case, n, seed=n)
    iota = jnp.arange(n, dtype=jnp.int32)
    want = jax.lax.sort(tuple(jnp.asarray(k) for k in keys) + (iota,),
                        num_keys=len(keys) + 1)[-1]
    got = TK.radix_argsort([torch.from_numpy(k) for k in keys])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,value", [
    ("kRadixTile", TK.RADIX_TILE), ("kRadixSmallMax", TK.RADIX_SMALL_ROWS)])
def test_radix_sizes_match_the_header(name, value):
    """The tile and the one-CTA sort's bound in ``ops/kernels.py`` are the
    CUDA header's, and the one-CTA sort's rows (a 4-byte word and a 2-byte
    row index each) fit the block's shared memory beside 32 KB of per-warp
    counts."""
    src = open(os.path.join(os.path.dirname(TK.__file__), "cuda", "radix_sort.h")).read()
    consts = {k: v for k, v in re.findall(r"constexpr int (\w+) = (\w+(?: \* \w+)?);", src)}

    def value_of(k):
        a, _, b = consts[k].partition(" * ")
        return (int(a) if a.isdigit() else value_of(a)) * (value_of(b) if b else 1)

    assert value_of(name) == value
    assert 6 * TK.RADIX_SMALL_ROWS <= 232_448 - 32_768


# ------------------------------------------------------------------ x32
# The x32 cases of tests/test_sorted_agg.py: test_q1_sorted_matches_oracle
# and test_min_max_count_mixed_sorted with mode="x32" (both packages forced
# to x32 and the sort route, held to the CPU operators at rel 1e-6), and
# test_sorted_df32_precision through K2's df32 fold.
X32_REL = 1e-6


@pytest.fixture
def _x32_both():
    old = JK._PRECISION["mode"]
    JK.set_precision("x32")
    TK.set_precision("x32")
    try:
        yield
    finally:
        TK.set_precision(None)
        JK._PRECISION["mode"] = old


@pytest.mark.parametrize("name", ["q1", "min_max_count_mixed"])
def test_sorted_route_x32_matches_jax_and_cpu(name, monkeypatch, _x32_both):
    calls = []
    inner = TK.sorted_segment_agg_x32_reference

    def counted(*args):
        calls.append(args[0].shape[0])
        return inner(*args)

    monkeypatch.setattr(TK, "sorted_segment_agg_x32_reference", counted)
    jcpu = jbt.SessionContext(jbt.BallistaConfig(_settings(False)))
    jdev = jbt.SessionContext(jbt.BallistaConfig(_settings(True)))
    port = tbt.SessionContext(tbt.BallistaConfig(_settings(True)), device="cpu")
    for tname, t in _tables(0.01).items():
        for c in (jcpu, jdev, port):
            c.register_arrow_table(tname, t, partitions=2)
    sql = _SQL[name]
    got = port.sql(sql).collect()
    assert calls, "the x32 sort route never ran"
    JK.set_agg_algorithm(None)
    want = jcpu.sql(sql).collect()
    JK.set_agg_algorithm("sort")
    jgot = jdev.sql(sql).collect()
    keys = [(c, "ascending") for c in want.column_names]
    want, jgot, got = (t.sort_by(keys) for t in (want, jgot, got))
    for other, what in ((jgot, "jax x32 sort route"), (got, "port x32 sort route")):
        assert other.num_rows == want.num_rows, what
        for col in want.column_names:
            for x, y in zip(want.column(col).to_pylist(), other.column(col).to_pylist()):
                if isinstance(x, float):
                    assert y == pytest.approx(x, rel=X32_REL), (what, col)
                else:
                    assert x == y, (what, col)


def test_sorted_df32_precision_x32():
    """Compensated sums through K2's df32 fold survive the cancellation mix
    the reference's does (large + tiny f32 values): within rel 1e-9 of the
    f64 sums and of ``_sorted_segment_agg``'s df32 totals."""
    rng = np.random.default_rng(11)
    n, cap = 1 << 17, 64
    seg = rng.integers(0, cap, n).astype(np.int32)
    vals = np.where(rng.random(n) < 0.5, rng.uniform(1e6, 1e7, n),
                    rng.uniform(1e-3, 1e-2, n)).astype(np.float32)
    h = jnp.asarray(vals)
    totals, _ = JK._sorted_segment_agg(jnp.asarray(seg), cap, ["df32"], [(h, jnp.zeros_like(h))])
    ref = np.zeros(cap)
    np.add.at(ref, seg, vals.astype(np.float64))
    key = torch.from_numpy(seg)
    perm = TK.radix_argsort([key])
    (scanned,) = TK.seg_scan([TK.ScanColumn(TK.SS_VALUES, TK.OP_DF32,
                                            values=torch.from_numpy(vals))], n, perm=perm, key=key)
    s2 = key[perm.long()]
    last = torch.searchsorted(s2, torch.arange(1, cap + 1, dtype=s2.dtype)) - 1
    hi, lo = TK._df32_split(scanned[last])
    got = hi.double().numpy() + lo.double().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-9)
    want = np.asarray(totals[0][0], np.float64) + np.asarray(totals[0][1])
    np.testing.assert_allclose(got, want, rtol=1e-9)
