"""The PyTorch port's device window path against the JAX package.

Each query runs three ways — the port's ``SessionContext(device="cpu")``
with its ``TorchWindowExec`` (the kernels' plain PyTorch twins), the JAX
package's ``TpuWindowExec`` in x64 (the JAX package's own window tests run
it so on the CPU), and the JAX package's CPU ``WindowExec`` — and the three
tables must agree: floats within rel 1e-9, everything else exact.  Twin of
the x64 cases of ``tests/test_device_window.py`` and the sweep of
``tests/test_window_property.py``, plus the smoke's lineitem query, plus
the window kernel's pieces held against the JAX functions they replace.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu.catalog import MemoryTable
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu.ops import window_kernel as JW
from arrow_ballista_tpu.ops.window_compiler import TpuWindowExec
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops import window_kernel as TW
from arrow_ballista_tpu_torch.ops.window_compiler import (
    TorchWindowExec,
    _string_order_ranks,
)
from benchmarks.tpch.datagen import gen_table

REL = 1e-9


@pytest.fixture(autouse=True)
def _jax_x64():
    old = JK._PRECISION["mode"]
    JK.set_precision("x64")
    try:
        yield
    finally:
        JK._PRECISION["mode"] = old


def _data(n=6000, seed=5):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 40, n)
    s = np.char.add("grp", rng.integers(0, 7, n).astype("U2"))
    v = rng.integers(0, 300, n).astype(np.float64)  # ties guaranteed
    vmask = rng.uniform(size=n) < 0.06
    w = rng.uniform(0, 100, n)
    iv = rng.integers(0, 1000, n)
    return pa.table(
        {
            "g": pa.array(g),
            "s": pa.array(s.tolist()),
            "v": pa.array(v, pa.float64(), mask=vmask),
            "w": pa.array(w),
            "iv": pa.array(iv, pa.int64()),
        }
    )


def _settings(tpu: bool) -> dict:
    return {
        "ballista.tpu.enable": str(tpu).lower(),
        "ballista.tpu.min_rows": "0",
        "ballista.shuffle.partitions": "1",
    }


def _nodes(plan, cls) -> list:
    out, stack = [], [plan]
    while stack:
        nd = stack.pop()
        if isinstance(nd, cls):
            out.append(nd)
        stack.extend(nd.children())
    return out


def _metrics(plan, cls) -> dict:
    agg: dict = {}
    for nd in _nodes(plan, cls):
        for k, v in nd.metrics.to_dict().items():
            agg[k] = agg.get(k, 0) + v
    return agg


def _assert_tables_equal(a: pa.Table, b: pa.Table, what: str):
    assert a.schema.names == b.schema.names, what
    assert a.num_rows == b.num_rows, what
    for name in a.schema.names:
        av, bv = a.column(name).to_pylist(), b.column(name).to_pylist()
        for i, (x, y) in enumerate(zip(av, bv)):
            if isinstance(x, float) and x is not None and y is not None:
                assert y == pytest.approx(x, rel=REL, nan_ok=True), (what, name, i)
            else:
                assert x == y, (what, name, i, x, y)


def _three(sql: str, t: pa.Table, sort_cols, partitions=2):
    """(cpu, jax device, port) results, sorted; asserts they agree, that
    the port planned a TorchWindowExec and that it ran on the device."""
    cpu = jbt.SessionContext(jbt.BallistaConfig(_settings(False)))
    jax_dev = jbt.SessionContext(jbt.BallistaConfig(_settings(True)))
    for c in (cpu, jax_dev):
        c.register_table("t", MemoryTable.from_table(t, partitions))
    port = tbt.SessionContext(tbt.BallistaConfig(_settings(True)), device="cpu")
    port.register_arrow_table("t", t, partitions=partitions)
    want = cpu.sql(sql).collect()
    jplan = jax_dev.sql(sql).physical_plan()
    jgot = jax_dev.execute(jplan)
    assert _metrics(jplan, TpuWindowExec).get("tpu_window", 0) >= 1
    plan = port.sql(sql).physical_plan()
    assert _nodes(plan, TorchWindowExec), "no TorchWindowExec in the port's plan"
    got = port.execute(plan)
    m = _metrics(plan, TorchWindowExec)
    assert m.get("tpu_window", 0) >= 1, m
    assert m.get("tpu_fallback", 0) == 0, m
    keys = [(c, "ascending") for c in sort_cols]
    want, jgot, got = (x.sort_by(keys) for x in (want, jgot, got))
    _assert_tables_equal(want, jgot, "jax device vs cpu")
    _assert_tables_equal(want, got, "port vs cpu")
    return want, got


# the x64 cases of tests/test_device_window.py: (sql, sort columns)
_CASES = {
    "ranking": (
        "select g, iv, w, "
        "row_number() over (partition by g order by iv, w) rn, "
        "rank() over (partition by g order by iv) rk, "
        "dense_rank() over (partition by g order by iv) dr, "
        "ntile(7) over (partition by g order by iv, w) nt from t",
        ["g", "iv", "w"],
    ),
    "running_aggregates": (
        "select g, iv, w, "
        "sum(w) over (partition by g order by iv) rs, "
        "count(v) over (partition by g order by iv) rc, "
        "count(*) over (partition by g order by iv) rcs, "
        "avg(w) over (partition by g order by iv) ra, "
        "min(iv) over (partition by g order by iv) rmn, "
        "max(iv) over (partition by g order by iv) rmx from t",
        ["g", "iv", "w"],
    ),
    "whole_partition_string_keys": (
        "select s, v, sum(v) over (partition by s) tot, "
        "count(*) over (partition by s) c from t",
        ["s", "v"],
    ),
    "value_functions": (
        "select g, iv, w, "
        "lag(w) over (partition by g order by iv, w) lg, "
        "lead(w, 2) over (partition by g order by iv, w) ld, "
        "first_value(w) over (partition by g order by iv, w) fv, "
        "last_value(w) over (partition by g order by iv, w) lv from t",
        ["g", "iv", "w"],
    ),
    "desc_and_nulls_ordering": (
        "select g, v, rank() over (partition by g order by v desc) rk, "
        "row_number() over (partition by g order by v desc, w) rn from t",
        ["g", "rn"],
    ),
    "running_sum_null_args": (
        "select g, iv, sum(v) over (partition by g order by iv) rs from t",
        ["g", "iv"],
    ),
    "rows_framed_aggregates": (
        "select g, iv, w, "
        "sum(w) over (partition by g order by iv, w "
        "rows between 2 preceding and current row) ms, "
        "count(v) over (partition by g order by iv, w "
        "rows between 1 preceding and 1 following) mc, "
        "avg(w) over (partition by g order by iv, w "
        "rows between unbounded preceding and 1 following) ma, "
        "count(*) over (partition by g order by iv, w "
        "rows between 3 preceding and current row) mcs, "
        "sum(w) over (partition by g order by iv, w "
        "rows between 3 following and 5 following) mf, "
        "sum(w) over (partition by g order by iv, w "
        "rows between 5 preceding and 3 preceding) mp from t",
        ["g", "iv", "w"],
    ),
    "rows_framed_minmax": (
        "select g, iv, w, "
        "min(w) over (partition by g order by iv, w "
        "rows between unbounded preceding and current row) rm, "
        "max(w) over (partition by g order by iv, w "
        "rows between 2 preceding and current row) fm, "
        "min(iv) over (partition by g order by iv, w "
        "rows between 1 preceding and 3 following) im, "
        "max(v) over (partition by g order by iv, w "
        "rows between 3 following and 6 following) nm, "
        "min(w) over (partition by g order by iv, w "
        "rows between 6 preceding and 2 preceding) pm from t",
        ["g", "iv", "w"],
    ),
    "string_order_by": (
        "select g, s, rank() over (partition by g order by s) rk, "
        "dense_rank() over (partition by g order by s) dr, "
        "sum(w) over (partition by g order by s) rs, "
        "first_value(w) over (partition by g order by s) fv from t",
        ["g", "s", "rk"],
    ),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_window_query_matches_jax_and_cpu(name):
    sql, sort_cols = _CASES[name]
    _three(sql, _data(), sort_cols)


def test_rows_framed_sum_mixed_magnitude_partitions():
    """Segment-reset prefixes: a tiny-valued partition next to a huge one
    keeps its own precision."""
    rng = np.random.default_rng(41)
    n = 20000
    g = (np.arange(n) >= n // 2).astype(np.int64)
    w = np.where(g == 0, rng.uniform(1e6, 2e6, n), rng.uniform(1e-3, 2e-3, n))
    t = pa.table({"g": pa.array(g), "iv": pa.array(np.arange(n, dtype=np.int64)),
                  "w": pa.array(w)})
    sql = ("select g, iv, sum(w) over (partition by g order by iv "
           "rows between 2 preceding and current row) ms from t")
    _three(sql, t, ["g", "iv"])


def test_string_order_desc_nulls_and_ties():
    rng = np.random.default_rng(9)
    n = 3000
    words = np.array(["apple", "pear", "Zebra", "zebra", "fig", ""])
    sv = words[rng.integers(0, len(words), n)]
    t = pa.table({
        "g": pa.array(rng.integers(0, 10, n)),
        "s": pa.array(sv.tolist(), pa.string(), mask=rng.uniform(size=n) < 0.08),
        "w": pa.array(rng.uniform(0, 50, n)),
    })
    sql = ("select g, s, rank() over (partition by g order by s desc) rk, "
           "count(*) over (partition by g order by s desc) rc from t")
    _three(sql, t, ["g", "rk", "rc"])


def test_int_window_sums_above_2p24():
    """Integer window sums of values past 2^24 (x64: f64 sums, exact
    below 2^53)."""
    rng = np.random.default_rng(47)
    n = 4096
    big = rng.integers(1 << 25, 1 << 27, n).astype(np.int64) * 2 + 1
    t = pa.table({"g": pa.array(rng.integers(0, 8, n)),
                  "iv": pa.array(np.arange(n, dtype=np.int64)),
                  "b": pa.array(big, pa.int64())})
    sql = ("select g, iv, sum(b) over (partition by g order by iv) rs, "
           "avg(b) over (partition by g order by iv) ra, "
           "sum(b) over (partition by g order by iv "
           "rows between 2 preceding and current row) fs from t")
    want, got = _three(sql, t, ["g", "iv"])
    assert got.column("rs").to_pylist() == want.column("rs").to_pylist()
    assert got.column("fs").to_pylist() == want.column("fs").to_pylist()


def test_running_float_sum_restarts_per_partition():
    """A running (default RANGE) float sum rounds at its own partition's
    scale in the port, on the device path and in the CPU operator alike.
    The JAX package's CPU operator takes a global cumsum minus the
    partition's offset, so a small-valued partition after a huge one
    inherits the huge one's rounding."""
    rng = np.random.default_rng(29)
    n = 4000
    g = (np.arange(n) >= n // 2).astype(np.int64)
    w = np.where(g == 0, rng.uniform(1e12, 2e12, n), rng.uniform(0.5, 1.5, n))
    t = pa.table({"g": pa.array(g), "iv": pa.array(np.arange(n, dtype=np.int64)),
                  "w": pa.array(w)})
    sql = "select g, iv, sum(w) over (partition by g order by iv) rs from t"
    oracle = np.concatenate([np.cumsum(w[g == 0]), np.cumsum(w[g == 1])])

    def rs(ctx):
        out = ctx.sql(sql).collect().sort_by([("iv", "ascending")])
        return np.asarray(out.column("rs"))

    for tpu in (False, True):
        port = tbt.SessionContext(tbt.BallistaConfig(_settings(tpu)), device="cpu")
        port.register_arrow_table("t", t, partitions=1)
        np.testing.assert_allclose(rs(port), oracle, rtol=REL, atol=0)
    jcpu = jbt.SessionContext(jbt.BallistaConfig(_settings(False)))
    jcpu.register_table("t", MemoryTable.from_table(t, 1))
    assert np.max(np.abs(rs(jcpu) - oracle) / oracle) > 1e-6


def test_dictionary_order_key_with_null_slot():
    d = pa.DictionaryArray.from_arrays(
        pa.array([0, 1, 2, 0, None, 1], pa.int32()), pa.array(["b", None, "a"])
    )
    ranks, validity = _string_order_ranks(d)
    assert validity.tolist() == [True, False, True, True, False, False]
    assert ranks[2] < ranks[0] and ranks[0] == ranks[3]


# the sweep of tests/test_window_property.py
_SWEEP_FNS = [
    "row_number() over (partition by g order by o)",
    "rank() over (partition by g order by o)",
    "dense_rank() over (partition by g order by o)",
    "sum(v) over (partition by g order by o)",
    "avg(v) over (partition by g order by o)",
    "count(v) over (partition by g order by o)",
    "min(v) over (partition by g order by o)",
    "max(v) over (partition by g order by o)",
    "lag(v) over (partition by g order by o)",
    "lead(v) over (partition by g order by o)",
    "first_value(v) over (partition by g order by o)",
    "sum(v) over (partition by g order by o rows between 3 preceding and current row)",
    "max(v) over (partition by g order by o rows between 2 preceding and 1 following)",
]


@pytest.mark.parametrize("seed", range(6))
def test_window_sweep(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(500, 4000))
    n_parts = int(rng.choice([1, 3, 40, n // 3 + 1]))
    o_card = int(rng.choice([max(4, n // 10), n * 10]))
    vals = rng.uniform(-100, 100, n)
    if rng.uniform() < 0.5:
        vals = np.where(rng.uniform(size=n) < 0.1, np.nan, vals)
    t = pa.table({
        "g": pa.array(rng.integers(0, n_parts, n), pa.int64()),
        "o": pa.array(rng.integers(0, o_card, n), pa.int64()),
        "v": pa.array([None if np.isnan(x) else float(x) for x in vals], pa.float64()),
    })
    picks = list(rng.choice(len(_SWEEP_FNS), size=3, replace=False))
    sel = ", ".join(f"{_SWEEP_FNS[i]} w{j}" for j, i in enumerate(picks))
    # rows within exact ties may differ in row_number/lag/lead order, so
    # every output column takes part in the sort
    cols = ["g", "o", "v"] + [f"w{j}" for j in range(3)]
    _three(f"select g, o, v, {sel} from t", t, cols, partitions=1)


_LINEITEM_WINDOW = """select l_orderkey, l_linenumber,
 row_number() over (partition by l_suppkey order by l_shipdate, l_orderkey, l_linenumber) rn,
 rank() over (partition by l_suppkey order by l_shipdate) rk,
 sum(l_extendedprice) over (partition by l_suppkey order by l_shipdate) rs,
 avg(l_quantity) over (partition by l_suppkey order by l_shipdate, l_orderkey, l_linenumber rows between 6 preceding and current row) ma,
 max(l_discount) over (partition by l_suppkey order by l_shipdate, l_orderkey, l_linenumber rows between 6 preceding and current row) mx,
 lag(l_extendedprice, 1) over (partition by l_suppkey order by l_shipdate, l_orderkey, l_linenumber) lg
from t"""


def test_lineitem_window_query_sf001():
    """The chip smoke's window query at SF0.01."""
    t = gen_table("lineitem", 0.01)
    _three(_LINEITEM_WINDOW, t, ["l_orderkey", "l_linenumber"], partitions=1)


def test_small_partition_runs_cpu_operator():
    """Under ballista.tpu.min_rows the CPU operator runs, as in the
    reference, and no fallback is counted."""
    t = _data(n=500)
    cfg = dict(_settings(True), **{"ballista.tpu.min_rows": "100000"})
    port = tbt.SessionContext(tbt.BallistaConfig(cfg), device="cpu")
    port.register_arrow_table("t", t, partitions=1)
    plan = port.sql(_CASES["ranking"][0]).physical_plan()
    got = port.execute(plan)
    m = _metrics(plan, TorchWindowExec)
    assert got.num_rows == 500 and "tpu_window" not in m and "tpu_fallback" not in m


def test_unencodable_partition_key_counts_fallback():
    """A PARTITION BY key the group-key encoder cannot code goes to the
    CPU operator and counts tpu_fallback; the answer is the CPU's."""
    n = 300
    g = np.where(np.arange(n) % 2 == 0, 2**62, -(2**62)).astype(np.int64)
    t = pa.table({"g": pa.array(g), "iv": pa.array(np.arange(n, dtype=np.int64))})
    sql = "select g, iv, row_number() over (partition by g order by iv) rn from t"
    out = []
    for tpu in (False, True):
        port = tbt.SessionContext(tbt.BallistaConfig(_settings(tpu)), device="cpu")
        port.register_arrow_table("t", t, partitions=1)
        plan = port.sql(sql).physical_plan()
        out.append(port.execute(plan).sort_by([("g", "ascending"), ("iv", "ascending")]))
    m = _metrics(plan, TorchWindowExec)
    assert m.get("tpu_fallback") == 1 and "tpu_window" not in m
    _assert_tables_equal(out[0], out[1], "fallback vs cpu")


def test_kernel_error_raises_without_fallback(monkeypatch):
    """A failure inside the device path raises: nothing re-runs on the CPU."""
    t = _data(n=500)
    port = tbt.SessionContext(tbt.BallistaConfig(_settings(True)), device="cpu")
    port.register_arrow_table("t", t, partitions=1)

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(TK, "radix_argsort", boom)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        port.sql(_CASES["ranking"][0]).collect()


# ------------------------------------------- kernel pieces vs JAX functions
def _assert_f64_words(got: np.ndarray, want: np.ndarray, what: str):
    """Bit-equal f64 words, NaN payloads included, except that a zero
    compares by value: JAX's associative_scan interleaves its partial
    results by adding zero padding, so a -0.0 scan result comes back +0.0
    there, while the port keeps jnp.minimum's -0.0 (as the CPU operator
    does)."""
    g, w = got.view(np.float64), want.view(np.float64)
    zero = (g == 0) & (w == 0)
    assert np.array_equal(got[~zero], want[~zero]), what


def _seg_inputs(n, seed):
    """Sorted-order inputs with NaN, ±0.0, nulls and an all-null segment."""
    rng = np.random.default_rng(seed)
    flag = rng.random(n) < 0.05
    flag[0] = True
    v = rng.uniform(-50, 50, n)
    v[rng.random(n) < 0.03] = np.nan
    z = rng.random(n) < 0.1
    v[z] = np.where(rng.random(int(z.sum())) < 0.5, -0.0, 0.0)
    valid = rng.random(n) >= 0.1
    starts = np.nonzero(flag)[0]
    if len(starts) > 2:  # one segment of nulls only
        valid[starts[1]:starts[2]] = False
    iv = rng.integers(-(2**60), 2**60, n)
    return flag, v, valid, iv


@pytest.mark.parametrize("seed", range(3))
def test_seg_scan_matches_jax(seed):
    """``_seg_scan`` (sum, min, max over f64 and i64) and ``_seg_first``/
    ``_seg_last`` against the port's scan twin on the same inputs."""
    n = 3001
    flag, v, valid, iv = _seg_inputs(n, seed)
    perm = np.random.default_rng(seed).permutation(n).astype(np.int32)
    inv = np.argsort(perm)  # the port gathers through perm: feed it unsorted
    t = torch.from_numpy
    kinds = [("sum", TK.OP_ADD_F64, np.where(valid, v, 0.0), v),
             ("min", TK.OP_MIN_F64, np.where(valid, v, np.inf), v),
             ("max", TK.OP_MAX_F64, np.where(valid, v, -np.inf), v),
             ("min", TK.OP_MIN_I64, np.where(valid, iv, np.iinfo(np.int64).max), iv),
             ("max", TK.OP_MAX_I64, np.where(valid, iv, np.iinfo(np.int64).min), iv)]
    jax_out = JW._seg_scan(jnp.asarray(flag), [jnp.asarray(e) for _, _, e, _ in kinds],
                           [k for k, _, _, _ in kinds])
    cols = [TK.ScanColumn(TK.SS_VALUES, op, t(raw[inv].copy()), t(valid[inv].copy()))
            for _, op, _, raw in kinds]
    got = TK.seg_scan(cols, n, perm=t(perm), flag=t(flag.astype(np.uint8)))
    for (name, op, _, _), j, g in zip(kinds, jax_out, got):
        j = np.asarray(j)
        g = g.numpy()
        if op == TK.OP_ADD_F64:
            g = g.view(np.float64)
            np.testing.assert_allclose(g, j, rtol=REL, atol=1e-12)
        elif j.dtype.kind == "f":
            _assert_f64_words(g, j.view(np.int64), name)
        else:
            np.testing.assert_array_equal(g, j)
    idx = jnp.arange(n, dtype=jnp.int32)
    first = TK.seg_scan([TK.ScanColumn(TK.SS_IOTA, TK.OP_MIN_I64)], n,
                        flag=t(flag.astype(np.uint8)))[0]
    last = TK.seg_scan([TK.ScanColumn(TK.SS_IOTA, TK.OP_MAX_I64)], n,
                       flag=t(flag.astype(np.uint8)), reverse=True)[0]
    np.testing.assert_array_equal(first.numpy(), np.asarray(JW._seg_first(jnp.asarray(flag), idx)))
    np.testing.assert_array_equal(last.numpy(), np.asarray(JW._seg_last(jnp.asarray(flag), n)))


@pytest.mark.parametrize("frame", [(-6, 0), (None, 0), (1, 3), (-5, -2), (None, None)])
@pytest.mark.parametrize("fn", ["min", "max"])
def test_range_extremum_matches_jax(frame, fn):
    n = 2000
    flag, v, valid, iv = _seg_inputs(n, 7)
    t = torch.from_numpy
    sf = np.asarray(JW._seg_first(jnp.asarray(flag), jnp.arange(n, dtype=jnp.int32)))
    sl = np.asarray(JW._seg_last(jnp.asarray(flag), n))
    a, b = frame
    idx = np.arange(n)
    lo = sf if a is None else np.maximum(sf, idx + a)
    hi = sl if b is None else np.minimum(sl, idx + b)
    max_len = b - a + 1 if a is not None and b is not None else n
    perm = t(np.arange(n, dtype=np.int32))
    for vals, op in ((v, TK.OP_MIN_F64 if fn == "min" else TK.OP_MAX_F64),
                     (iv, TK.OP_MIN_I64 if fn == "min" else TK.OP_MAX_I64)):
        if vals.dtype.kind == "f":
            ident = np.inf if fn == "min" else -np.inf
        else:
            ident = np.iinfo(np.int64).max if fn == "min" else np.iinfo(np.int64).min
        want = np.asarray(JW._range_extremum(
            jnp.asarray(np.where(valid, vals, ident)), jnp.asarray(lo), jnp.asarray(hi),
            fn, ident, n, max_len))
        want = np.where(hi < lo, ident, want)
        got = TW.range_extremum(t(vals), t(valid), perm, t(sf.astype(np.int64)),
                                t(sl.astype(np.int64)), a, b, op).numpy()
        assert np.array_equal(got, want.view(np.int64) if want.dtype.kind == "f" else want)


_KERNEL_SPECS = (
    ("row_number",), ("rank",), ("dense_rank",), ("ntile", 7),
    ("agg", "sum", 0), ("agg", "count", None), ("agg", "min", 1),
    ("agg", "max", 0), ("agg", "count", 0), ("agg", "avg", 1),
    ("aggf", "avg", 0, -6, 0), ("aggf", "max", 0, -6, 0),
    ("aggf", "count", None, None, 1), ("aggf", "sum", 1, 2, 5),
    ("aggf", "min", 1, None, None), ("aggf", "count", 0, -1, 1),
    ("val", "lag", 0, 1), ("val", "lead", 1, 2),
    ("val", "first_value", 0, 1), ("val", "last_value", 1, 1),
)


def test_make_window_kernel_matches_jax():
    """The packed output of the port's window kernel equals the JAX
    kernel's (x64 layout) on keys with ties and nulls, arguments with
    NaN, ±0.0, nulls and an all-null partition."""
    rng = np.random.default_rng(13)
    n = 2048
    live = 2000
    pad = (np.arange(n) >= live).astype(np.int32)
    part = rng.integers(0, 30, n).astype(np.int64)
    part[part == 29] = 28
    null_rank = (rng.random(n) < 0.1).astype(np.int32)
    order = rng.integers(0, 50, n).astype(np.int64)
    v = rng.uniform(-10, 10, n)
    v[rng.random(n) < 0.02] = np.nan
    v[rng.random(n) < 0.05] = -0.0
    vm = rng.random(n) >= 0.1
    vm[part == 3] = False  # an all-null partition
    w = rng.integers(-(2**40), 2**40, n)
    wm = np.ones(n, dtype=bool)
    # the reference's specs carry an x32 pair flag on agg/aggf
    jspecs = tuple(s + (False,) if s[0] in ("agg", "aggf") else s
                   for s in _KERNEL_SPECS)
    jfn = JW.make_window_kernel(jspecs, 2, 2, 2, "x64")
    want = np.asarray(jfn((jnp.asarray(pad), jnp.asarray(part)),
                          (jnp.asarray(null_rank), jnp.asarray(order)),
                          ((jnp.asarray(v), jnp.asarray(vm)),
                           (jnp.asarray(w), jnp.asarray(wm)))))
    t = torch.from_numpy
    tfn = TW.make_window_kernel(_KERNEL_SPECS, 2, 2, 2)
    got = tfn([t(pad), t(part)], [t(null_rank), t(order)],
              [(t(v), t(vm)), (t(w), None)]).numpy()
    assert got.shape == want.shape
    sums = {4, 12, 14, 15, 20, 21}  # f64 sum rows: summation order differs
    extrema = {9, 17}  # f64 min/max rows (the RANGE scan, the sparse table)
    for r in range(want.shape[0]):
        g, w = got[r][:live], want[r][:live]
        if r in sums:
            np.testing.assert_allclose(g.view(np.float64), w.view(np.float64),
                                       rtol=REL, atol=1e-9, err_msg=str(r))
        elif r in extrema:
            _assert_f64_words(g, w, str(r))
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(r))
