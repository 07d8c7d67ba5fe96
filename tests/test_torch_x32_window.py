"""The port's windows in x32 against the JAX package's ``TpuWindowExec``.

Under ``set_precision("x32")`` a window's ORDER BY and PARTITION BY keys
sort as order-preserving (hi, lo) int32 pairs, its arguments cross as
f32/int32 (an integer sum or avg as its exact 48-bit (hi, lo) f32 pair,
past 2^48 the window stays on the CPU), the running and ROWS-frame sums
are double-float scans, framed min/max read 4-byte words, and the pack
is x32's int32 layout.  Each case runs the port (``device="cpu"``), the
JAX package's device window in x32 and the CPU ``WindowExec``: floats
within rel 1e-6, everything else exact (integer sums bit for bit).
Cases: the x32 parameters of ``tests/test_device_window.py``.
"""

import numpy as np
import pyarrow as pa
import pytest

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu.ops.window_compiler import TpuWindowExec
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops.window_compiler import TorchWindowExec

REL = 1e-6


@pytest.fixture(autouse=True)
def x32_both():
    old = JK._PRECISION["mode"]
    JK.set_precision("x32")
    TK.set_precision("x32")
    try:
        yield
    finally:
        TK.set_precision(None)
        JK._PRECISION["mode"] = old


def _data(n=6000, seed=5) -> pa.Table:
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 300, n).astype(np.float64)  # ties guaranteed
    return pa.table({
        "g": pa.array(rng.integers(0, 40, n)),
        "s": pa.array(np.char.add("grp", rng.integers(0, 7, n).astype("U2")).tolist()),
        "v": pa.array(v, pa.float64(), mask=rng.uniform(size=n) < 0.06),
        "w": pa.array(rng.uniform(0, 100, n)),
        "iv": pa.array(rng.integers(0, 1000, n), pa.int64()),
    })


def _mixed_magnitudes() -> pa.Table:
    rng = np.random.default_rng(41)
    n = 20000
    g = (np.arange(n) >= n // 2).astype(np.int64)
    w = np.where(g == 0, rng.uniform(1e6, 2e6, n), rng.uniform(1e-3, 2e-3, n))
    return pa.table({"g": pa.array(g), "iv": pa.array(np.arange(n, dtype=np.int64)),
                     "w": pa.array(w)})


def _big_ints() -> pa.Table:
    rng = np.random.default_rng(47)
    n = 4096
    big = rng.integers(1 << 25, 1 << 27, n).astype(np.int64) * 2 + 1
    return pa.table({"g": pa.array(rng.integers(0, 8, n)),
                     "iv": pa.array(np.arange(n, dtype=np.int64)),
                     "b": pa.array(big, pa.int64())})


def _strings_with_nulls() -> pa.Table:
    rng = np.random.default_rng(9)
    n = 3000
    words = np.array(["apple", "pear", "Zebra", "zebra", "fig", ""])
    return pa.table({
        "g": pa.array(rng.integers(0, 10, n)),
        "s": pa.array(words[rng.integers(0, len(words), n)].tolist(), pa.string(),
                      mask=rng.uniform(size=n) < 0.08),
        "w": pa.array(rng.uniform(0, 50, n)),
    })


_FR = "partition by g order by iv, w rows between"
WINDOW_CASES = {
    # name: (table, sql, sort columns, relative tolerance)
    "ranking": (_data, "select g, iv, w, row_number() over (partition by g order by iv, w) rn, "
                "rank() over (partition by g order by iv) rk, "
                "dense_rank() over (partition by g order by iv) dr, "
                "ntile(7) over (partition by g order by iv, w) nt from t", ["g", "iv", "w"], REL),
    "running_aggregates": (
        _data, "select g, iv, w, sum(w) over (partition by g order by iv) rs, "
        "count(v) over (partition by g order by iv) rc, "
        "count(*) over (partition by g order by iv) rcs, "
        "avg(w) over (partition by g order by iv) ra, "
        "min(iv) over (partition by g order by iv) rmn, "
        "max(iv) over (partition by g order by iv) rmx from t", ["g", "iv", "w"], REL),
    "value_functions": (
        _data, "select g, iv, w, lag(w) over (partition by g order by iv, w) lg, "
        "lead(w, 2) over (partition by g order by iv, w) ld, "
        "first_value(w) over (partition by g order by iv, w) fv, "
        "last_value(w) over (partition by g order by iv, w) lv from t", ["g", "iv", "w"], REL),
    "desc_and_nulls_ordering": (
        _data, "select g, v, rank() over (partition by g order by v desc) rk, "
        "row_number() over (partition by g order by v desc, w) rn from t", ["g", "rn"], REL),
    "rows_framed_aggregates": (
        _data, f"select g, iv, w, sum(w) over ({_FR} 2 preceding and current row) ms, "
        f"count(v) over ({_FR} 1 preceding and 1 following) mc, "
        f"avg(w) over ({_FR} unbounded preceding and 1 following) ma, "
        f"count(*) over ({_FR} 3 preceding and current row) mcs, "
        f"sum(w) over ({_FR} 3 following and 5 following) mf, "
        f"sum(w) over ({_FR} 5 preceding and 3 preceding) mp from t", ["g", "iv", "w"], REL),
    "rows_framed_sum_mixed_magnitude_partitions": (
        _mixed_magnitudes, "select g, iv, sum(w) over (partition by g order by iv "
        "rows between 2 preceding and current row) ms from t", ["g", "iv"], REL),
    "rows_framed_minmax": (
        _data, f"select g, iv, w, min(w) over ({_FR} unbounded preceding and current row) rm, "
        f"max(w) over ({_FR} 2 preceding and current row) fm, "
        f"min(iv) over ({_FR} 1 preceding and 3 following) im, "
        f"max(v) over ({_FR} 3 following and 6 following) nm, "
        f"min(w) over ({_FR} 6 preceding and 2 preceding) pm from t", ["g", "iv", "w"], REL),
    "string_order_by": (
        _data, "select g, s, rank() over (partition by g order by s) rk, "
        "dense_rank() over (partition by g order by s) dr, "
        "sum(w) over (partition by g order by s) rs, "
        "first_value(w) over (partition by g order by s) fv from t", ["g", "s", "rk"], REL),
    "string_order_desc_nulls_and_ties": (
        _strings_with_nulls, "select g, s, rank() over (partition by g order by s desc) rk, "
        "count(*) over (partition by g order by s desc) rc from t", ["g", "rk", "rc"], REL),
    # integer sums cross as exact pairs: bit for bit
    "int_window_sums_above_2p24_exact": (
        _big_ints, "select g, iv, sum(b) over (partition by g order by iv) rs, "
        "avg(b) over (partition by g order by iv) ra, sum(b) over (partition by g order by iv "
        "rows between 2 preceding and current row) fs from t", ["g", "iv"], 1e-9),
}


def _run(mod, t, sql: str, tpu: bool, cls):
    cfg = {"ballista.tpu.enable": str(tpu).lower(), "ballista.tpu.min_rows": "0"}
    ctx = (mod.SessionContext(mod.BallistaConfig(cfg), device="cpu") if mod is tbt
           else mod.SessionContext(mod.BallistaConfig(cfg)))
    ctx.register_arrow_table("t", t, partitions=2)
    plan = ctx.sql(sql).physical_plan()
    got = ctx.execute(plan)
    nodes, stack = [], [plan]
    while stack:
        nd = stack.pop()
        if cls is not None and isinstance(nd, cls):
            nodes.append(nd)
        stack.extend(nd.children())
    m: dict = {}
    for nd in nodes:
        for k, v in nd.metrics.to_dict().items():
            m[k] = m.get(k, 0) + v
    return got, nodes, m


def _close(want: pa.Table, got: pa.Table, rel: float, what: str) -> None:
    assert want.num_rows == got.num_rows, what
    for name in want.schema.names:
        for i, (x, y) in enumerate(zip(want.column(name).to_pylist(),
                                       got.column(name).to_pylist())):
            if isinstance(x, float) and x is not None and y is not None:
                assert y == pytest.approx(x, rel=rel), (what, name, i)
            else:
                assert x == y, (what, name, i, x, y)


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_x32_matches_jax_and_cpu(case):
    make, sql, sort_cols, rel = WINDOW_CASES[case]
    t = make()
    keys = [(c, "ascending") for c in sort_cols]
    want, _, _ = _run(jbt, t, sql, False, None)
    got, tnodes, tm = _run(tbt, t, sql, True, TorchWindowExec)
    jgot, jnodes, jm = _run(jbt, t, sql, True, TpuWindowExec)
    want = want.sort_by(keys)
    _close(want, got.sort_by(keys), rel, "port")
    _close(want, jgot.sort_by(keys), rel, "JAX")
    assert tnodes and jnodes and all(n._mode == "x32" for n in tnodes)
    assert tm.get("tpu_window", 0) >= 1 and tm.get("tpu_fallback", 0) == 0, tm
    assert bool(jm.get("tpu_fallback", 0)) == bool(tm.get("tpu_fallback", 0)), (tm, jm)


def test_window_x32_int_sum_past_2p48_stays_on_the_cpu():
    """An integer window sum past the 48-bit pair's range does not lower in
    x32: the partition answers on the CPU operator, exactly."""
    n = 200
    t = pa.table({"g": pa.array(np.zeros(n, np.int64)),
                  "iv": pa.array(np.arange(n, dtype=np.int64)),
                  "b": pa.array(np.full(n, (1 << 50) + 3, np.int64))})
    sql = "select g, iv, sum(b) over (partition by g order by iv) rs from t"
    want, _, _ = _run(jbt, t, sql, False, None)
    got, _, tm = _run(tbt, t, sql, True, TorchWindowExec)
    keys = [("iv", "ascending")]
    assert want.sort_by(keys).equals(got.sort_by(keys))
    assert tm.get("tpu_fallback", 0) >= 1 and not tm.get("tpu_window", 0), tm
