"""The PyTorch port's x32 int64 handling against the JAX package's, on
the CPU.

Twins of 5 of the 6 cases of ``tests/test_i64_x32.py``: count over an
int64 column past int32 ships only its validity, avg over one rides an
exact f32 (hi, lo) pair while sum re-runs on the CPU operators (an INT
output must be exact), a udaf stays on the CPU at plan time, groups ~
rows with ``highcard_mode=cpu`` go to the CPU hash aggregate, and null
int group keys stay on the device.  The sixth,
``test_q3_with_big_orderkeys_no_fallback``, runs x32's join fold, which
the port takes as the reference does; its twin is in
``tests/test_torch_x32_routes.py`` beside the other join-fold cases.
"""

import collections

import numpy as np
import pyarrow as pa
import pytest

import arrow_ballista_tpu_torch as tbt
from test_torch_precision_x32 import port_metrics, three, x32_both  # noqa: F401

pytestmark = pytest.mark.usefixtures("x32_both")

NO_MESH = {"ballista.mesh.enable": "false"}


def _big_table(n=5000, seed=11):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 5, n).astype(np.int64)
    big = (rng.integers(0, 1 << 40, n) + (1 << 33)).astype(np.int64)
    vals = rng.uniform(1.0, 100.0, n)
    mask = rng.random(n) < 0.1
    big_nullable = pa.array([None if m else int(v) for v, m in zip(big, mask)], pa.int64())
    t = pa.table({"k": pa.array(keys), "big": pa.array(big), "bign": big_nullable,
                  "v": pa.array(vals)})
    return t, keys, big, big_nullable


def test_count_wide_i64_stays_on_device():
    t, keys, _big, bign = _big_table()
    sql = "select k, count(bign) as cb, count(*) as c from t group by k order by k"
    want, jgot, got, m = three(sql, {"t": t}, **NO_MESH)
    assert m.get("tpu_fallback", 0) == 0, m
    assert "device_time_ns" in m, m
    assert got.to_pylist() == want.to_pylist() == jgot.to_pylist()
    nulls = np.array([v is None for v in bign.to_pylist()])
    for row in got.to_pylist():
        assert row["cb"] == int(((keys == row["k"]) & ~nulls).sum())
        assert row["c"] == int((keys == row["k"]).sum())


def test_avg_wide_i64_on_device_sum_exact_via_fallback():
    t, keys, big, _ = _big_table()
    want, jgot, got, m = three("select k, avg(big) as a from t group by k order by k",
                               {"t": t}, **NO_MESH)
    assert m.get("tpu_fallback", 0) == 0, m
    assert "device_time_ns" in m, m
    for row, jrow in zip(got.to_pylist(), jgot.to_pylist()):
        sel = big[keys == row["k"]]
        assert row["a"] == pytest.approx(sel.sum() / len(sel), rel=1e-7)
        assert row["a"] == pytest.approx(jrow["a"], rel=1e-7)
    # sum(i64) past int32: the INT output must be exact, so the partition
    # re-runs on the CPU operators
    want, jgot, got, m = three("select k, sum(big) as s from t group by k order by k",
                               {"t": t}, **NO_MESH)
    assert m.get("tpu_fallback", 0) >= 1, m
    for row in got.to_pylist():
        assert row["s"] == int(big[keys == row["k"]].sum())
    assert got.to_pylist() == jgot.to_pylist()


def test_udaf_rejected_at_plan_time():
    from arrow_ballista_tpu_torch.udf import AggregateUDF

    t = pa.table({"k": pa.array([1, 2, 1], pa.int64()), "v": pa.array([1.0, 2.0, 3.0])})
    ctx = tbt.SessionContext(tbt.BallistaConfig({"ballista.tpu.min_rows": "0", **NO_MESH}),
                             device="cpu")

    def my_last(values: pa.Array):
        vals = [v.as_py() for v in values if v.is_valid]
        return vals[-1] if vals else None

    ctx.register_udaf(AggregateUDF("my_last", my_last, pa.float64(), pa.float64()))
    ctx.register_arrow_table("t", t, partitions=1)
    plan = ctx.sql("select k, my_last(v) from t group by k").physical_plan()
    found = []
    stack = [plan]
    while stack:
        node = stack.pop()
        found.append(type(node).__name__)
        stack.extend(node.children())
    assert "TorchStageExec" not in found, found


def test_high_cardinality_routes_to_cpu_hash_agg():
    rng = np.random.default_rng(5)
    n = 300_000
    keys = rng.integers(0, 150_000, n).astype(np.int64)
    t = pa.table({"k": pa.array(keys), "v": pa.array(np.ones(n))})
    ctx = tbt.SessionContext(tbt.BallistaConfig({
        "ballista.tpu.min_rows": "0", "ballista.tpu.highcard_mode": "cpu", **NO_MESH,
    }), device="cpu")
    ctx.register_arrow_table("t", t, partitions=2)
    plan = ctx.sql("select k, sum(v) from t group by k order by k limit 5").physical_plan()
    out = ctx.execute(plan)
    m = port_metrics(plan)
    assert m.get("highcard_fallback", 0) >= 1, m
    assert "device_time_ns" not in m, m
    assert out.num_rows == 5
    counts = collections.Counter(keys.tolist())
    for row in out.to_pylist():
        assert row["sum(v)"] == counts[row["k"]]


def test_null_group_keys_stay_on_device():
    t = pa.table({"k": pa.array([1, None, 2, None, 1], pa.int64()),
                  "v": pa.array([1.0, 2.0, 3.0, 4.0, 5.0])})
    want, jgot, got, m = three("select k, sum(v) as s from t group by k order by k",
                               {"t": t}, **NO_MESH)
    assert m.get("tpu_fallback", 0) == 0, m
    assert {r["k"]: r["s"] for r in got.to_pylist()} == {1: 6.0, 2: 3.0, None: 6.0}
    assert got.to_pylist() == jgot.to_pylist()
