"""The PyTorch port's statistical aggregates against the JAX package's.

Median and count distinct ride the keyed route's sorted-argument pass
(B9), corr its two-pass centred moments (B10), and the variance family
lowers as Σx and Σx² on either route, finished on the host behind a
conditioning guard.  The kernel twins are held to the JAX package's
``keyed_median_kernel`` (packed words bit for bit) and
``keyed_corr_kernel`` (counts exact, f64 moments within rel 1e-9) on the
same seeded inputs; whole stages run three ways (the port on
``device="cpu"``, the JAX package's device stage in x64, the CPU
operators) and must agree: floats within rel 1e-9, everything else exact.
These are the x64 cases of ``tests/test_device_median.py`` and
``tests/test_stat_aggregates.py``, the h2o groupby questions q6, q9 and
q10 on a small G1 table, and local TPC-H q3 on the keyed route.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from test_torch_keyed import _keyed, three_ways

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu.ops import stage_compiler as JSC
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops import stage_compiler as TSC
from arrow_ballista_tpu_torch.ops.bridge import split_u64_i32, to_u64_order
from benchmarks.h2o.__main__ import QUESTIONS, gen_groupby
from benchmarks.tpch.datagen import gen_table
from benchmarks.tpch.queries import QUERIES

REL = 1e-9


@pytest.fixture(autouse=True)
def _x64():
    old = JK._PRECISION["mode"]
    JK.set_precision("x64")
    try:
        yield
    finally:
        JK._PRECISION["mode"] = old


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------ median twin (B9)
def _median_inputs(case: str, rng, n: int):
    keys = [rng.integers(0, 37, n).astype(np.int32), rng.integers(0, 2, n).astype(np.int64)]
    v = np.round(rng.normal(0, 10, n), 1)
    if case == "hi_word_collision":
        v = 1.0 + rng.integers(0, 4, n) * 1e-9
    valid = rng.random(n) > 0.1
    if case == "all_null_groups":
        valid &= keys[0] % 5 != 0
    mask = rng.random(n) > 0.2
    return mask, keys, v, valid


@pytest.mark.parametrize("case", ["random", "hi_word_collision", "all_null_groups"])
@pytest.mark.parametrize("cap", [64, 1024])
def test_median_twin_matches_reference(case, cap):
    rng = np.random.default_rng(len(case) + cap)
    mask, keys, v, valid = _median_inputs(case, rng, 3000)
    ohi, olo = split_u64_i32(to_u64_order(v))
    want = np.asarray(JK.keyed_median_kernel(len(keys), cap)(
        jnp.asarray(mask), tuple(jnp.asarray(k) for k in keys), jnp.asarray(ohi),
        jnp.asarray(olo), jnp.asarray(valid)))
    got = TK.keyed_median_reference(
        _t((~mask).astype(np.int32)), [_t(k) for k in keys], _t(ohi), _t(olo), _t(valid),
        cap).numpy()
    assert np.array_equal(got, want)


# -------------------------------------------------------- corr twin (B10)
@pytest.mark.parametrize("ints", [False, True])
def test_corr_twin_matches_reference(ints):
    rng = np.random.default_rng(29 + ints)
    n = 5000
    mask = rng.random(n) > 0.2
    keys = [rng.integers(0, 40, n).astype(np.int32)]
    if ints:
        x = rng.integers(1, 6, n).astype(np.int64)
        y = rng.integers(1, 16, n).astype(np.int64)
    else:
        x = rng.uniform(0, 100, n)
        y = 3.0 * x + rng.normal(0, 25, n)
        x[::31] = np.nan
    xv, yv = rng.random(n) > 0.05, rng.random(n) > 0.05
    srt = JK.keyed_sort_kernel(1)(jnp.asarray(mask), jnp.asarray(keys[0]))
    cap = 64
    want = np.asarray(JK.keyed_corr_kernel(cap, "x64")(
        srt[0], srt[1], jnp.asarray(x.astype(np.float64)), jnp.asarray(xv),
        jnp.asarray(y.astype(np.float64)), jnp.asarray(yv)))
    perm, gids, _ = TK.keyed_sort(_t((~mask).astype(np.int32)), [_t(keys[0])])
    got = TK.keyed_corr_reference(gids["s2"], perm, gids["gid_in"], _t(x), _t(xv),
                                  _t(y), _t(yv), cap).numpy()
    assert np.array_equal(got[3], want[3])
    for r in range(3):
        np.testing.assert_allclose(got[r].view(np.float64), want[r].view(np.float64),
                                   rtol=REL, atol=0)


# ---------------------------------------------------------- whole stages
def _median_data(n=5000, n_groups=37, seed=17, null_frac=0.07):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, n_groups, n).astype(np.int64)),
        "v": pa.array(rng.uniform(0, 1000, n), pa.float64(),
                      mask=rng.uniform(size=n) < null_frac),
        "iv": pa.array(rng.integers(-500, 500, n), pa.int64()),
    })


STAT_CASES = {
    "median": "select k, median(v) as md, count(*) as c from t group by k",
    "median_with_stddev_and_sums": "select k, median(v) as md, stddev(v) as sd, "
                                   "avg(v) as a, sum(iv) as s from t group by k",
    "median_int_column_and_two_medians": "select k, median(v) as mv, median(iv) as mi "
                                         "from t group by k",
    "count_distinct": "select k, count(distinct iv) as cd, count(distinct v) as cdv, "
                      "count(*) as c from t group by k",
    "count_distinct_with_median_one_pass": "select k, median(v) as md, "
                                           "count(distinct v) as cd from t group by k",
    "variance_family": "select k, stddev(v) as sd, stddev_pop(v) as sdp, var(iv) as vr, "
                       "var_pop(iv) as vp from t group by k",
}


@pytest.mark.parametrize("case", sorted(STAT_CASES))
def test_stat_stage_matches_jax_and_cpu(case):
    pm, jm = three_ways(STAT_CASES[case], {"t": _median_data()})
    assert pm.get("tpu_fallback", 0) == jm.get("tpu_fallback", 0) == 0
    if "median" in case or "distinct" in case:
        _keyed(pm, jm)


def test_median_all_null_group_and_tiny_groups():
    t = pa.table({"k": pa.array([1, 1, 2, 2, 2, 3, 4, 4], pa.int64()),
                  "v": pa.array([10.0, 20.0, None, None, None, 7.5, 1.0, None])})
    pm, jm = three_ways("select k, median(v) as md, count(distinct v) as cd "
                        "from t group by k", {"t": t})
    _keyed(pm, jm)


def test_median_multi_partition_and_batches():
    pm, jm = three_ways("select k, median(v) as md from t group by k",
                        {"t": _median_data(n=8000)}, batches=1000)
    _keyed(pm, jm)


def test_median_distinct_hi_word_collision():
    vals = [1.0, 1.000000001, 1.0, 1.000000001, 1.0000000005, 1.0, 1.000000002,
            5.0, 5.000000001, 5.0]
    t = pa.table({"k": pa.array([1] * 7 + [2] * 3, pa.int64()),
                  "v": pa.array(vals, pa.float64())})
    pm, jm = three_ways("select k, median(v) as md, count(distinct v) as dv "
                        "from t group by k", {"t": t})
    _keyed(pm, jm)


def _corr_table(seed=29, n=6000):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 100, n)
    return pa.table({
        "k": pa.array(rng.integers(0, 30, n).astype(np.int64)),
        "x": pa.array(x, pa.float64(), mask=rng.uniform(size=n) < 0.05),
        "y": pa.array(3.0 * x + rng.normal(0, 25, n), pa.float64(),
                      mask=rng.uniform(size=n) < 0.05),
    })


def test_corr_on_device():
    pm, jm = three_ways("select k, corr(x, y) as r, corr(y, x) as r2, count(*) as c "
                        "from t group by k", {"t": _corr_table()})
    _keyed(pm, jm)


def test_corr_degenerate_groups_null():
    t = pa.table({"k": pa.array([1, 2, 2, 3, 3, 3], pa.int64()),
                  "x": pa.array([1.0, 5.0, 5.0, 1.0, 2.0, 3.0]),
                  "y": pa.array([2.0, 1.0, 9.0, 2.0, 4.0, 6.0])})
    pm, jm = three_ways("select k, corr(x, y) as r from t group by k", {"t": t})
    _keyed(pm, jm)


def test_corr_nan_values_drop_pairwise():
    t = pa.table({"g": pa.array([1, 1, 1, 1, 2, 2, 2], pa.int64()),
                  "x": pa.array([1.0, 2.0, float("nan"), 4.0, 1.0, 2.0, 3.0]),
                  "y": pa.array([2.0, 4.1, 5.0, 8.3, 3.0, float("nan"), 1.0])})
    pm, jm = three_ways("select g, corr(x, y) as r from t group by g", {"t": t})
    _keyed(pm, jm)


def test_variance_guard_reruns_constant_columns_on_the_cpu():
    """A constant column's variance cancels to the rounding floor: the
    guard sends the partition to the CPU operators, which return 0."""
    rng = np.random.default_rng(3)
    t = pa.table({"k": pa.array(rng.integers(0, 5, 2000)),
                  "c": pa.array(np.full(2000, 1e6 + 0.1))})
    pm, jm = three_ways("select k, var(c) as v, stddev(c) as s from t group by k",
                        {"t": t})
    assert pm.get("tpu_fallback", 0) == jm.get("tpu_fallback", 0) >= 1


def _stages(plan, cls) -> list:
    out, stack = [], [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, cls):
            out.append(node)
        stack.extend(node.children())
    return out


def test_stat_family_lowers_to_the_device_stage():
    """The whole statistical family lowers to ``TorchStageExec`` grouped;
    a global median stays on the CPU operators in both packages."""
    t = _median_data()
    for sql, n_stages in (
        ("select k, median(v), stddev(iv), count(distinct iv), corr(v, iv), sum(v) "
         "from t group by k", 1),
        ("select median(v) as m, corr(v, iv) as r from t", 0),
    ):
        cfg = {"ballista.tpu.enable": "true", "ballista.tpu.min_rows": "0"}
        port = tbt.SessionContext(tbt.BallistaConfig(cfg), device="cpu")
        ref = jbt.SessionContext(jbt.BallistaConfig(cfg))
        for ctx in (port, ref):
            ctx.register_arrow_table("t", t)
        got = len(_stages(port.sql(sql).physical_plan(), TSC.TorchStageExec))
        want = len(_stages(ref.sql(sql).physical_plan(), JSC.TpuStageExec))
        assert got == want == n_stages, sql


# ------------------------------------------------------------ h2o groupby
H2O = dict((q, sql) for q, _name, sql in QUESTIONS)


@pytest.mark.parametrize("q", ["q6", "q9", "q10"])
def test_h2o_groupby_questions(q):
    """db-benchmark's G1 table at 5,000 rows and 10 low-card groups: q6
    (median and stddev by two int keys), q9 (corr² by a string and an int
    key) on the keyed route at any cardinality, q10 (sum and count by all
    six keys, about one group a row) pinned keyed by
    ``highcard_mode=device``."""
    x = gen_groupby(5000, 10, seed=42)
    extra = {"ballista.tpu.highcard_mode": "device"} if q == "q10" else {}
    pm, jm = three_ways(H2O[q], {"x": x}, **extra)
    _keyed(pm, jm)
    if q in ("q6", "q10"):
        assert pm.get("device_encode_batches", 0) >= 1, pm


def test_local_q3_on_the_keyed_route():
    """TPC-H q3 under ``highcard_mode=device``: the orders-lineitem join
    folds and the stage takes the keyed route in both packages, the probe
    inside the keyed prep, with no fallback."""
    tables = {n: gen_table(n, 0.01) for n in ("lineitem", "orders", "customer")}
    pm, jm = three_ways(QUERIES[3], tables, **{"ballista.tpu.highcard_mode": "device",
                                               "ballista.shuffle.partitions": "1"})
    for m in (pm, jm):
        assert m.get("keyed_path", 0) == 1, m
        assert m.get("dense_join", 0) == 1 and m.get("join_fallback", 0) == 0, m
        assert m.get("tpu_fallback", 0) == 0, m
