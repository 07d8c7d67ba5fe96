"""The PyTorch port's device join against the JAX package's.

An inner PK-FK hash join below a partial aggregate folds into the device
stage (``DeviceJoinSpec``): the build side is collected once on the host
and every probe batch joins on the device, its misses folded into the row
mask.  Each query here runs three ways on the same seeded tables — the
port's ``SessionContext(device="cpu")`` (the probe kernel's plain twin),
the JAX package's ``SessionContext`` with its ``TpuStageExec`` (x64 on the
CPU, as the port is) and the JAX package's CPU operators
(``ballista.tpu.enable=false``) — and the three answers must agree: floats
within rel 1e-9, everything else exact.  The two device stages must also
route alike: the same fold decision, the same ``dense_join``,
``join_fallback`` and ``tpu_fallback`` counts.

Cases: the 8 of ``tests/test_device_join.py`` and the 6 of
``tests/test_dense_join.py`` (those force the reference's x32 mode, in
which build keys past 2^31 cannot ship; in x64 both packages keep such a
join on the device), the probe twins against the reference's
``make_join_kernel``, the fold decisions, the capacity bail, and the star
join and TPC-H q3 locally and through both packages' standalone clusters.
"""

import os

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu.client import BallistaContext as JBallistaContext
from arrow_ballista_tpu.exec.aggregates import HashAggregateExec as JHashAggregateExec
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu.ops import stage_compiler as JSC
from arrow_ballista_tpu.ops.stage_compiler import TpuStageExec
from arrow_ballista_tpu_torch.exec.aggregates import HashAggregateExec
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops import stage_compiler as TSC
from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec
from benchmarks.tpch.datagen import gen_table
from benchmarks.tpch.queries import QUERIES

REL = 1e-9
ROUTE_KEYS = ("dense_join", "join_fallback", "tpu_fallback", "cpu_fallback",
              "highcard_fallback")


def _settings(tpu: bool, extra: dict) -> dict:
    s = {
        "ballista.tpu.enable": str(tpu).lower(),
        "ballista.tpu.min_rows": "0",
        "ballista.mesh.enable": "false",
    }
    s.update({k: str(v) for k, v in extra.items()})
    return s


def _stages(plan, cls) -> list:
    out, stack = [], [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, cls):
            out.append(node)
        stack.extend(node.children())
    return out


def _route(stages) -> dict:
    m: dict = {}
    for s in stages:
        for k, v in s.metrics.to_dict().items():
            m[k] = m.get(k, 0) + v
    return {k: m.get(k, 0) for k in ROUTE_KEYS}, m


def _assert_equal(a: pa.Table, b: pa.Table, what: str = ""):
    """Same rows in any order: sorted by every non-float column, floats
    within REL, everything else exact."""
    assert a.schema.names == b.schema.names, what
    assert a.num_rows == b.num_rows, what
    key = [(c, "ascending") for c in a.column_names
           if not pa.types.is_floating(a.schema.field(c).type)]
    if key:
        a, b = a.sort_by(key), b.sort_by(key)
    for name in a.schema.names:
        for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
            if isinstance(x, float) and x is not None and y is not None:
                assert y == pytest.approx(x, rel=REL), (what, name)
            else:
                assert x == y, (what, name)


def _three(tables: dict, sql: str, parts: int = 1, **extra):
    """Run ``sql`` on the port, the JAX device stage and the JAX CPU
    operators; assert the answers agree and the two device stages route
    alike.  Returns (port stages, JAX stages, port metrics)."""
    port = tbt.SessionContext(tbt.BallistaConfig(_settings(True, extra)), device="cpu")
    jdev = jbt.SessionContext(jbt.BallistaConfig(_settings(True, extra)))
    cpu = jbt.SessionContext(jbt.BallistaConfig(_settings(False, extra)))
    for ctx in (port, jdev, cpu):
        for name, t in tables.items():
            ctx.register_arrow_table(name, t, partitions=parts)
    want = cpu.sql(sql).collect()
    out = []
    for ctx, cls in ((port, TorchStageExec), (jdev, TpuStageExec)):
        plan = ctx.sql(sql).physical_plan()
        got = ctx.execute(plan)
        _assert_equal(got, want, f"{cls.__name__} vs the CPU operators")
        out.append((_stages(plan, cls), got))
    (tst, _), (jst, _) = out
    assert [s.fused.join is not None for s in tst] == [
        s.fused.join is not None for s in jst
    ]
    troute, tm = _route(tst)
    jroute, _ = _route(jst)
    assert troute == jroute, (troute, jroute)
    return tst, jst, tm, out[0][1]


# ----------------------------------------------- tests/test_device_join.py
def _dims(n=60, seed=3):
    rng = np.random.default_rng(seed)
    dim = pa.table({
        "dk": pa.array(np.arange(1, n + 1), pa.int64()),
        "dv": pa.array(rng.uniform(0, 10, n)),
        "dtag": pa.array(rng.integers(0, 4, n), pa.int32()),
    })
    fact = pa.table({
        "fk": pa.array(rng.integers(1, n + 20, 1000), pa.int64()),  # some unmatched
        "g": pa.array(rng.integers(0, 5, 1000), pa.int64()),
        "v": pa.array(rng.uniform(0, 100, 1000)),
    })
    return {"dim": dim, "fact": fact}


def _null_fk():
    d = _dims()
    fk = d["fact"].column("fk").to_pylist()
    fk[::7] = [None] * len(fk[::7])
    return {"dim": d["dim"], "fact": d["fact"].set_column(0, "fk", pa.array(fk, pa.int64()))}


def _null_dv():
    d = _dims()
    dv = d["dim"].column("dv").to_pylist()
    dv[::3] = [None] * len(dv[::3])
    return {"dim": d["dim"].set_column(1, "dv", pa.array(dv, pa.float64())), "fact": d["fact"]}


def _dup_dim():
    d = _dims()
    return {"dim": pa.concat_tables([d["dim"], d["dim"].slice(0, 5)]), "fact": d["fact"]}


def _empty_dim():
    d = _dims()
    return {"dim": d["dim"].slice(0, 0), "fact": d["fact"]}


def _wide_keys():
    d = _dims()
    dk = (np.arange(1, 61) + (1 << 33)).astype(np.int64)
    fk = (d["fact"].column("fk").to_numpy() + (1 << 33)).astype(np.int64)
    return {"dim": d["dim"].set_column(0, "dk", pa.array(dk, pa.int64())),
            "fact": d["fact"].set_column(0, "fk", pa.array(fk, pa.int64()))}


_SUM_VDV = "select g, sum(v * dv) as s from dim, fact where dk = fk group by g order by g"
DEVICE_JOIN_CASES = {
    # name: (tables, sql, expected port route beyond the JAX parity)
    "inner_join_agg_folds_and_matches": (
        _dims, "select g, sum(v * dv) as s, count(*) as c "
        "from dim, fact where dk = fk group by g order by g",
        {"join_fallback": 0, "tpu_fallback": 0}),
    "build_side_filter_on_device": (
        _dims, "select g, sum(v) as s from dim, fact "
        "where dk = fk and dtag = 2 group by g order by g", {"join_fallback": 0}),
    "build_group_key_resolved_at_materialize": (
        _dims, "select fk, dtag, sum(v) as s from dim, fact "
        "where dk = fk group by fk, dtag order by fk", {"join_fallback": 0}),
    "null_probe_keys_drop": (
        _null_fk, "select g, count(*) as c, sum(dv) as s from dim, fact "
        "where dk = fk group by g order by g", {"join_fallback": 0}),
    "null_build_values_gather_as_null": (
        _null_dv, "select g, sum(dv) as s, count(dv) as c from dim, fact "
        "where dk = fk group by g order by g", {"join_fallback": 0}),
    # one fallback per probe partition (ballista.shuffle.partitions): the
    # build state is kept only when the build side is eligible
    "non_unique_build_keys_fall_back_correctly": (
        _dup_dim, _SUM_VDV, {"join_fallback": 2}),
    "empty_build_side": (
        _empty_dim, "select g, sum(v) as s from dim, fact where dk = fk group by g", {}),
    "wide_build_keys_stay_on_the_device_join": (
        _wide_keys, _SUM_VDV, {"join_fallback": 0, "dense_join": 1}),
}


@pytest.mark.parametrize("name", sorted(DEVICE_JOIN_CASES))
def test_device_join_case_matches_jax_and_cpu(name):
    make, sql, route = DEVICE_JOIN_CASES[name]
    tst, _, m, got = _three(make(), sql, parts=2)
    folded = [s for s in tst if s.fused.join is not None]
    assert folded, "the join did not fold into the device stage"
    for k, v in route.items():
        assert m.get(k, 0) == v, (k, m)
    if name == "build_group_key_resolved_at_materialize":
        assert any(k == "build" for k, _ in folded[0]._group_plan)
    if name == "empty_build_side":
        assert got.num_rows == 0
    if route.get("tpu_fallback") == 0:
        assert m.get("device_time_ns", 0) > 0, m


# ------------------------------------------------ tests/test_dense_join.py
def _dense_tables(build_keys, probe_lo, probe_hi, n=4000, seed=0):
    rng = np.random.default_rng(seed)
    m = len(build_keys)
    dim = pa.table({
        "pk": pa.array(build_keys, pa.int64()),
        "dv": pa.array(rng.uniform(0.5, 1.5, m)),
        "dg": pa.array((np.arange(m) % 5).astype(np.int64)),
    })
    fact = pa.table({
        "fk": pa.array(rng.integers(probe_lo, probe_hi, n), pa.int64()),
        "g": pa.array(rng.integers(0, 5, n), pa.int64()),
        "v": pa.array(rng.uniform(0, 100, n)),
    })
    return {"dim": dim, "fact": fact}


_DENSE_SQL = ("select g, sum(v * dv) as s, count(*) as c "
              "from dim, fact where pk = fk group by g")
DENSE_CASES = {
    "dense_contiguous_keys": (np.arange(1, 1001), 1, 1200, True),
    # kmin far from zero: the probe offset must not assume a 0 base
    "dense_offset_keys": (np.arange(5_000_000, 5_001_000), 4_999_000, 5_002_000, True),
    # every 7th key only: slots between keys stay misses
    "dense_gappy_keys": (np.arange(1, 7000, 7), 1, 7100, True),
    # probes below kmin exercise the rel < 0 bound
    "dense_negative_probe_range": (np.arange(100, 600), -500, 700, True),
    # span past the slot cap: the sorted probe
    "wide_span_falls_back_to_sorted_probe": (np.arange(0, 1 << 28, 1 << 18), 0, 1 << 28, False),
}


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_join_case_matches_jax_and_cpu(name):
    keys, lo, hi, dense = DENSE_CASES[name]
    tst, _, m, _ = _three(_dense_tables(keys, lo, hi), _DENSE_SQL,
                          **{"ballista.shuffle.partitions": 1})
    assert any(s.fused.join is not None for s in tst)
    assert m.get("dense_join", 0) == int(dense), m
    assert m.get("join_fallback", 0) == 0 and m.get("tpu_fallback", 0) == 0, m


def test_probe_key_overflow_degrades_to_cpu_join_device_agg():
    """The group table of a join-fused stage holds every distinct PROBE key
    before the join filters; past the ceiling both packages retry the
    unfolded shape (join on the CPU, aggregate on the device), not the
    CPU operators."""
    rng = np.random.default_rng(7)
    n = 5000
    dim = pa.table({"pk": pa.array(np.arange(100), pa.int64()),
                    "dv": pa.array(rng.uniform(0.5, 1.5, 100))})
    fact = pa.table({"fk": pa.array(rng.permutation(5000), pa.int64()),
                     "v": pa.array(rng.uniform(0, 100, n))})
    sql = "select fk, sum(v * dv) as s from dim, fact where pk = fk group by fk"
    _, _, m, _ = _three({"dim": dim, "fact": fact}, sql, **{
        "ballista.tpu.max_capacity": 1024, "ballista.tpu.segment_capacity": 64,
        "ballista.shuffle.partitions": 1})
    assert m.get("join_fallback", 0) == 1 and m.get("tpu_fallback", 0) == 1, m
    assert m.get("device_time_ns", 0) > 0, m  # the aggregate still ran on the device


# --------------------------------------------------------- probe kernels
def _probe_case(n: int, m: int, seed: int):
    """Unique sorted build keys (negatives included), probe keys that hit,
    miss between keys, fall below kmin and above kmax, are far negative,
    or are null; three build columns (f64 with NaN and -0.0, int64 past
    2^53, bool) with nulls in two of them; a row mask."""
    rng = np.random.default_rng(seed)
    bkeys = np.sort(rng.choice(np.arange(-3000, 40_000), m, replace=False)).astype(np.int64)
    pick = rng.random(n)
    pkey = np.where(pick < 0.6, rng.choice(bkeys, n), rng.integers(-3000, 40_000, n))
    pkey[pick > 0.9] = rng.integers(-(2**40), -3001, int((pick > 0.9).sum()))
    pkey[(pick > 0.85) & (pick <= 0.9)] = rng.integers(40_000, 2**40, int(((pick > 0.85) & (pick <= 0.9)).sum()))
    pkey[:4] = [bkeys[0] - 1, bkeys[-1] + 1, bkeys[0], bkeys[-1]]
    pkey_valid = rng.random(n) >= 0.05
    valid = rng.random(n) >= 0.1
    f = rng.uniform(-1e3, 1e3, m)
    f[rng.random(m) < 0.02] = np.nan
    f[:3] = [-0.0, 0.0, -0.0]
    bvals = [f, rng.integers(2**53, 2**60, m), rng.random(m) < 0.5]
    bvalids = [rng.random(m) >= 0.1, None, rng.random(m) >= 0.2]
    return bkeys, pkey, pkey_valid, valid, bvals, bvalids


_FLAT = ["col_0", "col_0__valid", "col_1", "col_1__valid", "col_2",
         "col_2__valid", "col_3", "col_3__valid"]
_SLOTS = {"col_1": 0, "col_1__valid": 0, "col_2": 1, "col_2__valid": 1,
          "col_3": 2, "col_3__valid": 2}


def _recorder():
    seen = []

    def inner(*args, state=None):
        seen.append(args)
        return state

    return seen, inner


def _words(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int64) if a.dtype == np.float64 else a


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sorted"])
@pytest.mark.parametrize("seed", [0, 1])
def test_join_probe_twin_matches_make_join_kernel(dense, seed):
    n, m = 6000, 1500
    bkeys, pkey, pkey_valid, valid, bvals, bvalids = _probe_case(n, m, seed)
    rng = np.random.default_rng(seed + 10)
    seg = np.zeros(n, np.int32)
    probe_v, probe_valid = rng.uniform(0, 1, n), rng.random(n) >= 0.3
    kmin = int(bkeys[0])
    span_b = max(16, 1 << (int(bkeys[-1]) - kmin).bit_length())

    # the reference: make_join_kernel over jnp arrays (build validity all
    # ones where the port passes None), its inner function recording
    jseen, jinner = _recorder()
    jfn = JK.make_join_kernel(jinner, _FLAT, _SLOTS, 3, dense=dense)
    jv = [jnp.asarray(v) for v in bvals]
    jvalid = [jnp.asarray(np.ones(m, bool) if bv is None else bv) for bv in bvalids]
    if dense:
        tbl = jnp.zeros(span_b, jnp.int32).at[jnp.asarray(bkeys - kmin, jnp.int32)].set(
            jnp.arange(1, m + 1, dtype=jnp.int32))
        head = [tbl, jnp.asarray(np.int64(kmin))]
    else:
        head = [jnp.asarray(bkeys)]
    jfn(jnp.asarray(seg), jnp.asarray(valid), jnp.asarray(probe_v),
        jnp.asarray(probe_valid), jnp.asarray(pkey), jnp.asarray(pkey_valid),
        *head, *jv, *jvalid)

    tseen, tinner = _recorder()
    tfn = TK.make_join_kernel(tinner, _FLAT, _SLOTS, 3, dense=dense)
    t = torch.from_numpy
    tb = t(bkeys)
    head = [TK.join_build_table_twin(tb, kmin, span_b), kmin] if dense else [tb]
    tfn(t(seg), t(valid), t(probe_v), t(probe_valid), t(pkey), t(pkey_valid), *head,
        *[t(v) for v in bvals], *[None if bv is None else t(bv) for bv in bvalids])

    (jargs,), (targs,) = jseen, tseen
    assert len(jargs) == len(targs) == 2 + len(_FLAT)
    for i, (a, b) in enumerate(zip(jargs, targs)):
        assert np.array_equal(_words(a), _words(b.numpy())), i
    mask = targs[1].numpy()
    assert 0 < mask.sum() < n and not mask[~pkey_valid].any()


def test_join_build_table_twin_matches_reference_scatter():
    rng = np.random.default_rng(4)
    bkeys = np.sort(rng.choice(np.arange(-10**6, 10**6), 5000, replace=False)).astype(np.int64)
    kmin = int(bkeys[0])
    span_b = 1 << (int(bkeys[-1]) - kmin).bit_length()
    want = jnp.zeros(span_b, jnp.int32).at[jnp.asarray(bkeys - kmin, jnp.int32)].set(
        jnp.arange(1, len(bkeys) + 1, dtype=jnp.int32))
    got = TK.join_build_table(torch.from_numpy(bkeys), kmin, span_b)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


def test_join_probe_validity_none_equals_all_valid():
    bkeys, pkey, pkey_valid, valid, bvals, _ = _probe_case(3000, 800, 5)
    t = torch.from_numpy
    cols = [t(v) for v in bvals]
    for form in (dict(bkeys=t(bkeys)),
                 dict(table=TK.join_build_table_twin(t(bkeys), int(bkeys[0]), 1 << 16),
                      kmin=int(bkeys[0]))):
        a = TK.join_probe(t(pkey), None, None, cols, [None] * 3, **form)
        b = TK.join_probe(t(pkey), t(np.ones(3000, bool)), t(np.ones(3000, bool)), cols,
                          [t(np.ones(800, bool))] * 3, **form)
        for x, y in zip(a[0] + a[1] + [a[2]], b[0] + b[1] + [b[2]]):
            assert np.array_equal(_words(x.numpy()), _words(y.numpy()))


# --------------------------------------------------------- fold decisions
def _fold_tables():
    rng = np.random.default_rng(11)
    m, n = 50, 400
    dim = pa.table({
        "dk": pa.array(np.arange(m), pa.int64()),
        "dv": pa.array(rng.uniform(0, 10, m)),
        "dtag": pa.array(rng.integers(0, 4, m), pa.int32()),
        "dg": pa.array(rng.integers(0, 4, m), pa.int64()),
        "df": pa.array(np.arange(m, dtype=np.float64)),
        "dname": pa.array([f"n{i % 7}" for i in range(m)]),
        "dday": pa.array((np.arange(m) + 9000).astype("datetime64[D]"), pa.date32()),
    })
    fact = pa.table({
        "fk": pa.array(rng.integers(0, m + 10, n), pa.int64()),
        "g": pa.array(rng.integers(0, 4, n), pa.int64()),
        "v": pa.array(rng.uniform(0, 100, n)),
        "ff": pa.array(rng.integers(0, m, n).astype(np.float64)),
        "fday": pa.array((rng.integers(0, m, n) + 9000).astype("datetime64[D]"), pa.date32()),
    })
    return {"dim": dim, "fact": fact}


FOLD_CASES = {
    "inner": "select g, sum(v * dv) as s from dim, fact where dk = fk group by g",
    "inner_on": "select g, sum(v) as s from dim join fact on dk = fk group by g",
    "date_keys": "select g, count(*) as c from dim join fact on dday = fday group by g",
    "left_join": "select g, sum(v) as s from dim left join fact on dk = fk group by g",
    "right_join": "select g, sum(v) as s from dim right join fact on dk = fk group by g",
    "full_join": "select g, sum(v) as s from dim full join fact on dk = fk group by g",
    "multi_key": "select g, sum(v) as s from dim join fact on dk = fk and dg = g group by g",
    "float_keys": "select g, sum(v) as s from dim, fact where df = ff group by g",
    "build_group_with_probe_key": (
        "select fk, dtag, sum(v) as s from dim, fact where dk = fk group by fk, dtag"),
    "build_group_without_probe_key": (
        "select dtag, sum(v) as s from dim, fact where dk = fk group by dtag"),
    "build_group_expression": (
        "select fk, dtag + 1 as t, sum(v) as s from dim, fact where dk = fk group by fk, dtag + 1"),
    "host_expr_over_build": (
        "select g, sum(case when dname like 'n1%' then v else 0.0 end) as s "
        "from dim, fact where dk = fk group by g"),
    "count_of_build_column_only": (
        "select g, count(dv) as c from dim, fact where dk = fk group by g"),
    "global_aggregate": "select sum(v * dv) as s, count(*) as c from dim, fact where dk = fk",
}


def _spec(fused):
    j = fused.join
    if j is None:
        return None
    return (str(j.probe_key), j.build_key_index, list(j.build_cols),
            [str(f) for f in fused.filters], [str(g) for g, _ in fused.group_exprs],
            [str(a.arg) for a in fused.aggs])


@pytest.mark.parametrize("name", sorted(FOLD_CASES))
def test_fold_decisions_match_reference(name):
    """``_maybe_fold_join`` folds or declines on the same plans, with the
    same spec, and the fold-then-retry ladder lands on the same stage
    shape; the answers agree with the CPU operators."""
    sql = FOLD_CASES[name]
    tables = _fold_tables()
    plans = []
    for pkg, cls, agg_cls in ((tbt, TorchStageExec, HashAggregateExec),
                              (jbt, TpuStageExec, JHashAggregateExec)):
        kw = {"device": "cpu"} if pkg is tbt else {}
        ctx = pkg.SessionContext(pkg.BallistaConfig(_settings(False, {})), **kw)
        for t, tbl in tables.items():
            ctx.register_arrow_table(t, tbl)
        raw = ctx.sql(sql).physical_plan()
        plans.append([a for a in _stages(raw, agg_cls) if a.mode in ("partial", "single")])
    (taggs, jaggs) = plans
    assert len(taggs) == len(jaggs) >= 1
    folds = []
    for ta, ja in zip(taggs, jaggs):
        tf, jf = TSC._flatten(ta), JSC._flatten(ja)
        assert (tf is None) == (jf is None)
        if tf is not None:
            assert _spec(tf) == _spec(jf)
            folds.append(tf.join is not None)
    tst, jst, _, _ = _three(tables, sql)
    expect_folded = name in ("inner", "inner_on", "date_keys", "build_group_with_probe_key",
                             "global_aggregate")
    assert any(s.fused.join is not None for s in tst) == expect_folded
    assert any(folds) == (expect_folded or name in (
        "host_expr_over_build", "count_of_build_column_only"))
    assert len(tst) == len(jst) >= 1


# --------------------------------------------------------- capacity bail
BAIL_CASES = {
    # name: (fact rows, probe key bound, build rows, max_capacity, bail)
    "first_batch_outruns_the_table": (20_000, 1200, 1000, 1024, True),
    "first_batch_fits": (20_000, 1200, 1000, 4096, False),
    "first_batch_fills_half_the_ceiling": (200_000, 150_000, 100_000, 1 << 17, True),
    "first_batch_under_half_the_ceiling": (200_000, 150_000, 100_000, 1 << 18, False),
}


@pytest.mark.parametrize("name", sorted(BAIL_CASES))
def test_capacity_bail_routes_like_reference(name):
    """A join-fused stage keys its group table on every distinct probe
    key; when the first batch overflows the table, or (groups ~ rows)
    fills half of ``ballista.tpu.max_capacity``, both packages count
    ``tpu_fallback`` and ``join_fallback`` and rerun the unfolded shape on
    the device."""
    n, hi, m, cap, bail = BAIL_CASES[name]
    rng = np.random.default_rng(9)
    dim = pa.table({"dk": pa.array(np.arange(1, m + 1), pa.int64()),
                    "dv": pa.array(rng.uniform(0.5, 1.5, m)),
                    "dtag": pa.array(rng.integers(0, 25, m), pa.int32())})
    fact = pa.table({"fk": pa.array(rng.integers(1, hi, n), pa.int64()),
                     "v": pa.array(rng.uniform(0, 100, n))})
    sql = ("select fk, dtag, sum(v * dv) as s, count(*) as c "
           "from dim, fact where dk = fk group by fk, dtag")
    _, _, m_, _ = _three({"dim": dim, "fact": fact}, sql, **{
        "ballista.tpu.max_capacity": cap, "ballista.batch.size": 1 << 20,
        "ballista.shuffle.partitions": 1})
    assert m_.get("join_fallback", 0) == int(bail), m_
    assert m_.get("tpu_fallback", 0) == int(bail), m_
    assert m_.get("cpu_fallback", 0) == 0 and m_.get("highcard_fallback", 0) == 0, m_
    assert m_.get("device_time_ns", 0) > 0, m_


# ------------------------------------------------- star join and TPC-H q3
def _star(n: int = 100_000, m: int = 1000) -> dict:
    """``bench_suite.py:bench_starjoin``'s tables at a small size."""
    rng = np.random.default_rng(9)
    dim = pa.table({
        "dk": pa.array(np.arange(1, m + 1), pa.int64()),
        "dv": pa.array(rng.uniform(0.5, 1.5, m)),
        "dtag": pa.array(rng.integers(0, 25, m), pa.int32()),
    })
    fact = pa.table({
        "fk": pa.array(rng.integers(1, int(m * 1.2), n), pa.int64()),
        "g": pa.array(rng.integers(0, 8, n), pa.int32()),
        "v": pa.array(rng.uniform(0, 100, n)),
    })
    return {"dim": dim, "fact": fact}


STAR_SQL = ("select g, sum(v * dv) as s, count(*) as c "
            "from dim, fact where dk = fk group by g order by g")


def test_star_join_matches_jax_and_cpu():
    tst, _, m, _ = _three(_star(), STAR_SQL, **{
        "ballista.batch.size": 1 << 23, "ballista.shuffle.partitions": 1})
    assert [s.fused.join is not None for s in tst] == [True]
    assert m.get("dense_join", 0) == 1, m
    for k in ROUTE_KEYS[1:]:
        assert m.get(k, 0) == 0, (k, m)


def test_tpch_q3_folds_and_matches_jax_and_cpu():
    tables = {n: gen_table(n, 0.01) for n in ("lineitem", "orders", "customer")}
    tst, _, m, _ = _three(tables, QUERIES[3], parts=2)
    folded = [s for s in tst if s.fused.join is not None]
    assert len(folded) == 1, [str(s) for s in tst]
    assert [k for k, _ in folded[0]._group_plan] == ["enc", "build", "build"]
    assert folded[0]._device_build_cols == []  # build columns are group-only
    assert m.get("dense_join", 0) == 1, m
    for k in ROUTE_KEYS[1:]:
        assert m.get(k, 0) == 0, (k, m)


# ----------------------------------------------------------- distributed
@pytest.fixture(scope="module")
def parquet_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("join-parquet")
    tables = {n: gen_table(n, 0.01) for n in ("lineitem", "orders", "customer")}
    tables.update(_star())
    for name, tbl in tables.items():
        (d / name).mkdir()
        per = -(-tbl.num_rows // 2)
        for i in range(2):
            pq.write_table(tbl.slice(i * per, per), str(d / name / f"part-{i}.parquet"))
    return str(d)


@pytest.fixture(scope="module")
def clusters(parquet_dir):
    settings = {"ballista.mesh.enable": "false", "ballista.tpu.min_rows": "0"}
    port = tbt.BallistaContext.standalone(
        tbt.BallistaConfig(dict(settings)), num_executors=2, concurrent_tasks=2,
        device="cpu")
    ref = JBallistaContext.standalone(
        jbt.BallistaConfig(dict(settings)), num_executors=1, concurrent_tasks=2)
    local = tbt.SessionContext(tbt.BallistaConfig({"ballista.tpu.enable": "false"}),
                               device="cpu")
    try:
        for ctx in (port, ref, local):
            for name in ("lineitem", "orders", "customer", "dim", "fact"):
                ctx.register_parquet(name, os.path.join(parquet_dir, name))
        yield port, ref, local
    finally:
        port.close()
        ref.close()


def _job_stage_metrics(ctx, sql):
    before = set(ctx._job_ids)
    out = ctx.sql(sql).collect()
    (job_id,) = set(ctx._job_ids) - before
    scheduler, _ = ctx._standalone_handles
    detail = scheduler.server.state.task_manager.get_job_detail(job_id)
    sums: dict = {}
    for stage in detail["stages"]:
        for k, v in ((stage.get("metrics") or {}).get("TorchStageExec") or {}).items():
            if isinstance(v, (int, float)):
                sums[k] = sums.get(k, 0) + v
    return out, sums


@pytest.mark.parametrize("query", ["q3", "star"])
def test_distributed_join_stage_folds(clusters, query):
    """The join stage of the distributed plan reads both sides from
    shuffles; each task collects every partition of the build side (the
    reference's semantics) and probes on the device."""
    port, ref, local = clusters
    sql = QUERIES[3] if query == "q3" else STAR_SQL
    got, m = _job_stage_metrics(port, sql)
    _assert_equal(got, ref.sql(sql).collect(), f"{query} vs the JAX cluster")
    _assert_equal(got, local.sql(sql).collect(), f"{query} vs the CPU operators")
    assert m.get("dense_join", 0) >= 1, m
    for k in ROUTE_KEYS[1:]:
        assert m.get(k, 0) == 0, (k, m)
    assert m.get("join_build_time_ns", 0) > 0, m


def test_highcard_mode_device_keeps_the_group_table():
    """With ``ballista.tpu.highcard_mode=device`` a join-fused stage whose
    group key encodes on the device takes the keyed route in both packages
    and keeps the fold: the probe runs inside the keyed prep, no fallback,
    the same answer as the CPU operators."""
    n, hi, m = 200_000, 150_000, 100_000
    rng = np.random.default_rng(9)
    dim = pa.table({"dk": pa.array(np.arange(1, m + 1), pa.int64()),
                    "dv": pa.array(rng.uniform(0.5, 1.5, m))})
    fact = pa.table({"fk": pa.array(rng.integers(1, hi, n), pa.int64()),
                     "v": pa.array(rng.uniform(0, 100, n))})
    sql = "select fk, sum(v * dv) as s from dim, fact where dk = fk group by fk"
    extra = {"ballista.tpu.highcard_mode": "device", "ballista.batch.size": 1 << 20,
             "ballista.shuffle.partitions": 1}
    cpu = jbt.SessionContext(jbt.BallistaConfig(_settings(False, extra)))
    out = []
    for ctx, cls in (
        (tbt.SessionContext(tbt.BallistaConfig(_settings(True, extra)), device="cpu"),
         TorchStageExec),
        (jbt.SessionContext(jbt.BallistaConfig(_settings(True, extra))), TpuStageExec),
        (cpu, None),
    ):
        ctx.register_arrow_table("dim", dim)
        ctx.register_arrow_table("fact", fact)
        plan = ctx.sql(sql).physical_plan()
        out.append((ctx.execute(plan), _route(_stages(plan, cls))[1] if cls else None))
    (port, pm), (jax_, jm), (want, _) = out
    _assert_equal(port, want, "port")
    _assert_equal(jax_, want, "jax")
    for metrics in (pm, jm):
        assert metrics.get("keyed_path", 0) == 1, metrics
        assert metrics.get("dense_join", 0) == 1, metrics
        assert metrics.get("device_encode_batches", 0) >= 1, metrics
        for k in ROUTE_KEYS[1:]:
            assert metrics.get(k, 0) == 0, (k, metrics)
