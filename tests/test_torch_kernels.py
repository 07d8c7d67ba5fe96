"""The PyTorch port's kernels module against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX functions (run on the CPU
backend, x64, scatter route — how the JAX package's own tests run them)
and through their counterparts in ``arrow_ballista_tpu_torch.ops.kernels``
on ``device="cpu"``, where the segment aggregate runs its plain PyTorch
twin.  Tolerance, as ``tests/test_tpu_stage.py:_assert_tables_equal``
sets it: floats within rel 1e-9 (sums add in different orders), everything
else exact — min/max bit for bit, NaN and the sign of zero included.
"""

import dataclasses
import datetime

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from arrow_ballista_tpu.exec import expressions as jpe
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu_torch.exec import expressions as tpe
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops.bridge import DeviceStaging

REL = 1e-9
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _jax_x64_scatter():
    """Pin the JAX reference to its CPU configuration for these tests."""
    old = JK._PRECISION["mode"]
    JK.set_precision("x64")
    JK.set_agg_algorithm("scatter")
    try:
        yield
    finally:
        JK.set_agg_algorithm(None)
        JK._PRECISION["mode"] = old


# ---------------------------------------------------------------- helpers
def _assert_same(want, got, exact: bool, what: str = ""):
    """Elementwise: NaN matches NaN; floats within REL unless ``exact``,
    where the bits must agree (so -0.0 != +0.0)."""
    want = np.asarray(want)
    got = np.asarray(got)
    assert want.shape == got.shape, what
    if want.dtype.kind == "f" or got.dtype.kind == "f":
        w = want.astype(np.float64)
        g = got.astype(np.float64)
        assert np.array_equal(np.isnan(w), np.isnan(g)), what
        ok = ~np.isnan(w)
        if exact:
            assert np.array_equal(w[ok].view(np.int64), g[ok].view(np.int64)), what
        else:
            np.testing.assert_allclose(g[ok], w[ok], rtol=REL, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _run_jax(expr, batch):
    comp = JK.JaxExprCompiler(batch.schema)
    closure = comp._lower_or_leaf(expr)
    # as jax arrays, the closures run XLA's semantics, as inside the kernel
    env = {
        k: jnp.asarray(a)
        for k, a in JK.build_env(batch, comp.leaves, batch.num_rows).items()
    }
    v, val = closure(env)
    return v, val


def _run_torch(expr, batch):
    comp = TK.TorchExprCompiler(batch.schema)
    closure = comp._lower_or_leaf(expr)
    env = DeviceStaging(CPU).put(TK.build_env(batch, comp.leaves, batch.num_rows))
    env[TK.DEVICE] = CPU
    v, val = closure(env)
    return v, val


def _bcast(x, n):
    x = np.asarray(x)
    return np.broadcast_to(x, (n,)) if x.ndim == 0 else x


def _flush_subnormals(x: np.ndarray) -> np.ndarray:
    """``x`` with each subnormal float replaced by a zero of its sign, as
    XLA on the CPU returns it (ROADMAP C, "Subnormals": the reference's
    closures flush subnormal results, the port and the CPU operators keep
    them)."""
    if x.dtype.kind != "f":
        return x
    sub = (x != 0) & (np.abs(x) < np.finfo(x.dtype).tiny)
    return np.where(sub, np.copysign(np.zeros_like(x), x), x)


def _check_expr(build, batch, exact=False):
    """Lower ``build(pe)`` with both compilers over ``batch`` and compare
    values and validity row by row.  The port's subnormal results are
    compared as the reference's flushed zeros."""
    n = batch.num_rows
    jv, jval = _run_jax(build(jpe), batch)
    tv, tval = _run_torch(build(tpe), batch)
    jv = _bcast(np.asarray(jv), n)
    tv = _flush_subnormals(_bcast(tv.numpy(), n))
    if jv.dtype == bool or tv.dtype == bool:
        np.testing.assert_array_equal(tv.astype(bool), jv.astype(bool))
    else:
        _assert_same(jv, tv, exact)
    jvalid = np.ones(n, bool) if jval is None else _bcast(np.asarray(jval), n)
    tvalid = np.ones(n, bool) if tval is None else _bcast(tval.numpy(), n)
    np.testing.assert_array_equal(tvalid, jvalid)


def _batch(**cols) -> pa.RecordBatch:
    return pa.RecordBatch.from_pydict(cols)


def _col(pe, batch, name):
    return pe.Col(batch.schema.get_field_index(name), name)


# ------------------------------------------------- expression compiler
_INTS = _batch(
    a=pa.array([7, -7, 7, -7, 5, 0, None, 2**40, -3, 9], pa.int64()),
    b=pa.array([2, 2, -2, -2, 0, 3, 4, 3, None, 0], pa.int64()),
    x=pa.array([0.5, 1.5, 2.5, -0.5, -1.5, None, -0.0, 1e30, float("nan"), 3.25]),
    y=pa.array([2.0, 0.0, -3.0, 0.5, None, 1.0, 2.0, 0.0, 1.0, -0.0]),
    s=pa.array(["1-URGENT", "2-HIGH", None, "3", "4", "5", "1-URGENT", "x", "y", "z"]),
    i32=pa.array([1, 2, 3, None, -5, 6, 7, 8, 9, 10], pa.int32()),
    f32=pa.array([1.5, None, -2.25, 4.0, 0.0, 1.0, 2.0, 3.0, 4.0, 5.0], pa.float32()),
)


def _bin(op, l, r):
    return lambda pe: pe.Binary(_col(pe, _INTS, l), op, _col(pe, _INTS, r))


EXPR_CASES = {
    # SQL integer `/` truncates toward zero; a zero divisor is guarded
    "int_div_trunc_zero_divisor": _bin("/", "a", "b"),
    "float_div_by_zero": _bin("/", "x", "y"),
    "int_float_div": _bin("/", "a", "y"),
    # `%` is floor modulo; an integer zero divisor gives 0
    "int_mod_floor_zero_divisor": _bin("%", "a", "b"),
    "float_mod": _bin("%", "x", "y"),
    "add_int": _bin("+", "a", "b"),
    "sub_mixed": _bin("-", "a", "x"),
    "mul_float": _bin("*", "x", "y"),
    "i32_times_i64": _bin("*", "i32", "a"),
    "f32_plus_f64": _bin("+", "f32", "x"),
    "lt": _bin("<", "x", "y"),
    "eq_int": _bin("=", "a", "b"),
    "ge_mixed": _bin(">=", "a", "x"),
    # half-to-even in both
    "round_half_even": lambda pe: pe.ScalarFn("round", (_col(pe, _INTS, "x"),)),
    "negative": lambda pe: pe.Negative(_col(pe, _INTS, "a")),
    "not_and_or_nulls": lambda pe: pe.Not(
        pe.Binary(
            pe.Binary(_col(pe, _INTS, "a"), ">", pe.Lit(0)),
            "OR",
            pe.Binary(_col(pe, _INTS, "y"), "<", pe.Lit(1.0)),
        )
    ),
    "and_nulls": lambda pe: pe.Binary(
        pe.Binary(_col(pe, _INTS, "a"), ">", pe.Lit(0)),
        "AND",
        pe.Binary(_col(pe, _INTS, "b"), "<", pe.Lit(3)),
    ),
    "is_null": lambda pe: pe.IsNull(_col(pe, _INTS, "x")),
    "is_not_null": lambda pe: pe.IsNull(_col(pe, _INTS, "b"), negated=True),
    "is_null_of_literal": lambda pe: pe.IsNull(pe.Lit(1)),
    "in_int_exact_above_2_53": lambda pe: pe.InList(
        _col(pe, _INTS, "a"), (2**40, 5, -7, 2**53 + 1)
    ),
    "not_in_float": lambda pe: pe.InList(_col(pe, _INTS, "x"), (0.5, 2.5), True),
    "case_else": lambda pe: pe.Case(
        (
            (pe.Binary(_col(pe, _INTS, "a"), ">", pe.Lit(0)), _col(pe, _INTS, "x")),
            (pe.Binary(_col(pe, _INTS, "b"), "=", pe.Lit(2)), pe.Lit(1.0)),
        ),
        _col(pe, _INTS, "y"),
        pa.float64(),
    ),
    "case_no_else_int": lambda pe: pe.Case(
        ((pe.Binary(_col(pe, _INTS, "b"), ">", pe.Lit(1)), _col(pe, _INTS, "a")),),
        None,
        pa.int64(),
    ),
    # the string comparison is a host (cpu_expr) leaf; the CASE stays on device
    "case_over_string_leaf": lambda pe: pe.Case(
        (
            (
                pe.Binary(_col(pe, _INTS, "s"), "=", pe.Lit("1-URGENT")),
                pe.Lit(1),
            ),
        ),
        pe.Lit(0),
        pa.int64(),
    ),
    "cast_float_to_int_saturates": lambda pe: pe.Cast(
        _col(pe, _INTS, "x"), pa.int64()
    ),
    "cast_int_to_float": lambda pe: pe.Cast(_col(pe, _INTS, "a"), pa.float64()),
    "cast_to_bool": lambda pe: pe.Cast(_col(pe, _INTS, "b"), pa.bool_()),
    "power": lambda pe: pe.ScalarFn(
        "power", (_col(pe, _INTS, "y"), _col(pe, _INTS, "x"))
    ),
}
for _fn in ("abs", "sqrt", "exp", "ln", "log10", "log2", "ceil", "floor",
            "sin", "cos", "tan", "signum"):
    EXPR_CASES[f"fn_{_fn}"] = (
        lambda fn: lambda pe: pe.ScalarFn(fn, (_col(pe, _INTS, "x"),))
    )(_fn)


@pytest.mark.parametrize("name", sorted(EXPR_CASES))
def test_expr_compiler_matches_jax(name):
    _check_expr(EXPR_CASES[name], _INTS)


def test_date_leaves_and_literals_are_int64_days():
    days = [0, 9000, 10471, None, 10472, -5]
    batch = _batch(d=pa.array(days, pa.date32()))
    lit = datetime.date(1998, 9, 2)  # day 10471
    for op in ("<=", ">", "="):
        _check_expr(
            lambda pe, op=op: pe.Binary(_col(pe, batch, "d"), op, pe.Lit(lit)), batch
        )
    comp = TK.TorchExprCompiler(batch.schema)
    closure = comp._lower(tpe.Col(0, "d"))
    env = DeviceStaging(CPU).put(TK.build_env(batch, comp.leaves, 6))
    v, _ = closure(env)
    assert v.dtype == torch.int64
    assert v.tolist()[:3] == [0, 9000, 10471]


def test_strings_never_reach_the_device():
    comp = TK.TorchExprCompiler(_INTS.schema)
    with pytest.raises(TK.NotLowerable):
        comp._lower(tpe.Col(_INTS.schema.get_field_index("s"), "s"))
    comp._lower_or_leaf(
        tpe.Binary(tpe.Col(_INTS.schema.get_field_index("s"), "s"), "=", tpe.Lit("x"))
    )
    assert [s.kind for s in comp.leaves.values()] == ["cpu_expr"]


@settings(max_examples=30, deadline=None)
@given(
    st.lists(st.integers(-(10**6), 10**6), min_size=4, max_size=4),
    st.lists(st.integers(-50, 50), min_size=4, max_size=4),
    # XLA on the CPU flushes subnormals to zero; torch keeps them
    st.lists(
        st.floats(-1e6, 1e6, allow_nan=False, allow_infinity=False,
                  allow_subnormal=False),
        min_size=4, max_size=4,
    ),
    st.sampled_from(["+", "-", "*", "/", "%", "<", "=", ">="]),
)
# the smallest normal f64 over 2 is subnormal: XLA flushes that quotient
@example(a=[0, 0, 0, 0], b=[0, 2, 0, 0],
         x=[0.0, 2.2250738585072014e-308, 0.0, 0.0], op="/")
def test_expr_compiler_binary_ops_property(a, b, x, op):
    batch = _batch(a=pa.array(a, pa.int64()), b=pa.array(b, pa.int64()),
                   x=pa.array(x, pa.float64()))
    for l, r in (("a", "b"), ("a", "x"), ("x", "b")):
        _check_expr(
            lambda pe, l=l, r=r: pe.Binary(
                _col(pe, batch, l), op, _col(pe, batch, r)
            ),
            batch,
        )


def test_subnormal_quotient_kept_like_the_cpu_operators():
    """The port keeps a subnormal result, as numpy and the CPU operators do
    (the reference's closures flush it to zero)."""
    batch = _batch(x=pa.array([2.2250738585072014e-308, -4e-308], pa.float64()),
                   b=pa.array([2, 4], pa.int64()))
    v, _ = _run_torch(tpe.Binary(_col(tpe, batch, "x"), "/", _col(tpe, batch, "b")), batch)
    want = np.array([2.2250738585072014e-308, -4e-308]) / np.array([2.0, 4.0])
    assert np.array_equal(v.numpy().view(np.int64), want.view(np.int64))
    assert (np.abs(want) < np.finfo(np.float64).tiny).all()


# ---------------------------------------------------- partial aggregate
def _agg_fixture(capacity: int, seed: int = 7):
    """Seeded rows with nulls, NaN, ±0.0 and an all-masked group."""
    rng = np.random.default_rng(seed + capacity)
    n = 3000
    v = rng.normal(0, 100, n)
    v[rng.random(n) < 0.05] = np.nan
    v_null = rng.random(n) < 0.1
    i = rng.integers(-(10**12), 10**12, n)
    i_null = rng.random(n) < 0.1
    k = rng.uniform(-1, 1, n)
    k_null = rng.random(n) < 0.05
    gid = rng.integers(0, capacity, n).astype(np.int32)
    if capacity > 2:
        zeros = gid == 1  # a group of signed zeros only
        v[zeros] = np.where(rng.random(zeros.sum()) < 0.5, -0.0, 0.0)
        v_null[zeros] = False
        k[gid == capacity - 1] = -1.0  # every row filtered out
    else:
        v[:4] = [-0.0, 0.0, 0.0, -0.0]
    batch = pa.RecordBatch.from_pydict(
        {
            "v": pa.array(v, pa.float64(), mask=v_null),
            "i": pa.array(i, pa.int64(), mask=i_null),
            "k": pa.array(k, pa.float64(), mask=k_null),
        }
    )
    valid = np.arange(n) < n - 37  # padded tail rows
    return batch, gid, valid


_AGGS = [
    # (func, arg column or None, int_minmax)
    ("count_star", None, False),
    ("count", "v", False),
    ("sum", "v", False),
    ("avg", "v", False),
    ("min", "v", False),
    ("max", "v", False),
    ("sum", "i", False),
    ("min", "i", True),
    ("max", "i", True),
]


def _agg_setup(pe, K, compiler_cls, batch):
    comp = compiler_cls(batch.schema)
    filt = comp._lower_or_leaf(
        pe.Binary(pe.Col(2, "k"), ">", pe.Lit(-0.5))
    )
    specs, closures = [], []
    for func, arg, int_mm in _AGGS:
        if arg is None:
            specs.append(K.KernelAggSpec("count_star", False))
            closures.append(None)
            continue
        col = pe.Col(batch.schema.get_field_index(arg), arg)
        # count(col) reads only the validity, as the stage compiles it
        c = comp.validity_only(col) if func == "count" else comp._lower(col)
        specs.append(K.KernelAggSpec(func, True, int_minmax=int_mm))
        closures.append(c)
    return comp, filt, specs, closures


def _jax_states(batch, gid, valid, capacity):
    comp, filt, specs, closures = _agg_setup(jpe, JK, JK.JaxExprCompiler, batch)
    names = JK.flat_arg_names(comp.leaves)
    env = JK.build_env(batch, comp.leaves, batch.num_rows)
    fn = JK.make_partial_agg_kernel(filt, closures, specs, capacity, names)
    out = fn(gid, valid, *[env[nm] for nm in names])
    return specs, [np.asarray(a) for a in out]


def _torch_state(batch, gid, valid, capacity, state=None):
    comp, filt, specs, closures = _agg_setup(tpe, TK, TK.TorchExprCompiler, batch)
    names = TK.flat_arg_names(comp.leaves)
    env = DeviceStaging(CPU).put(TK.build_env(batch, comp.leaves, batch.num_rows))
    fn = TK.make_partial_agg_kernel(filt, closures, specs, capacity, names)
    out = fn(
        torch.from_numpy(gid), torch.from_numpy(valid),
        *[env[nm] for nm in names], state=state,
    )
    return specs, out


def _compare_states(jspecs, jstates, tspecs, host):
    roles = [r for s in jspecs for r in JK.state_fields(s, "x64")] + ["add"]
    assert len(host) == len(jstates) == len(roles)
    for f, (want, got, role) in enumerate(zip(jstates, host, roles)):
        _assert_same(want, got, exact=role != "add", what=f"field {f} ({role})")


@pytest.mark.parametrize("capacity", [1, 7, 64, 4096])
def test_partial_agg_matches_jax(capacity):
    batch, gid, valid = _agg_fixture(capacity)
    jspecs, jstates = _jax_states(batch, gid, valid, capacity)
    tspecs, state = _torch_state(batch, gid, valid, capacity)
    assert state.dtype == torch.int64 and state.shape == (len(jstates), capacity)
    host = TK.unpack_host(tspecs, TK.fetch_states(state))
    _compare_states(jspecs, jstates, tspecs, host)
    if capacity > 2:
        presence = host[-1]
        assert presence[capacity - 1] == 0  # all-masked group stays empty
        mn = host[[r for s in tspecs for r in TK.state_fields(s)].index("min")]
        assert np.signbit(mn[1]) or np.isnan(mn[1])


def test_partial_agg_accumulates_into_running_state():
    """Two batches into one state equal JAX's kernel + combine_states."""
    cap = 64
    b1, g1, v1 = _agg_fixture(cap, seed=1)
    b2, g2, v2 = _agg_fixture(cap, seed=2)
    jspecs, s1 = _jax_states(b1, g1, v1, cap)
    _, s2 = _jax_states(b2, g2, v2, cap)
    want = [np.asarray(a) for a in JK.combine_states(jspecs, tuple(s1), tuple(s2), "x64")]
    tspecs, state = _torch_state(b1, g1, v1, cap)
    _, state = _torch_state(b2, g2, v2, cap, state=state)
    _compare_states(jspecs, want, tspecs, TK.unpack_host(tspecs, TK.fetch_states(state)))


def _computed_arg_states(pe, K, compiler_cls, batch, run):
    """avg(a+1), sum(x*y), avg(b+1): two integer expressions, each cast to
    f64 for its avg, with a float sum between them."""
    comp = compiler_cls(batch.schema)
    args = [
        pe.Binary(_col(pe, batch, "a"), "+", pe.Lit(1)),
        pe.Binary(_col(pe, batch, "x"), "*", _col(pe, batch, "y")),
        pe.Binary(_col(pe, batch, "b"), "+", pe.Lit(1)),
    ]
    closures = [comp._lower(e) for e in args]
    specs = [K.KernelAggSpec(f, True) for f in ("avg", "sum", "avg")]
    names = K.flat_arg_names(comp.leaves)
    fn = K.make_partial_agg_kernel(None, closures, specs, 7, names)
    return specs, run(fn, K.build_env(batch, comp.leaves, batch.num_rows), names)


def test_partial_agg_distinct_computed_int_args():
    """Each aggregate reads its own argument: a converted temporary of one
    aggregate is never handed to another."""
    rng = np.random.default_rng(21)
    n = 2000
    batch = _batch(
        a=pa.array(rng.integers(0, 1000, n), pa.int64()),
        b=pa.array(rng.integers(10**6, 2 * 10**6, n), pa.int64()),
        x=pa.array(rng.normal(0, 1, n), pa.float64()),
        y=pa.array(rng.normal(0, 1, n), pa.float64()),
    )
    gid = rng.integers(0, 7, n).astype(np.int32)
    valid = np.ones(n, bool)

    def run_jax(fn, env, names):
        return [np.asarray(a) for a in fn(gid, valid, *[env[nm] for nm in names])]

    def run_torch(fn, env, names):
        env = DeviceStaging(CPU).put(env)
        out = fn(torch.from_numpy(gid), torch.from_numpy(valid),
                 *[env[nm] for nm in names])
        return TK.unpack_host(tspecs, TK.fetch_states(out))

    jspecs, want = _computed_arg_states(jpe, JK, JK.JaxExprCompiler, batch, run_jax)
    tspecs = [TK.KernelAggSpec(f, True) for f in ("avg", "sum", "avg")]
    _, got = _computed_arg_states(tpe, TK, TK.TorchExprCompiler, batch, run_torch)
    _compare_states(jspecs, want, tspecs, got)
    b_sum = np.bincount(gid, weights=batch.column("b").to_numpy() + 1, minlength=7)
    np.testing.assert_allclose(got[4], b_sum, rtol=REL)


# ------------------------------------------------------- state handling
def _spec_dicts(specs):
    return [dataclasses.asdict(s) for s in specs]


def test_combine_states_matches_jax():
    cap = 64
    b1, g1, v1 = _agg_fixture(cap, seed=3)
    b2, g2, v2 = _agg_fixture(cap, seed=4)
    jspecs, s1 = _jax_states(b1, g1, v1, cap)
    _, s2 = _jax_states(b2, g2, v2, cap)
    # signed zeros meet across states too
    fields = [r for s in jspecs for r in JK.state_fields(s, "x64")]
    for role in ("min", "max"):
        f = fields.index(role)
        s1[f] = s1[f].copy()
        s2[f] = s2[f].copy()
        s1[f][:4] = [0.0, -0.0, np.nan, -0.0]
        s2[f][:4] = [-0.0, 0.0, 1.0, -0.0]
    want = JK.combine_states(jspecs, tuple(s1), tuple(s2), "x64")
    dicts = _spec_dicts(jspecs)
    tspecs = TK.specs_from_dicts(dicts)
    got = TK.combine_states(
        tspecs,
        TK.states_from_numpy(dicts, s1, CPU),
        TK.states_from_numpy(dicts, s2, CPU),
    )
    _compare_states(
        jspecs, [np.asarray(a) for a in want], tspecs,
        TK.unpack_host(tspecs, TK.fetch_states(got)),
    )


@pytest.mark.parametrize("new_cap", [64, 256, 4096])
def test_pad_states_matches_jax(new_cap):
    cap = 64
    batch, gid, valid = _agg_fixture(cap, seed=5)
    jspecs, s = _jax_states(batch, gid, valid, cap)
    want = JK.pad_states(jspecs, tuple(s), new_cap, "x64")
    dicts = _spec_dicts(jspecs)
    tspecs = TK.specs_from_dicts(dicts)
    got = TK.pad_states(tspecs, TK.states_from_numpy(dicts, s, CPU), new_cap)
    assert got.shape == (len(s), new_cap)
    _compare_states(
        jspecs, [np.asarray(a) for a in want], tspecs,
        TK.unpack_host(tspecs, TK.fetch_states(got)),
    )


@pytest.mark.parametrize("keep", [None, 64, 17])
def test_fetch_and_unpack_match_jax_packed_fetch(keep):
    cap = 64
    batch, gid, valid = _agg_fixture(cap, seed=6)
    jspecs, s = _jax_states(batch, gid, valid, cap)
    packed = np.asarray(JK.pack_for_fetch(jspecs, tuple(s), "x64", keep=keep))
    want = JK.unpack_host(jspecs, packed, "x64")
    dicts = _spec_dicts(jspecs)
    tspecs = TK.specs_from_dicts(dicts)
    fetched = TK.fetch_states(TK.states_from_numpy(dicts, s, CPU), keep)
    np.testing.assert_array_equal(fetched, packed)  # same packed layout
    _compare_states(jspecs, want, tspecs, TK.unpack_host(tspecs, fetched))


def test_states_from_numpy_rejects_a_wrong_layout():
    specs = [JK.KernelAggSpec("sum", True)]
    with pytest.raises(ValueError):
        TK.states_from_numpy(_spec_dicts(specs), [np.zeros(4)], CPU)
    with pytest.raises(ValueError):  # sum field must be float
        TK.states_from_numpy(
            _spec_dicts(specs), [np.zeros(4, np.int64)] * 3, CPU
        )


def test_int_sum_exact_past_2_53():
    """The port's integer sum accumulates in int64: exact where the
    reference's f64 sum rounds (the kernel phase checks the CUDA kernel
    against this twin on the card)."""
    rng = np.random.default_rng(3)
    n, cap = 5000, 7
    vals = rng.integers(2**53, 2**60, n)
    gid = rng.integers(0, cap, n).astype(np.int32)
    state = TK.init_states([TK.KernelAggSpec("sum", True, int_sum=True)], cap, CPU)
    TK.segment_agg(
        torch.from_numpy(gid), None, None, None, [torch.from_numpy(vals)], [None],
        [TK.OP_ADD_I64, TK.OP_COUNT, TK.OP_COUNT], [0, 0, -1], state,
    )
    want = np.zeros(cap, np.int64)
    np.add.at(want, gid, vals)  # wraps like int64, exactly
    np.testing.assert_array_equal(state[0].numpy(), want)
    np.testing.assert_array_equal(state[2].numpy(), np.bincount(gid, minlength=cap))


def test_twin_extremum_signed_zero_and_nan():
    v = torch.tensor([0.0, -0.0, 5.0, -0.0, 0.0, 1.0, float("nan"), 2.0], dtype=torch.float64)
    g = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3], dtype=torch.int32)
    for func, op, want in (
        ("min", TK.OP_MIN_F64, [-0.0, -0.0, 0.0, np.nan]),
        ("max", TK.OP_MAX_F64, [0.0, 5.0, 1.0, np.nan]),
    ):
        state = TK.init_states([TK.KernelAggSpec(func, True)], 4, CPU)
        TK.segment_agg(g, None, None, None, [v], [None], [op, 0, 0], [0, 0, -1], state)
        _assert_same(np.array(want), state[0].view(torch.float64).numpy(), exact=True)


def test_cpu_tensors_take_the_twin():
    """On CPU tensors the dispatch runs the plain twin; no kernel's launch
    count moves."""
    before = dict(TK.LAUNCHES)
    state = TK.init_states([TK.KernelAggSpec("count_star", False)], 3, CPU)
    TK.segment_agg(
        torch.tensor([0, 2, 2], dtype=torch.int32), None, None, None, [], [],
        [TK.OP_COUNT, TK.OP_COUNT], [-1, -1], state,
    )
    assert state.tolist() == [[1, 0, 2], [1, 0, 2]]
    assert TK.LAUNCHES == before


def test_bucket_rows_and_pad_match_jax():
    for n in (0, 1, 1000, 1025, 1 << 20, (1 << 20) + 1):
        assert TK.bucket_rows(n) == JK.bucket_rows(n)
    x = np.arange(5, dtype=np.int64)
    np.testing.assert_array_equal(TK._pad(x, 8), JK._pad(x, 8))


def test_coerce_host_values_widens_to_x64():
    assert TK.coerce_host_values(np.arange(3, dtype=np.int32)).dtype == np.int64
    assert TK.coerce_host_values(np.ones(3, np.float32)).dtype == np.float64
    assert TK.coerce_host_values(np.ones(3, bool)).dtype == bool
    from arrow_ballista_tpu_torch.errors import ExecutionError

    with pytest.raises(ExecutionError):
        TK.coerce_host_values(np.array([2**63], np.uint64))
