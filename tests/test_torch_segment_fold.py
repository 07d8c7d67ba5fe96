"""The segment aggregate's fold map (``ops/kernels.py:segment_fold_map``)
on the CPU.

B1 and B13a fold each distinct (op, column) of a stage's state once and
store it to every field that takes it; a count's fold is its column's
validity, or the row mask where the column has none.  These tests hold
the map to the per-field plain twin (folding only the distinct folds and
copying them out gives the twin's state bit for bit) and to the JAX
package's ``make_partial_agg_kernel`` scatter route at q1's layout (f64
sums within rel 1e-9, everything else exact), over batches with NaN,
-0.0 and nulls.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from arrow_ballista_tpu.exec import expressions as jpe
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu_torch.exec import expressions as tpe
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops.bridge import DeviceStaging

REL = 1e-9
CPU = torch.device("cpu")
# q1's stage as the kernels get it: sum and count of four columns, of
# three of them again for the averages, count(*) and presence
Q1_OPS = [TK.OP_ADD_F64, TK.OP_COUNT] * 7 + [TK.OP_COUNT] * 2
Q1_COLS = [0, 0, 1, 1, 2, 2, 3, 3, 0, 0, 1, 1, 4, 4, -1, -1]


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


def _batch(n: int, seed: int, cap: int, nulls: bool) -> tuple:
    """q1-like rows (quantity, price, discount, tax, a filter column) with
    NaN, -0.0 and, where ``nulls``, null quantities and taxes; the group
    ids and the tail mask."""
    rng = np.random.default_rng(seed)
    q = rng.integers(1, 51, n).astype(np.float64)
    p = rng.uniform(900.0, 1e5, n)
    d = rng.integers(0, 11, n) / 100.0
    t = rng.integers(0, 9, n) / 100.0
    k = rng.uniform(0.0, 1.0, n)
    gid = rng.integers(0, cap, n).astype(np.int32)
    q[rng.random(n) < 0.01] = np.nan
    p[:6] = [-0.0, 0.0, -0.0, np.nan, 0.0, -0.0]
    if cap >= 4:
        zeros = gid == 1  # a group of signed zeros only
        p[zeros] = np.where(rng.random(int(zeros.sum())) < 0.5, -0.0, 0.0)
        k[gid == cap - 1] = 0.99  # every row of the last group filtered out
    q_null = rng.random(n) < (0.1 if nulls else 0.0)
    t_null = rng.random(n) < (0.05 if nulls else 0.0)
    batch = pa.RecordBatch.from_pydict({
        "q": pa.array(q, pa.float64(), mask=q_null),
        "p": pa.array(p, pa.float64()),
        "d": pa.array(d, pa.float64()),
        "t": pa.array(t, pa.float64(), mask=t_null),
        "k": pa.array(k, pa.float64()),
        "i": pa.array(rng.integers(-(2**62), 2**62, n), pa.int64()),
    })
    return batch, gid, np.arange(n) < n - 5


def _col(pe, batch, name):
    return pe.Col(batch.schema.get_field_index(name), name)


def _q1_aggs(pe, batch):
    """q1's aggregates: (func, argument key, expression, int_minmax)."""
    q, p, d, t = (_col(pe, batch, c) for c in "qpdt")
    disc = pe.Binary(p, "*", pe.Binary(pe.Lit(1.0), "-", d))
    charge = pe.Binary(disc, "*", pe.Binary(pe.Lit(1.0), "+", t))
    return [("sum", "q", q, False), ("sum", "p", p, False), ("sum", "disc", disc, False),
            ("sum", "charge", charge, False), ("avg", "q", q, False), ("avg", "p", p, False),
            ("avg", "d", d, False), ("count_star", None, None, False)]


def _every_op_aggs(pe, batch):
    """Every op, some twice: counts of one validity, a repeated min."""
    q, p, i = (_col(pe, batch, c) for c in "qpi")
    return [("count", "q", q, False), ("sum", "q", q, False), ("avg", "q", q, False),
            ("min", "q", q, False), ("max", "q", q, False), ("min", "q", q, False),
            ("max", "p", p, False), ("min", "i", i, True), ("max", "i", i, True),
            ("count_star", None, None, False), ("count", "p", p, False)]


AGGS = {"q1": _q1_aggs, "every op": _every_op_aggs}


def _setup(pe, K, compiler_cls, batch, aggs):
    """(comp, filter closure, specs, one closure per aggregate: the same
    object for the same argument, as the stage compiles them)."""
    comp = compiler_cls(batch.schema)
    filt = comp._lower_or_leaf(pe.Binary(_col(pe, batch, "k"), "<", pe.Lit(0.95)))
    specs, closures, by_key = [], [], {}
    for func, key, expr, int_mm in aggs(pe, batch):
        if func == "count_star":
            specs.append(K.KernelAggSpec("count_star", False))
            closures.append(None)
            continue
        if func == "count":
            c = by_key.setdefault(("count", key), comp.validity_only(expr))
        else:
            c = by_key.setdefault(key, comp._lower(expr))
        specs.append(K.KernelAggSpec(func, True, int_minmax=int_mm))
        closures.append(c)
    return comp, filt, specs, closures


def _torch_call(batch, gid, tail, aggs) -> tuple:
    """The port's B1 call for ``batch``: ``(specs, args, ops, cols)`` with
    ``args`` = (gid, tail, pred, pvalid, values, valids)."""
    comp, filt, specs, closures = _setup(tpe, TK, TK.TorchExprCompiler, batch, aggs)
    distinct, columns, ops, cols = TK._agg_layout(specs, closures)
    env = DeviceStaging(CPU).put(TK.build_env(batch, comp.leaves, batch.num_rows))
    program = TK.ExprProgram(filt, distinct, columns)
    pred, pvalid, values, valids = TK.expr_eval(program, env, batch.num_rows, CPU)
    args = (torch.from_numpy(gid), torch.from_numpy(tail), pred, pvalid, values, valids)
    return specs, args, ops, cols


def _fold_copied(specs, entries, ops, cols, cap: int) -> torch.Tensor:
    """Each distinct fold folded once by the twin (from its first field's
    identity), then copied out to every field that takes it."""
    fold_ops, fold_cols, field_fold = TK.segment_fold_map(ops, cols, [e[5] for e in entries])
    first = [field_fold.index(k) for k in range(len(fold_ops))]
    folds = TK.init_states(specs, cap, CPU)[first].clone()
    for e in entries:
        TK.segment_agg_reference(*e, list(fold_ops), list(fold_cols), folds)
    return folds[list(field_fold)]


def test_q1_layout_maps_to_its_distinct_folds():
    """q1's 16 fields: 5 distinct f64 sums and one count of the row mask;
    a null-bearing column keeps its own count fold."""
    batch, _gid, _tail = _batch(100, 0, 4, nulls=False)
    _specs, _args, ops, cols = _torch_call(batch, _gid, _tail, _q1_aggs)
    assert (ops, cols) == (Q1_OPS, Q1_COLS)
    fold_ops, fold_cols, field_fold = TK.segment_fold_map(ops, cols, ([None] * 5,))
    assert fold_ops == (TK.OP_ADD_F64, TK.OP_COUNT) + (TK.OP_ADD_F64,) * 4
    assert fold_cols == (0, -1, 1, 2, 3, 4)
    assert field_fold == (0, 1, 2, 1, 3, 1, 4, 1, 0, 1, 2, 1, 5, 1, 1, 1)
    valid = torch.ones(4, dtype=torch.bool)
    fold_ops, fold_cols, field_fold = TK.segment_fold_map(
        ops, cols, ([None, valid, None, None, None],))
    assert fold_cols == (0, -1, 1, 1, 2, 3, 4)
    assert [fold_cols[k] for k in field_fold[2:4]] == [1, 1]  # sum(p), count(p)
    # over entries: a column counts its validity when any entry has one
    fold_ops, fold_cols, _ = TK.segment_fold_map(
        ops, cols, ([None] * 5, [None, valid, None, None, None]))
    assert fold_cols == (0, -1, 1, 1, 2, 3, 4)


@pytest.mark.parametrize("cap", [1, 4, 64])
@pytest.mark.parametrize("layout", sorted(AGGS))
@pytest.mark.parametrize("nulls", [False, True], ids=["no_nulls", "nulls"])
def test_distinct_folds_copied_out_equal_the_twin(layout, cap, nulls):
    batch, gid, tail = _batch(3000, 11 + cap, cap, nulls)
    specs, args, ops, cols = _torch_call(batch, gid, tail, AGGS[layout])
    want = TK.segment_agg_reference(*args, ops, cols, TK.init_states(specs, cap, CPU))
    got = _fold_copied(specs, [args], ops, cols, cap)
    assert torch.equal(got, want)
    assert len(TK.segment_fold_map(ops, cols, [args[5]])[0]) < len(ops)


def test_distinct_folds_over_entries_equal_the_twin():
    """Three entries, one without nulls: the entries' fold map, each fold
    folded once over every entry, copied out, is the per-field twin."""
    cap = 64
    parts = [_batch(n, 40 + j, cap, nulls=j != 1) for j, n in enumerate((2000, 777, 1500))]
    calls = [_torch_call(b, g, t, _every_op_aggs) for b, g, t in parts]
    specs, _args, ops, cols = calls[0]
    entries = [c[1] for c in calls]
    want = TK.segment_agg_entries_reference(entries, ops, cols, TK.init_states(specs, cap, CPU))
    assert torch.equal(_fold_copied(specs, entries, ops, cols, cap), want)


def _jax_states(batch, gid, tail, cap: int, aggs) -> tuple:
    comp, filt, specs, closures = _setup(jpe, JK, JK.JaxExprCompiler, batch, aggs)
    names = JK.flat_arg_names(comp.leaves)
    env = JK.build_env(batch, comp.leaves, batch.num_rows)
    fn = JK.make_partial_agg_kernel(filt, closures, specs, cap, names)
    return specs, [np.asarray(a) for a in fn(gid, tail, *[env[nm] for nm in names])]


def _assert_same(want, got, exact: bool, what: str):
    """NaN matches NaN; floats within REL unless ``exact`` (bits, the sign
    of zero included)."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, what
    if want.dtype.kind == "f" or got.dtype.kind == "f":
        w, g = want.astype(np.float64), got.astype(np.float64)
        assert np.array_equal(np.isnan(w), np.isnan(g)), what
        ok = ~np.isnan(w)
        if exact:
            assert np.array_equal(w[ok].view(np.int64), g[ok].view(np.int64)), what
        else:
            np.testing.assert_allclose(g[ok], w[ok], rtol=REL, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("cap", [4, 64])
@pytest.mark.parametrize("layout", sorted(AGGS))
def test_distinct_folds_equal_the_jax_scatter_route(layout, cap):
    """The distinct folds copied out against the JAX package's scatter
    route (``make_partial_agg_kernel``) over rows with NaN, -0.0 and
    nulls: f64 sums within rel 1e-9, everything else exact."""
    batch, gid, tail = _batch(3000, 70 + cap, cap, nulls=True)
    jspecs, jstates = _jax_states(batch, gid, tail, cap, AGGS[layout])
    specs, args, ops, cols = _torch_call(batch, gid, tail, AGGS[layout])
    host = TK.unpack_host(specs, TK.fetch_states(_fold_copied(specs, [args], ops, cols, cap)))
    roles = [r for s in jspecs for r in JK.state_fields(s, "x64")] + ["add"]
    assert len(host) == len(jstates) == len(roles)
    for f, (want, got, role) in enumerate(zip(jstates, host, roles)):
        _assert_same(want, got, exact=role != "add", what=f"field {f} ({role})")
