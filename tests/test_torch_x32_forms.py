"""The x32 forms of the port's kernels against the JAX package's x32
functions, on the CPU (the kernels' plain twins).

* B12f, the Dekker square of the variance family
  (``arrow_ballista_tpu/ops/kernels.py:_two_product_f32`` and
  ``square_pair_closure``): ``kernels.square_pair_twin`` and the
  ``square``/``sqpair_lo`` registers of B3's program, bit for bit on
  normal values; a subnormal counts as the reference's flushed zero (XLA
  on the CPU flushes them); NaN results match as NaN; past |x| ~ 1.8e19
  the square overflows and the pinned (p, e) are the reference's.
* keyed_corr in x32 against ``keyed_corr_kernel(cap, "x32")``, the x32
  keyed finish (pair kinds) against ``keyed_finish_kernel`` in x32, the
  window kernel against ``make_window_kernel(..., "x32")``: rel 1e-6 on
  double-float words (hi + lo), integers exact.
* ``BatchExchanger``'s ``i64pair`` layout: the exchanged payloads
  bit-identical to the reference's.
* The int32 forms (key codes, the key gather, the median's output, the
  join probe's keys): the int64 forms' values, narrowed.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as SMOKE

from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu.ops import window_kernel as JW
from arrow_ballista_tpu.exec import expressions as jpe
from arrow_ballista_tpu_torch.exec import expressions as tpe
from arrow_ballista_tpu_torch.ops import bridge as TB
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops import window_kernel as TW
from test_torch_keyed import FINISH_CASES, finish_keys

REL = 1e-6  # the reference's x32 bar
CPU = torch.device("cpu")
F32_TINY = np.float32(1.17549435e-38)  # the smallest normal f32


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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ B12f
def _ref_square(hi: np.ndarray, lo: np.ndarray):
    run = JK.square_pair_closure(lambda env: ((env["h"], env["l"]), None))
    (p, e), _ = jax.jit(lambda h, l: run({"h": h, "l": l}))(jnp.asarray(hi), jnp.asarray(lo))
    return np.asarray(p), np.asarray(e)


def _flush(x: np.ndarray) -> np.ndarray:
    """Subnormals as the reference's flushed zeros (sign kept)."""
    return np.where(np.abs(x) < F32_TINY, np.float32(0) * np.sign(x), x).astype(np.float32)


def _same_bits(got: np.ndarray, want: np.ndarray) -> None:
    got, want = _flush(got), _flush(want)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    g, w = got[~nan].view(np.int32), want[~nan].view(np.int32)
    zero = (got[~nan] == 0) & (want[~nan] == 0)  # a flushed zero's sign
    assert np.array_equal(g[~zero], w[~zero]), int((g[~zero] != w[~zero]).sum())


def _pairs(x: np.ndarray):
    hi = x.astype(np.float32)
    return hi, (x - hi.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_square_pair_twin_bit_identical_on_normal_values(seed):
    rng = np.random.default_rng(seed)
    n = 1 << 16
    x = rng.uniform(-1, 1, n) * 10.0 ** rng.uniform(-6, 9, n)
    hi, lo = _pairs(x)
    p, e = TK.square_pair_twin(_t(hi), _t(lo))
    rp, re = _ref_square(hi, lo)
    assert np.array_equal(p.numpy().view(np.int32), rp.view(np.int32))
    assert np.array_equal(e.numpy().view(np.int32), re.view(np.int32))


def test_square_pair_twin_edge_grid_pinned_to_the_reference():
    hi, lo = SMOKE.sqpair_edge_grid()
    # the reference reads a subnormal input as zero too
    p, e = TK.square_pair_twin(_t(_flush(hi)), _t(_flush(lo)))
    rp, re = _ref_square(hi, lo)
    _same_bits(p.numpy(), rp)
    _same_bits(e.numpy(), re)
    # pinned: past the square's overflow the error word is -inf while the
    # split holds, NaN past the split
    at = lambda v: int(np.nonzero((hi == np.float32(v)) & (lo == 0))[0][0])  # noqa: E731
    assert p[at(1.9e19 * -1)].item() == np.inf and e[at(-1.9e19)].item() == -np.inf
    assert np.isnan(e[at(1.7e38)].item()) and np.isnan(e[at(np.inf)].item())


def _square_program():
    schema = pa.schema([("x", pa.float64())])
    comp = TK.TorchExprCompiler(schema, "x32")
    pairc = comp.pair_column(tpe.Col(0, "x"))
    sq = TK.square_pair_closure(pairc)
    program = TK.ExprProgram(None, list(sq.halves), [(0, TK.F32), (1, TK.F32)], mode="x32")
    return program, sq


def test_square_pair_opcodes_in_one_program():
    """B12f as two registers of B3's program (``square`` of hi, then
    ``sqpair_lo`` of hi and lo): the program's twin gives the square pair's
    bits and carries the pair's validity."""
    program, sq = _square_program()
    names = [TK.EXPR_OPS[r[0]] for r in program.code]
    assert names.count("sqpair_lo") == 1 and names.count("square") == 1
    hi, lo = SMOKE.sqpair_edge_grid()
    valid = np.arange(len(hi)) % 5 != 0
    env = {"col_0__pair__hi": _t(hi), "col_0__pair__lo": _t(lo),
           "col_0__pair__valid": _t(valid)}
    _pred, _pv, values, valids = TK.expr_program_reference(program, env, len(hi), CPU)
    (p, e), v = sq(env)
    for got, want in ((values[0], p), (values[1], e)):
        assert np.array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))
    assert all(torch.equal(x, v) for x in valids)
    # the opcode is x32's: an x64 program holding it is malformed
    op, f64 = TK.EXPR_OPS.index, TK.DT_F64
    code = [[op("leaf"), f64, -1, 0, 2, -1, 0], [op("leaf"), f64, -1, 1, 2, -1, 0],
            [op("sqpair_lo"), f64, f64, 0, 1, -1, 0], [op("store_value"), f64, -1, 2, 0, -1, 0]]
    with pytest.raises(ValueError, match="x32 opcode"):
        TK.ExprProgram.from_parts(code, [], ["h", "l", "v"], 3, [("value", 2, f64)],
                                  [None, None, ("value", 2, f64, 0), None])


# --------------------------------------------------------- keyed corr x32
def _sorted_groups(n, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) > 0.2
    key = rng.integers(0, 40, n).astype(np.int32)
    srt = JK.keyed_sort_kernel(1)(jnp.asarray(mask), jnp.asarray(key))
    s2, perm = np.asarray(srt[0]), np.asarray(srt[1])
    n_groups = int(srt[-1])
    inv = _t((~mask).astype(np.int32))
    tperm, gids, tng = TK.keyed_sort(inv, [_t(key)])
    assert tng == n_groups
    return rng, s2, perm, gids, tperm, n_groups


@pytest.mark.parametrize("seed", [5, 6])
def test_keyed_corr_x32_twin_matches_reference(seed):
    n = 5000
    rng, s2, perm, gids, tperm, ng = _sorted_groups(n, seed)
    x = rng.normal(1e3, 7.0, n)
    y = 0.3 * x + rng.normal(0, 2.0, n)
    x[::31] = np.nan
    xv, yv = rng.random(n) > 0.05, rng.random(n) > 0.05
    xh, xl = _pairs(x)
    yh, yl = _pairs(y)
    cap = max(64, 1 << (max(ng, 1) - 1).bit_length())
    ref = np.asarray(JK.keyed_corr_kernel(cap, "x32")(
        jnp.asarray(s2), jnp.asarray(perm), *map(jnp.asarray, (xh, xl, xv, yh, yl, yv))))
    got = TK.keyed_corr_x32(gids["s2"], tperm, gids["gid_in"], _t(xh), _t(xl), _t(xv),
                            _t(yh), _t(yl), _t(yv), cap).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape == (7, cap)
    assert np.array_equal(got[6][:ng], ref[6][:ng])
    for j in range(3):
        g = got[2 * j].view(np.float32).astype(np.float64) + got[2 * j + 1].view(np.float32)
        r = ref[2 * j].view(np.float32).astype(np.float64) + ref[2 * j + 1].view(np.float32)
        np.testing.assert_allclose(g[:ng], r[:ng], rtol=REL, atol=0)


# ------------------------------------------------------- keyed finish x32
def _finish_batch(seed, n=4000):
    """Seeded finish inputs; a named case (test_torch_keyed.py:
    finish_keys) draws its values from seed 5 and replaces the mask and
    keys."""
    rng = np.random.default_rng(seed if isinstance(seed, int) else 5)
    v = rng.uniform(-50, 50, n)
    v[::23] = np.nan
    batch = pa.RecordBatch.from_pydict({
        "v": pa.array(v, mask=rng.random(n) < 0.1),
        "w": pa.array(rng.integers(-(10**12), 10**12, n), pa.int64(),
                      mask=rng.random(n) < 0.05),
        "f": pa.array(rng.uniform(1, 2, n) * (1 + 1e-12 * rng.integers(0, 5, n))),
        "i": pa.array(rng.integers(-1000, 1000, n).astype(np.int32)),
    })
    mask = rng.random(n) > 0.2
    keys = [rng.integers(0, 300, n).astype(np.int32), rng.integers(0, 3, n).astype(np.int32)]
    if not isinstance(seed, int):
        mask, keys = finish_keys(seed, rng, n, mask)
    return batch, mask, keys


def _specs(mod, comp, schema, Col):
    """Every x32 state kind: a float sum, an int64 avg as its exact pair,
    an f64 min/max as its order pair, int32 and float extrema, counts."""
    col = lambda name: Col(schema.get_field_index(name), name)  # noqa: E731
    specs = [mod.KernelAggSpec("count_star", False), mod.KernelAggSpec("sum", True),
             mod.KernelAggSpec("avg", True, pair=True),
             mod.KernelAggSpec("min", True, ord_pair=True),
             mod.KernelAggSpec("max", True, ord_pair=True),
             mod.KernelAggSpec("min", True, int_minmax=True),
             mod.KernelAggSpec("max", True), mod.KernelAggSpec("count", True)]
    closures = [None, comp._lower(col("v")), comp.pair_column(col("w")),
                comp.ord_pair_column(col("f")), comp.ord_pair_column(col("f")),
                comp._lower(col("i")), comp._lower(col("v")), comp._lower(col("v"))]
    return specs, closures


@pytest.mark.parametrize("seed", FINISH_CASES)
def test_keyed_finish_x32_twin_matches_reference(seed):
    batch, mask, keys = _finish_batch(seed)
    comp = JK.JaxExprCompiler(batch.schema)
    jspecs, jcl = _specs(JK, comp, batch.schema, jpe.Col)
    flat = JK.flat_arg_names(comp.leaves)
    env = JK.build_env(batch, comp.leaves, batch.num_rows)
    holder: dict = {}
    prep = JK.make_keyed_prep_kernel(None, jcl, jspecs, flat, holder)
    out = prep(tuple(jnp.asarray(k) for k in keys), jnp.asarray(mask),
               *[jnp.asarray(env[nm]) for nm in flat])
    srt = JK.keyed_sort_kernel(len(keys))(out[0], *out[1:1 + len(keys)])
    ng = int(srt[-1])
    cap = max(64, 1 << (max(ng, 1) - 1).bit_length())
    jp = np.asarray(JK.keyed_finish_kernel(holder["kinds"], holder["plan"], jspecs,
                                           len(keys), cap, "x32")(
        srt[0], srt[1], tuple(srt[2:-1]), tuple(out[1 + len(keys):])))
    jstates, jkeys = JK.unpack_keyed_host(jspecs, jp, "x32", len(keys))

    tcomp = TK.TorchExprCompiler(batch.schema, "x32")
    tspecs, tcl = _specs(TK, tcomp, batch.schema, tpe.Col)
    tflat = TK.flat_arg_names(tcomp.leaves)
    tenv = TB.DeviceStaging(CPU).put(TK.build_env(batch, tcomp.leaves, batch.num_rows,
                                                  mode="x32"))
    tprep = TK.make_keyed_prep_kernel(None, tcl, tspecs, tflat, ("code",) * len(keys),
                                      mode="x32")
    kb = tprep([(_t(k),) for k in keys], _t(mask), *[tenv[nm] for nm in tflat])
    perm, gids, tng = TK.keyed_sort(kb.inv, kb.codes)
    assert tng == ng
    columns, field_col = TK._x32_scan_plan(tprep.layout, kb.values, kb.valids)
    packed = TK.keyed_finish_x32(tspecs, columns, field_col, tprep.layout.ops, perm, gids,
                                 ng, cap).numpy()
    assert packed.dtype == np.int32
    tstates, tkeys = TK.unpack_keyed_host(tspecs, packed, len(keys))
    for a, b in zip(jkeys, tkeys):
        assert np.array_equal(np.asarray(a)[:ng], b[:ng])
    ops = TK.x32_merge_ops(tspecs)
    assert len(jstates) == len(tstates) == len(ops)
    for f, op in enumerate(ops):
        a, b = np.asarray(jstates[f])[:ng], tstates[f][:ng]
        if op == TK.XM_SUM_HI:
            wa = a.astype(np.float64) + np.asarray(jstates[f + 1])[:ng]
            wb = b.astype(np.float64) + tstates[f + 1][:ng]
            assert np.array_equal(np.isnan(wa), np.isnan(wb)), f
            ok = ~np.isnan(wa)
            np.testing.assert_allclose(wb[ok], wa[ok], rtol=REL, atol=1e-9)
        elif op in (TK.XM_MIN_F32, TK.XM_MAX_F32):
            assert np.array_equal(np.isnan(a), np.isnan(b)), f
            ok = ~np.isnan(a)
            assert np.array_equal(a[ok], b[ok]), f
        elif op != TK.XM_SUM_LO:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), f


def test_merge_keyed_host_x32_merges_pairs_by_key():
    """Two chunks' x32 states merged by key: sums by 2Sum, order pairs by
    the lexicographic extremum, counts added; a key in one chunk only keeps
    its state."""
    specs = [TK.KernelAggSpec("sum", True), TK.KernelAggSpec("min", True, ord_pair=True)]
    rng = np.random.default_rng(2)
    chunks, want = [], {}
    for c in range(2):
        keys = np.sort(rng.choice(50, 30, replace=False)).astype(np.int64)
        vals = rng.uniform(-5, 5, (30, 3))
        state = TK.init_states(specs, 30, CPU, "x32").numpy().copy()
        for j, (k, v) in enumerate(zip(keys, vals)):
            hi = np.float32(v.sum())
            lo = np.float32(v.sum() - np.float64(hi))
            o = TB.to_u64_order(np.array([v.min()]))
            ohi, olo = TB.split_u64_i32(o)
            state[:, j] = [hi.view(np.int32), lo.view(np.int32), 3, ohi[0], olo[0], 3, 3]
            s, m, n = want.get(k, (0.0, np.inf, 0))
            want[k] = (s + v.sum(), min(m, v.min()), n + 3)
        chunks.append((TK.unpack_host(specs, state), [keys], 30))
    states, keys, ng = TK.merge_keyed_host_x32(specs, chunks)
    assert ng == len(want) and keys[0].tolist() == sorted(want)
    for g, k in enumerate(keys[0]):
        s, m, n = want[k]
        assert states[0][g] + np.float64(states[1][g]) == pytest.approx(s, rel=REL)
        dec = TB.order_decode_f64(np.array([states[3][g]], np.int32),
                                  np.array([states[4][g]], np.int32))[0]
        assert dec == m and states[2][g] == n and states[6][g] == n


# --------------------------------------------------------- window kernel
WINDOW_SPECS = SMOKE.X32_WINDOW_SPECS


def _specs_with_pair_flag(specs):
    """The reference's spec tuples: the x32 pair flag on agg/aggf."""
    out = []
    for s in specs:
        if s[0] == "agg":
            out.append(s + (s[2] == 2,))
        elif s[0] == "aggf":
            out.append(s + (s[2] == 2,))
        else:
            out.append(s)
    return tuple(out)


@pytest.mark.parametrize("seed", [1, 2])
def test_window_kernel_x32_twin_matches_reference(seed):
    pkeys, okeys, args = SMOKE.x32_window_inputs(seed)
    jspecs = _specs_with_pair_flag(WINDOW_SPECS)
    jfn = JW.make_window_kernel(jspecs, len(pkeys), len(okeys), len(args), "x32")
    jargs = tuple(
        ((jnp.asarray(v[0]), jnp.asarray(v[1])) if isinstance(v, tuple) else jnp.asarray(v),
         jnp.asarray(m)) for v, m in args)
    ref = np.asarray(jfn(tuple(map(jnp.asarray, pkeys)), tuple(map(jnp.asarray, okeys)), jargs))
    fn = TW.make_window_kernel(WINDOW_SPECS, len(pkeys), len(okeys), len(args), "x32")
    targs = [((_t(v[0]), _t(v[1])) if isinstance(v, tuple) else _t(v), _t(m)) for v, m in args]
    got = fn([_t(k) for k in pkeys], [_t(k) for k in okeys], targs).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape
    # per packed row: f32 (sum words compared as hi + lo pairs), else exact
    floats = SMOKE.x32_window_float_rows(WINDOW_SPECS, args)
    r = 0
    while r < got.shape[0]:
        kind = floats.get(r)
        if kind == "pair":
            g = got[r].view(np.float32).astype(np.float64) + got[r + 1].view(np.float32)
            w = ref[r].view(np.float32).astype(np.float64) + ref[r + 1].view(np.float32)
            np.testing.assert_allclose(g, w, rtol=REL, atol=1e-3)
            r += 2
            continue
        if kind == "f32":
            g, w = got[r].view(np.float32), ref[r].view(np.float32)
            assert np.array_equal(np.isnan(g), np.isnan(w)), r
            ok = ~np.isnan(w) & np.isfinite(w)
            np.testing.assert_allclose(g[ok], w[ok], rtol=REL, atol=0)
        elif kind == "ext":
            # an extremum's word under a count of 0 is masked on the host
            # (the reference packs its int32 identity there)
            live = got[r + 1] != 0
            assert np.array_equal(got[r + 1], ref[r + 1]), r
            assert np.array_equal(got[r][live], ref[r][live]), r
        else:
            assert np.array_equal(got[r], ref[r]), r
        r += 1


# ------------------------------------------------------- exchange i64pair
def test_batch_exchanger_i64pair_round_trip_matches_reference():
    """Twin of tests/test_batch_exchange.py:55 in x32: int64 past int32,
    date64, timestamps, uint64 and f64 cross as (lo, hi) int32 words and
    come back bit for bit, as the reference's do."""
    from arrow_ballista_tpu.parallel import mesh as JM
    from arrow_ballista_tpu_torch.parallel import mesh as TM

    rng = np.random.default_rng(11)
    n = 3000
    f64 = rng.normal(0, 1e300, n)
    f64[::97] = -0.0
    f64[::101] = np.nan
    batch = pa.RecordBatch.from_pydict({
        "i": pa.array(rng.integers(-(2**62), 2**62, n), pa.int64(), mask=rng.random(n) < 0.1),
        "u": pa.array(rng.integers(0, 2**62, n).astype(np.uint64), pa.uint64()),
        "d": pa.array(rng.integers(0, 2**40, n).astype("datetime64[ms]"), pa.date64()),
        "t": pa.array(rng.integers(-(2**50), 2**50, n).astype("datetime64[us]"),
                      pa.timestamp("us")),
        "f": pa.array(f64),
        "s": pa.array([f"k{x}" for x in rng.integers(0, 50, n)]),
        "g": pa.array(rng.integers(-5, 5, n).astype(np.int32)),
    })
    dest = rng.integers(0, 2, n).astype(np.int32)
    valid = np.ones(n, bool)
    outs = []
    for M, mesh in ((JM, JM.make_mesh(2)), (TM, TM.make_mesh(2, "cpu"))):
        ex = M.BatchExchanger(mesh, batch.schema, 4096)
        assert [k for k, _ in ex.layout] == ["i64pair"] * 5 + ["dict", "num"]
        cols = ex.to_columns(batch)
        recv, rv, dropped = ex.exchange(dest, valid, cols)
        assert dropped == 0
        outs.append(ex.to_batches(recv, rv))
    for jb, tb in zip(*outs):
        assert tb.num_rows == jb.num_rows
        for name in batch.schema.names:
            a, b = jb.column(name), tb.column(name)
            if name == "f":
                assert np.array_equal(np.asarray(a).view(np.int64), np.asarray(b).view(np.int64))
            else:
                assert a.equals(b), name
    back = pa.Table.from_batches(outs[1]).sort_by("i")
    assert back.num_rows == n


# ------------------------------------------------------------ int32 forms
def test_key_encode_int32_codes_are_the_low_words():
    rng = np.random.default_rng(9)
    n = 2000
    keys = (
        (_t(rng.integers(-(2**31) + 1, 2**31 - 1, n).astype(np.int32)), _t(rng.random(n) > 0.1)),
        (_t(rng.random(n) > 0.5), None),
        (_t(rng.normal(0, 10, n).astype(np.float32)), _t(rng.random(n) > 0.2)),
        (_t(rng.integers(0, 2**31, n).astype(np.int32)),),
    )
    kinds = ("ident", "bool", "f32", "code")
    masks = (_t(rng.random(n) > 0.3), None, None)
    inv64, c64 = TK.key_encode_reference(kinds, keys, masks, n, CPU)
    inv32, c32 = TK.key_encode_reference(kinds, keys, masks, n, CPU, TK.I32)
    assert torch.equal(inv64, inv32)
    for k, (a, b) in enumerate(zip(c64[:3], c32[:3])):
        assert b.dtype == TK.I32
        assert np.array_equal(a.numpy() & 0xFFFFFFFF, b.numpy().astype(np.int64) & 0xFFFFFFFF), k
    # the f32 key's bits and the zigzag code widen back to the int64 codes
    assert np.array_equal(c32[2].numpy().astype(np.int64), c64[2].numpy())
    assert np.array_equal(c32[0].numpy().astype(np.int64) & 0xFFFFFFFF, c64[0].numpy())


def test_keyed_gather_and_median_int32_forms_match_int64():
    rng = np.random.default_rng(4)
    n = 3000
    inv = _t((rng.random(n) < 0.2).astype(np.int32))
    key = rng.integers(0, 60, n)
    vals = rng.normal(0, 5, n)
    ohi, olo = TB.split_u64_i32(TB.to_u64_order(vals))
    ovalid = _t(rng.random(n) > 0.1)
    for keys in ([_t(key.astype(np.int64))], [_t(key.astype(np.int32))]):
        perm, gids, ng = TK.keyed_sort(inv, keys)
        out = torch.zeros((1, 64), dtype=keys[0].dtype)
        TK.keyed_keys_reference(gids["sk"], gids["starts"], ng, out)
        m64 = TK.keyed_median(inv, keys, _t(ohi), _t(olo), ovalid, 64)
        m32 = TK.keyed_median(inv, keys, _t(ohi), _t(olo), ovalid, 64, TK.I32)
        assert m32.dtype == TK.I32
        assert np.array_equal(m64.numpy(), m32.numpy().astype(np.int64))
        if keys[0].dtype == TK.I32:
            assert out.dtype == TK.I32
            assert np.array_equal(out[0, :ng].numpy(), np.unique(key[inv.numpy() == 0]))


@pytest.mark.parametrize("dense", [False, True])
def test_join_probe_int32_keys_and_4_byte_columns(dense):
    rng = np.random.default_rng(6)
    bk = np.unique(rng.integers(-5000, 5000, 800))
    pk = rng.integers(-6000, 6000, 4000)
    b32 = rng.normal(0, 1, len(bk)).astype(np.float32)
    bi = rng.integers(-9, 9, len(bk)).astype(np.int32)
    bvalid = _t(rng.random(len(bk)) > 0.1)
    outs = []
    for dt in (np.int64, np.int32):
        bkeys = _t(bk.astype(dt))
        form = {}
        if dense:
            kmin = int(bk[0])
            form = dict(table=TK.join_build_table(bkeys, kmin, 1 << 14), kmin=kmin)
        else:
            form = dict(bkeys=bkeys)
        outs.append(TK.join_probe(_t(pk.astype(dt)), None, None, [_t(b32), _t(bi)],
                                  [bvalid, None], **form))
    (v64, ok64, m64), (v32, ok32, m32) = outs
    assert torch.equal(m64, m32) and all(torch.equal(a, b) for a, b in zip(ok64, ok32))
    for a, b in zip(v64, v32):
        assert a.dtype == b.dtype and torch.equal(a, b)
