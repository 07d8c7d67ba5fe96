"""The PyTorch port's x32 pieces, function by function, against the JAX
package's, on the CPU.

The port's plain twins (what runs on ``device="cpu"``; the CUDA kernels
are held to these on the card by ``tests/test_torch_cuda_kernels.py``)
against the reference's x32 functions on the same seeded inputs:

* D (``df32_agg``) against ``_blocked_onehot_agg`` (matmul form) and
  ``_segment_sum_df32`` (scatter form), on uniform ids and on every row in
  one group or Zipf-skewed ids: hi + lo within rel 1e-6, counts exact;
* E (``ord_extremum``) against ``_ord_segment_extremum`` and
  ``jax.ops.segment_min/max``: bit-exact (NaN as the canonical NaN, -0.0
  below +0.0);
* M (``combine_states`` x32) against ``combine_states(..., "x32")``;
  K2's df32 / unsigned pair folds against ``_scan_segments``;
  ``make_distributed_agg_step`` x32 against the reference's on 8 shards;
  ``make_partial_agg_kernel`` under x32 on every route (its states through
  ``states_from_numpy``); B3's f32/i32 programs against
  ``JaxExprCompiler`` in x32 over the opcode grid;
* the statistical aggregates, the keyed route, a window, the join fold
  and the exchange's int64 pairs answer in x32 as the reference does
  (``test_torch_x32_routes.x32_three``); an x32 range error re-runs on
  the CPU operators while any other device error raises; a cache entry
  never crosses modes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_ballista_tpu_torch as tbt
import chip_smoke as SMOKE
from arrow_ballista_tpu.exec import expressions as jpe
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu.parallel import mesh as JM
from arrow_ballista_tpu_torch.exec import expressions as tpe
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.parallel import mesh as TM
from test_torch_precision_x32 import port_metrics, settings, tpch, x32_both  # noqa: F401

pytestmark = pytest.mark.usefixtures("x32_both")

REL = 1e-6
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _seg_inputs(n, cap, seed, low=1.0):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, max(1, cap - 3), n).astype(np.int32)  # some groups empty
    mask = rng.random(n) < 0.9
    vals = [rng.uniform(low, 1e5, n).astype(np.float32) for _ in range(3)]
    valid = rng.random(n) < 0.8
    return seg, mask, vals, valid


def _df(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


# ------------------------------------------------------------------- D
@pytest.mark.parametrize("cap", [1, 7, 300])
def test_df32_matmul_form_matches_blocked_onehot_agg(cap):
    n = 50_001
    seg, mask, vals, valid = _seg_inputs(n, cap, cap)
    m = mask & valid
    V = np.stack([np.where(mask, vals[0], 0), np.where(m, vals[1], 0),
                  np.where(m, vals[2], 0), mask.astype(np.float32), m.astype(np.float32)],
                 axis=1).astype(np.float32)
    jhi, jlo, jcnt = JK._blocked_onehot_agg(jnp.asarray(V), jnp.asarray(seg), cap, 3)
    hi, lo, cnt = TK.df32_agg(_t(seg), _t(mask), None, None, [_t(v) for v in vals],
                              [None, _t(valid), _t(valid)], [(0, -1), (1, -1), (2, -1)],
                              [-1, 1], cap, TK.DF32_BLOCK)
    np.testing.assert_allclose(_df(hi, lo).T, _df(jhi, jlo), rtol=REL, atol=1e-3)
    np.testing.assert_array_equal(cnt.numpy().T, np.asarray(jcnt))


def test_df32_matmul_form_tracks_f64_with_mixed_signs():
    """Values of both signs (partial cancellation in a block): the port
    stays within 1e-6 of the f64 sum.  The reference's CPU einsum adds each
    2^14-row block in f32 and lands ~2e-6 off on this data, so it is not
    the yardstick here."""
    n, cap = 50_001, 3
    seg, mask, vals, _ = _seg_inputs(n, cap, 2, low=-1e4)
    hi, lo, _ = TK.df32_agg(_t(seg), _t(mask), None, None, [_t(vals[0])], [None],
                            [(0, -1)], [], cap, TK.DF32_BLOCK)
    oracle = np.zeros(cap)
    np.add.at(oracle, seg[mask], vals[0][mask].astype(np.float64))
    np.testing.assert_allclose(_df(hi[0], lo[0]), oracle, rtol=REL)


@pytest.mark.parametrize("cap", [1, 64, 5000, 8192])
@pytest.mark.parametrize("n", [1000, 300_001])
def test_df32_scatter_form_matches_segment_sum_df32(cap, n):
    seg, mask, vals, _ = _seg_inputs(n, cap, n + cap)
    v = np.where(mask, vals[0], 0).astype(np.float32)
    jhi, jlo = JK._segment_sum_df32(jnp.asarray(v), jnp.asarray(seg), cap)
    hi, lo, _ = TK.df32_agg(_t(seg), _t(mask), None, None, [_t(vals[0])], [None],
                            [(0, -1)], [], cap, TK.df32_scatter_block(n, cap, CPU))
    np.testing.assert_allclose(_df(hi[0], lo[0]), _df(jhi, jlo), rtol=REL, atol=1e-3)
    oracle = np.zeros(cap)
    np.add.at(oracle, seg, v.astype(np.float64))
    np.testing.assert_allclose(_df(hi[0], lo[0]), oracle, rtol=REL, atol=1e-3)


def _skewed_seg(dist, n, cap, seed):
    """Every row in one group, or Zipf-skewed group ids (the smoke's
    exponent over ``cap`` groups)."""
    if dist == "one group":
        return np.full(n, cap // 2, np.int32)
    return SMOKE.zipf_gid(n, cap, SMOKE.X32_ZIPF_S, seed)


@pytest.mark.parametrize("dist", ["one group", "zipf"])
def test_df32_matmul_form_matches_blocked_onehot_agg_skewed(dist):
    n, cap = 50_001, 300
    _, mask, vals, valid = _seg_inputs(n, cap, 11)
    seg = _skewed_seg(dist, n, cap, 11)
    m = mask & valid
    V = np.stack([np.where(mask, vals[0], 0), np.where(m, vals[1], 0), mask.astype(np.float32),
                  m.astype(np.float32)], axis=1).astype(np.float32)
    jhi, jlo, jcnt = JK._blocked_onehot_agg(jnp.asarray(V), jnp.asarray(seg), cap, 2)
    hi, lo, cnt = TK.df32_agg(_t(seg), _t(mask), None, None, [_t(v) for v in vals[:2]],
                              [None, _t(valid)], [(0, -1), (1, -1)], [-1, 1], cap,
                              TK.DF32_BLOCK)
    np.testing.assert_allclose(_df(hi, lo).T, _df(jhi, jlo), rtol=REL, atol=1e-3)
    np.testing.assert_array_equal(cnt.numpy().T, np.asarray(jcnt))


@pytest.mark.parametrize("dist", ["one group", "zipf"])
@pytest.mark.parametrize("cap", [64, 8192])
def test_df32_scatter_form_matches_segment_sum_df32_skewed(dist, cap):
    n = 300_001
    _, mask, vals, _ = _seg_inputs(n, cap, 13)
    seg = _skewed_seg(dist, n, cap, 13)
    v = np.where(mask, vals[0], 0).astype(np.float32)
    jhi, jlo = JK._segment_sum_df32(jnp.asarray(v), jnp.asarray(seg), cap)
    hi, lo, _ = TK.df32_agg(_t(seg), _t(mask), None, None, [_t(vals[0])], [None],
                            [(0, -1)], [], cap, TK.df32_scatter_block(n, cap, CPU))
    np.testing.assert_allclose(_df(hi[0], lo[0]), _df(jhi, jlo), rtol=REL, atol=1e-3)
    oracle = np.zeros(cap)
    np.add.at(oracle, seg, v.astype(np.float64))
    np.testing.assert_allclose(_df(hi[0], lo[0]), oracle, rtol=REL, atol=1e-3)


CANCEL_ROWS, CANCEL_CAP = 1 << 18, 16


@pytest.mark.parametrize("form", ["matmul", "scatter"])
def test_df32_cancellation_mix_meets_f64_where_plain_f32_fails(form):
    """The cancellation mix (large values that cancel beside tiny ones of
    both signs, group sums near 0): the twin's and the reference's hi + lo
    meet the f64 sum at rel 1e-6 on every group; the hi word alone (a plain
    f32 pairwise tree over the blocks) and numpy's f32 sum fail that bar."""
    n, cap = CANCEL_ROWS, CANCEL_CAP
    seg, mask, v = SMOKE.df32_cancel_inputs(n, cap, TK.DF32_BLOCK, 5)
    want, naive = SMOKE.cancel_sums(seg, mask, v, cap)
    vm = np.where(mask, v, 0).astype(np.float32)
    if form == "matmul":
        block = TK.DF32_BLOCK
        V = np.stack([vm, mask.astype(np.float32)], axis=1)
        jhi, jlo, _ = JK._blocked_onehot_agg(jnp.asarray(V), jnp.asarray(seg), cap, 1)
        jhi, jlo = jhi[:, 0], jlo[:, 0]
    else:
        block = TK.df32_scatter_block(n, cap, CPU)
        jhi, jlo = JK._segment_sum_df32(jnp.asarray(vm), jnp.asarray(seg), cap)
    assert TK.DF32_BLOCK % block == 0
    hi, lo, _ = TK.df32_agg(_t(seg), None, _t(mask), None, [_t(v)], [None], [(0, -1)], [],
                            cap, block)
    assert SMOKE.cancel_miss(_df(jhi, jlo), want) == 0.0
    assert SMOKE.cancel_miss(_df(hi[0], lo[0]), want) == 0.0
    assert SMOKE.cancel_miss(hi[0].double().numpy(), want) > 0.0
    assert SMOKE.cancel_miss(naive, want) > 0.0


def test_df32_pair_sum_recombines_int64_exactly():
    """An int64 pair's halves sum by their own trees, then 2Sum, as the
    reference's "sumpair".  Each 48-bit value crosses exactly; each block
    partial rounds once to f32, so the total is good to ~eps32 of a block
    (the reference's own bound), and matches the reference's."""
    rng = np.random.default_rng(4)
    n, cap = 20_000, 5
    big = rng.integers(1 << 33, 1 << 40, n)
    seg = rng.integers(0, cap, n).astype(np.int32)
    hi32 = big.astype(np.float32)
    lo32 = (big - hi32.astype(np.float64)).astype(np.float32)
    hi, lo, _ = TK.df32_agg(_t(seg), None, None, None, [_t(hi32), _t(lo32)], [None, None],
                            [(0, 1)], [], cap, TK.DF32_BLOCK)
    want = np.array([big[seg == g].sum() for g in range(cap)], np.float64)
    np.testing.assert_allclose(_df(hi[0], lo[0]), want, rtol=1e-7)
    zero = jnp.zeros((), jnp.float32)
    a_hi, a_lo = JK._segment_sum_df32(jnp.asarray(hi32), jnp.asarray(seg), cap)
    b_hi, b_lo = JK._segment_sum_df32(jnp.asarray(lo32) + zero, jnp.asarray(seg), cap)
    s, err = JK._two_sum(a_hi, b_hi)
    np.testing.assert_allclose(_df(hi[0], lo[0]), _df(s, a_lo + b_lo + err), rtol=1e-7)


# ------------------------------------------------------------------- E
@pytest.mark.parametrize("func", ["min", "max"])
def test_ord_extremum_matches_ord_segment_extremum(func):
    from arrow_ballista_tpu_torch.ops.bridge import split_u64_i32, to_u64_order

    rng = np.random.default_rng(5)
    n, cap = 40_000, 200
    seg = rng.integers(0, cap - 10, n).astype(np.int32)
    base = rng.uniform(-50, 50, cap)[seg]
    v = base * (1.0 + rng.integers(-4, 5, n) * 1e-13)
    v[::101] = -0.0
    v[1::103] = 0.0
    m = rng.random(n) < 0.9
    ohi, olo = split_u64_i32(to_u64_order(v))
    want = JK._ord_segment_extremum(JK.KernelAggSpec(func, True, ord_pair=True),
                                    (jnp.asarray(ohi), jnp.asarray(olo)), jnp.asarray(m),
                                    jnp.asarray(seg), cap)
    got = TK.ord_extremum(_t(seg), None, None, None, _t(m), _t(ohi), _t(olo), cap,
                          func == "min")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("func", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_ord_extremum_single_word_matches_segment_min_max(func, dtype):
    """f32 and i32 extrema bit-exact to jax.ops.segment_min/max over the
    reference's masked operand: NaN propagates (as XLA's canonical NaN),
    -0.0 orders below +0.0, empty groups hold the identity."""
    rng = np.random.default_rng(6)
    n, cap = 30_000, 64
    seg = rng.integers(0, cap - 4, n).astype(np.int32)
    if dtype == np.float32:
        v = rng.normal(0, 100, n).astype(np.float32)
        v[::97] = np.nan
        v[5::89] = -0.0
        v[6::89] = 0.0
        ident = np.float32(np.inf if func == "min" else -np.inf)
    else:
        v = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)
        info = np.iinfo(np.int32)
        ident = np.int32(info.max if func == "min" else info.min)
    m = rng.random(n) < 0.8
    red = jax.ops.segment_min if func == "min" else jax.ops.segment_max
    want = np.asarray(red(jnp.where(jnp.asarray(m), jnp.asarray(v), ident),
                          jnp.asarray(seg), num_segments=cap))
    got = TK.ord_extremum(_t(seg), None, None, None, _t(m), _t(v), None, cap, func == "min")
    np.testing.assert_array_equal(got[0].numpy(), want.view(np.int32))


# ------------------------------------------------------------------- M
def _x32_spec_dicts():
    return [dict(func="count_star", has_arg=False), dict(func="sum", has_arg=True),
            dict(func="avg", has_arg=True, pair=True), dict(func="min", has_arg=True),
            dict(func="max", has_arg=True, int_minmax=True),
            dict(func="min", has_arg=True, ord_pair=True),
            dict(func="max", has_arg=True, ord_pair=True)]


def _jspecs(dicts):
    return [JK.KernelAggSpec(d["func"], d["has_arg"], pair=d.get("pair", False),
                             int_minmax=d.get("int_minmax", False),
                             ord_pair=d.get("ord_pair", False)) for d in dicts]


def _random_x32_states(dicts, cap, seed):
    rng = np.random.default_rng(seed)
    out = []
    for spec in _jspecs(dicts):
        for role, is_int in zip(JK.state_fields(spec, "x32"), JK.state_is_int(spec, "x32")):
            if is_int:
                out.append(rng.integers(0, 1000, cap).astype(np.int32) if role == "add"
                           else rng.integers(-(2**31), 2**31 - 1, cap).astype(np.int32))
            else:
                f = (rng.normal(size=cap) * 1e5).astype(np.float32)
                f[::13] = np.nan
                f[3::11] = -0.0
                out.append(f)
    out.append(rng.integers(0, 1000, cap).astype(np.int32))
    return out


def test_combine_states_x32_matches_reference():
    dicts = _x32_spec_dicts()
    a, b = _random_x32_states(dicts, 257, 1), _random_x32_states(dicts, 257, 2)
    want = JK.combine_states(_jspecs(dicts), tuple(jnp.asarray(x) for x in a),
                             tuple(jnp.asarray(x) for x in b), "x32")
    specs = TK.specs_from_dicts(dicts)
    sa = TK.states_from_numpy(dicts, a, CPU, "x32")
    sb = TK.states_from_numpy(dicts, b, CPU, "x32")
    got = TK.combine_states(specs, sa, sb)
    wanted = TK.states_from_numpy(dicts, [np.asarray(w) for w in want], CPU, "x32")
    # bit for bit, NaN payloads included
    assert torch.equal(got, wanted)
    # the kernel's form: rows merged into a state in place
    merged = TK.x32_merge(sa.clone(), TK.x32_merge_ops(specs), list(sb))
    assert torch.equal(merged, wanted)


# ------------------------------------------------------------------- K2
def test_scan_segments_df32_omin_omax_match_reference():
    from arrow_ballista_tpu_torch.ops.bridge import split_u64_i32, to_u64_order

    rng = np.random.default_rng(8)
    n, cap = 60_001, 300
    seg = rng.integers(0, cap - 20, n).astype(np.int32)
    base = rng.random(n) < 0.9
    key = np.where(base, seg, cap).astype(np.int32)
    m = base & (rng.random(n) < 0.85)
    h = np.where(m, rng.uniform(1e6, 1e7, n), 0).astype(np.float32)
    f64 = rng.uniform(-1e3, 1e3, n) * (1 + rng.integers(-3, 4, n) * 1e-13)
    ohi, olo = split_u64_i32(to_u64_order(f64))
    imax, imin = np.iinfo(np.int32).max, np.iinfo(np.int32).min
    kinds = ["df32", ("omin", int(imax)), ("omax", int(imin))]
    cols = [(jnp.asarray(h), jnp.zeros(n, jnp.float32)),
            (jnp.asarray(np.where(m, ohi, imax)), jnp.asarray(np.where(m, olo, imax))),
            (jnp.asarray(np.where(m, ohi, imin)), jnp.asarray(np.where(m, olo, imin)))]
    totals, presence = jax.jit(lambda k, c: JK._sorted_segment_agg(k, cap, kinds, c))(
        jnp.asarray(key), cols)

    tk = _t(key)
    perm = TK.radix_argsort_reference([tk])
    valid = _t(m)
    scan_cols = [TK.ScanColumn(TK.SS_VALUES, TK.OP_DF32, values=_t(h), valid=valid),
                 TK.ScanColumn(TK.SS_VALUES, TK.OP_UMIN_U64, values=_t(ohi), valid=valid,
                               values2=_t(olo)),
                 TK.ScanColumn(TK.SS_VALUES, TK.OP_UMAX_U64, values=_t(ohi), valid=valid,
                               values2=_t(olo))]
    scanned = TK.seg_scan_reference(scan_cols, n, perm=perm, key=tk)
    s2 = tk[perm.long()]
    bounds = torch.searchsorted(s2, torch.arange(cap + 1, dtype=s2.dtype))
    present = (bounds[1:] - bounds[:-1]) > 0
    last = torch.clamp(bounds[1:] - 1, 0, n - 1)
    np.testing.assert_array_equal(present.numpy(), np.asarray(presence) > 0)
    hi, lo = TK._df32_split(scanned[0][last])
    got = np.where(present.numpy(), _df(hi, lo), 0.0)
    np.testing.assert_allclose(got, _df(*totals[0]), rtol=1e-9, atol=0)
    for k in (1, 2):
        ohi_g, olo_g = TK._ord_split(scanned[k][last])
        p = present.numpy()
        np.testing.assert_array_equal(ohi_g.numpy()[p], np.asarray(totals[k][0])[p])
        np.testing.assert_array_equal(olo_g.numpy()[p], np.asarray(totals[k][1])[p])


def test_scan_df32_cancellation_mix_meets_f64_where_plain_f32_fails():
    """K2's df32 fold and ``_sorted_segment_agg``'s on the cancellation
    mix: each group's total meets the f64 sum at rel 1e-6, a bar numpy's
    f32 pairwise sum of the same rows fails."""
    n, cap = CANCEL_ROWS, CANCEL_CAP
    seg, mask, v = SMOKE.df32_cancel_inputs(n, cap, TK.DF32_BLOCK, 6)
    want, naive = SMOKE.cancel_sums(seg, mask, v, cap)
    h = jnp.asarray(np.where(mask, v, 0).astype(np.float32))
    totals, _ = jax.jit(lambda k, c: JK._sorted_segment_agg(k, cap, ["df32"], c))(
        jnp.asarray(seg), [(h, jnp.zeros_like(h))])
    key = _t(seg)
    perm = TK.radix_argsort_reference([key])
    (scanned,) = TK.seg_scan_reference(
        [TK.ScanColumn(TK.SS_VALUES, TK.OP_DF32, values=_t(v), valid=_t(mask))], n,
        perm=perm, key=key)
    s2 = key[perm.long()]
    last = torch.searchsorted(s2, torch.arange(1, cap + 1, dtype=s2.dtype)) - 1
    assert SMOKE.cancel_miss(_df(*TK._df32_split(scanned[last])), want) == 0.0
    assert SMOKE.cancel_miss(_df(*totals[0]), want) == 0.0
    assert SMOKE.cancel_miss(naive, want) > 0.0


# ------------------------------------------------------- stage functions
def _kernels(cap, algo):
    """The same x32 partial-agg function in both packages: count(*), sum(v)
    and min(v) over an f32 column with nulls, max(i) over an int32, avg of
    an int64 pair, min/max of an f64 order pair."""
    schema = pa.schema([("v", pa.float32()), ("i", pa.int32()), ("w", pa.int64()),
                        ("f", pa.float64())])
    out = []
    for pe, K, Comp in ((jpe, JK, JK.JaxExprCompiler), (tpe, TK, TK.TorchExprCompiler)):
        comp = Comp(schema)
        v, i = comp._lower(pe.Col(0, "v")), comp._lower(pe.Col(1, "i"))
        w, f = comp.pair_column(pe.Col(2, "w")), comp.ord_pair_column(pe.Col(3, "f"))
        KS = K.KernelAggSpec
        specs = [KS("count_star", False), KS("sum", True), KS("min", True),
                 KS("max", True, int_minmax=True), KS("avg", True, pair=True),
                 KS("min", True, ord_pair=True), KS("max", True, ord_pair=True)]
        names = K.flat_arg_names(comp.leaves)
        if K is JK:
            kernel = K.make_partial_agg_kernel(None, [None, v, v, i, w, f, f], specs, cap, names)
        else:
            kernel = K.make_partial_agg_kernel(None, [None, v, v, i, w, f, f], specs, cap,
                                               names, algo=algo, mode="x32")
        out.append((specs, names, comp.leaves, kernel))
    return out


STAGE_ROWS = 40_003  # three 2^14-row blocks, padded to four


def _nan_groups(seeds, n=STAGE_ROWS, cap=64):
    """Groups holding a live, valid NaN of ``v`` in the batches of ``seeds``."""
    out = set()
    for seed in seeds:
        seg, tail, batch = _stage_batch(n, cap, seed)
        v = batch.column("v").to_numpy(zero_copy_only=False)
        live = tail & batch.column("v").is_valid().to_numpy(zero_copy_only=False)
        out.update(seg[live & np.isnan(v)].tolist())
    return np.array(sorted(out), dtype=np.int64)


def _stage_batch(n, cap, seed):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, cap - 2, n).astype(np.int32)
    v = rng.uniform(-1e3, 1e4, n).astype(np.float32)
    v[::211] = np.nan
    batch = pa.RecordBatch.from_pydict({
        "v": pa.array(v, pa.float32(), mask=rng.random(n) < 0.1),
        "i": pa.array(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)),
        "w": pa.array(rng.integers(1 << 33, 1 << 40, n), pa.int64(),
                      mask=rng.random(n) < 0.05),
        "f": pa.array(rng.uniform(-5, 5, n) * (1 + rng.integers(-3, 4, n) * 1e-13),
                      mask=rng.random(n) < 0.05),
    })
    return seg, np.arange(n) < n - 17, batch


def _assert_x32_states(jspecs, jout, tspecs, tstate, nan_groups=None, spread=False):
    """Sums within REL on hi + lo; counts and extrema exact (floats bit for
    bit, integers by value: the reference's counts may come back int64).
    ``nan_groups``: the groups with a NaN row, where the port's f32 sum and
    extremum are NaN.  ``spread``: the reference's one-hot einsum spread a
    NaN to other groups of its block, and its mesh pmin dropped one
    (ROADMAP, standing divergences): only the groups it left finite, or
    the NaN groups of its extrema it kept, are compared."""
    roles = [r for s in jspecs for r in JK.state_fields(s, "x32")] + ["add"]
    got = TK.unpack_host(tspecs, TK.fetch_states(tstate))
    want = [np.asarray(w) for w in jout]
    assert len(got) == len(want) == len(roles)
    i = 0
    for spec in jspecs:
        if spec.func in ("sum", "avg"):
            g, w = _df(got[i], got[i + 1]), _df(want[i], want[i + 1])
            if nan_groups is not None and not spec.pair:
                expect = np.zeros(len(g), bool)
                expect[nan_groups] = True
                np.testing.assert_array_equal(np.isnan(g), expect)
                if not spread:
                    np.testing.assert_array_equal(np.isnan(w), expect)
            keep = ~np.isnan(w)
            np.testing.assert_allclose(g[keep], w[keep], rtol=REL, atol=1e-3)
            np.testing.assert_array_equal(got[i + 2], want[i + 2])
            i += 3
            continue
        for _ in JK.state_fields(spec, "x32"):
            g, w = got[i], want[i]
            if g.dtype.kind == "f":
                keep = np.ones(len(g), bool)
                if nan_groups is not None and spec.func in ("min", "max"):
                    assert np.isnan(g[nan_groups]).all(), i
                    if spread:
                        keep[nan_groups] = False
                np.testing.assert_array_equal(g[keep].view(np.int32), w[keep].view(np.int32),
                                              err_msg=str(i))
            else:
                np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                              err_msg=str(i))
            i += 1
    np.testing.assert_array_equal(got[-1], want[-1])


@pytest.mark.parametrize("algo", ["matmul", "scatter", "sort"])
def test_partial_agg_kernel_x32_states_match_reference(algo):
    cap = 64
    (jspecs, jnames, jleaves, jkern), (tspecs, tnames, tleaves, tkern) = _kernels(cap, algo)
    state = None
    acc = None
    JK.set_agg_algorithm(algo)
    jkern = jax.jit(jkern)  # as the reference's stage runs it
    try:
        for seed in range(2):  # two batches: the cross-batch merge too
            seg, tail, batch = _stage_batch(STAGE_ROWS, cap, seed)
            jenv = JK.build_env(batch, jleaves, batch.num_rows)
            out = jkern(jnp.asarray(seg), jnp.asarray(tail),
                        *[jnp.asarray(jenv[k]) for k in jnames])
            acc = JK.combine_states(jspecs, acc, out, "x32")
            tenv = TK.build_env(batch, tleaves, batch.num_rows, mode="x32")
            state = tkern(_t(seg), _t(tail), *[_t(tenv[k]) for k in tnames], state=state)
    finally:
        JK.set_agg_algorithm(None)
    assert state.dtype == torch.int32
    _assert_x32_states(jspecs, acc, tspecs, state, nan_groups=_nan_groups(seeds=range(2)),
                       spread=algo == "matmul")


def test_make_distributed_agg_step_x32_matches_reference(monkeypatch):
    monkeypatch.setattr(TM, "CPU_DEVICES", 8)
    cap = 64
    (jspecs, jnames, jleaves, jkern), (tspecs, tnames, tleaves, tkern) = _kernels(cap, "matmul")
    seg, tail, batch = _stage_batch(8 * 999 + 5, cap, 9)  # ragged, not pow2 shards
    jenv = JK.build_env(batch, jleaves, batch.num_rows)
    tenv = TK.build_env(batch, tleaves, batch.num_rows, mode="x32")
    jmesh = JM.make_mesh(8)
    JK.set_agg_algorithm("scatter")
    try:
        jout = JM.make_distributed_agg_step(jkern, jspecs, jmesh, cap)(
            *JM.shard_batch(jmesh, [seg, tail] + [jenv[k] for k in jnames]))
    finally:
        JK.set_agg_algorithm(None)
    tmesh = TM.make_mesh(8, "cpu")
    tstate = TM.make_distributed_agg_step(tkern, tspecs, tmesh, cap, "x32")(
        TM.shard_batch(tmesh, [seg, tail] + [tenv[k] for k in tnames]))
    # the shards' hi and lo words each meet in a psum (another order in the
    # reference's all-reduce): sums within rel 1e-6, the rest exact.  A
    # group with a NaN row: the port's reduce keeps the NaN (the merge of
    # its single-device path and of the reference's combine_states), the
    # reference's cross-shard pmin drops it
    nan_groups = _nan_groups(seeds=[9], n=8 * 999 + 5)
    assert nan_groups.size  # the divergence is on this data
    _assert_x32_states(jspecs, jout, tspecs, tstate, nan_groups=nan_groups, spread=True)


# ------------------------------------------------------------------ B3
def _flush32(x: np.ndarray) -> np.ndarray:
    """float32 subnormals as the signed zeros XLA on the CPU gives."""
    x = np.asarray(x)
    if x.dtype != np.float32:
        return x
    sub = (x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)
    return np.where(sub, np.copysign(np.float32(0), x), x)


# XLA's CPU float32 transcendentals are its own polynomial approximations,
# torch's the platform's libm / SLEEF: they may round differently by a few
# units in the last place; everything else is bit-exact
_ULP_CASES = ("exp", "ln", "log", "sin", "cos", "tan", "power", "sqrt", "cbrt")


@pytest.mark.parametrize("name", sorted(SMOKE.expr_grid_cases()))
def test_expr_program_x32_matches_jax_compiler(name):
    build = SMOKE.expr_grid_cases()[name]
    batch = SMOKE.expr_grid_batch(4096, seed=5, mode="x32")
    program, leaves = SMOKE.expr_case(TK, tpe, batch.schema, build)
    assert program.mode == "x32"
    env = SMOKE.expr_env(TK, batch, leaves, CPU, mode="x32")
    n = batch.num_rows
    twin = TK.expr_program_reference(program, env, n, CPU)
    assert SMOKE.expr_diff(twin, TK.closures_layout(program, env, n, CPU)) is None
    comp = JK.JaxExprCompiler(batch.schema)
    closure = comp._lower_or_leaf(build(jpe, lambda c: jpe.Col(batch.schema.get_field_index(c), c)))
    jenv = {k: jnp.asarray(a) for k, a in JK.build_env(batch, comp.leaves, n).items()}
    v, val = closure(jenv)
    want = np.broadcast_to(np.asarray(v), (n,))
    want_valid = np.ones(n, bool) if val is None else np.broadcast_to(np.asarray(val), (n,))
    got = twin[2][0].numpy()
    got_valid = np.ones(n, bool) if twin[3][0] is None else twin[3][0].numpy()
    np.testing.assert_array_equal(got_valid, want_valid)
    got, want = _flush32(got[want_valid]), _flush32(want[want_valid])
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if got.dtype.kind == "f":
        assert np.array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        if any(k in name for k in _ULP_CASES):
            ulp = np.abs(got[ok].view(np.int32).astype(np.int64)
                         - want[ok].view(np.int32).astype(np.int64))
            assert ulp.max(initial=0) <= 4, (name, ulp.max())
        else:
            np.testing.assert_array_equal(got[ok], want[ok])
    else:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------ exits, the other routes
def _session(**extra):
    return tbt.SessionContext(tbt.BallistaConfig(settings(True, **extra)), device="cpu")


def _stats_table(n=4000, seed=17):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(rng.integers(0, 20, n)),
                     "x": pa.array(rng.uniform(0, 100, n)),
                     "y": pa.array(rng.uniform(0, 100, n))})


@pytest.mark.parametrize("sql", [
    "select k, median(x) from t group by k",
    "select k, count(distinct x) from t group by k",
    "select k, corr(x, y) from t group by k",
    "select k, stddev(x) from t group by k",
    "select k, var_pop(x) from t group by k",
])
def test_x32_statistical_aggregates_match_reference(sql):
    """Median, count distinct, corr and the variance family in x32: the
    port answers as the reference does, on the same route."""
    from test_torch_x32_routes import x32_three

    pm, _jm, _ = x32_three(sql, {"t": _stats_table()})
    assert pm.get("tpu_fallback", 0) == 0 and pm.get("device_time_ns", 0) > 0, pm


def test_x32_keyed_route_matches_reference(monkeypatch):
    """Groups ~ rows under highcard_mode=device: the stage switches to the
    keyed route on its first batch, in x32 as in x64."""
    import arrow_ballista_tpu.ops.stage_compiler as JSC
    import arrow_ballista_tpu_torch.ops.stage_compiler as SC
    from test_torch_x32_routes import x32_three

    monkeypatch.setattr(SC, "HIGHCARD_MIN_GROUPS", 16)
    monkeypatch.setattr(JSC, "_HIGHCARD_MIN_GROUPS", 16)
    n = 4000
    t = pa.table({"k": pa.array(np.arange(n) * 7), "v": pa.array(np.ones(n))})
    pm, jm, _ = x32_three("select k, sum(v) from t group by k", {"t": t},
                          **{"ballista.tpu.highcard_mode": "device"})
    assert pm.get("keyed_path", 0) >= 1 and jm.get("keyed_path", 0) >= 1, (pm, jm)


def test_x32_window_matches_reference():
    from arrow_ballista_tpu.ops.window_compiler import TpuWindowExec
    from arrow_ballista_tpu_torch.ops.window_compiler import TorchWindowExec
    from test_torch_x32_routes import assert_x32_equal, stages

    import arrow_ballista_tpu as jbt

    sql = "select k, sum(x) over (partition by k order by y) as s from t"
    outs = []
    for mod, cls, tpu in ((tbt, TorchWindowExec, True), (jbt, TpuWindowExec, True),
                          (jbt, None, False)):
        cfg = mod.BallistaConfig(settings(tpu))
        ctx = (mod.SessionContext(cfg, device="cpu") if mod is tbt
               else mod.SessionContext(cfg))
        ctx.register_arrow_table("t", _stats_table(), partitions=1)
        plan = ctx.sql(sql).physical_plan()
        outs.append((ctx.execute(plan), stages(plan, cls) if cls else []))
    (got, tn), (jgot, jn), (want, _) = outs
    assert tn and jn and all(n._mode == "x32" for n in tn)
    assert_x32_equal(want, got, "port")
    assert_x32_equal(want, jgot, "JAX")


def test_x32_join_fold_matches_reference():
    from benchmarks.tpch.queries import QUERIES
    from test_torch_x32_routes import x32_three

    pm, _jm, _ = x32_three(QUERIES[3], {n: tpch(n) for n in ("lineitem", "orders",
                                                              "customer")})
    assert pm.get("join_fallback", 0) == 0 and pm.get("tpu_fallback", 0) == 0, pm


def test_x32_exchange_int64_pair_layout_matches_reference():
    """The exchange's layouts in x32: strings as dictionary codes, int32 as
    itself, int64, f64 and timestamps as (lo, hi) int32 words; each
    schema's exchanged batches equal to the reference's."""
    for schema, cols in (
        (pa.schema([("s", pa.string()), ("i", pa.int32())]),
         [pa.array(["a", None, "b", "a"] * 4), pa.array(np.arange(16, dtype=np.int32))]),
        (pa.schema([("v", pa.int64())]),
         [pa.array(np.arange(16, dtype=np.int64) * (1 << 40) - (1 << 43))]),
        (pa.schema([("v", pa.float64())]), [pa.array(np.linspace(-1e300, 1e300, 16))]),
        (pa.schema([("v", pa.timestamp("us"))]),
         [pa.array((np.arange(16) * 10**15).astype("datetime64[us]"))]),
    ):
        batch = pa.RecordBatch.from_arrays(cols, schema=schema)
        dest = (np.arange(16) % 2).astype(np.int32)
        outs = []
        for M, mesh in ((JM, JM.make_mesh(2)), (TM, TM.make_mesh(2, "cpu"))):
            ex = M.BatchExchanger(mesh, schema, 8)
            recv, rv, dropped = ex.exchange(dest, np.ones(16, bool), ex.to_columns(batch))
            assert dropped == 0
            outs.append(([k for k, _ in ex.layout], ex.to_batches(recv, rv)))
        (jl, jb), (tl, tb) = outs
        assert jl == tl
        assert all(a.equals(b) for a, b in zip(jb, tb))
        assert pa.Table.from_batches(tb).sort_by(
            [(schema.names[-1], "ascending")]).equals(
            pa.Table.from_batches([batch]).sort_by([(schema.names[-1], "ascending")]))


def test_x32_range_error_reruns_and_other_device_errors_raise(monkeypatch):
    """The x32 range exit re-runs the partition on the CPU operators
    (``tpu_fallback``); any other error inside the device stage raises."""
    big = 3_000_000_000
    t = pa.table({"k": pa.array([1, 2, 1]), "v": pa.array([big, 1, 2])})
    ctx = _session(**{"ballista.mesh.enable": "false"})
    ctx.register_arrow_table("t", t, partitions=1)
    plan = ctx.sql("select k, sum(v) as s from t group by k order by k").physical_plan()
    assert ctx.execute(plan).column("s").to_pylist() == [big + 2, 1]
    assert port_metrics(plan).get("tpu_fallback", 0) == 1

    def broken(*args, **kwargs):
        raise RuntimeError("device failure")

    monkeypatch.setattr(TK, "df32_agg", broken)
    t = pa.table({"k": pa.array([1, 2, 1]), "v": pa.array([3.0, 1.0, 2.0])})
    ctx = _session(**{"ballista.mesh.enable": "false", "ballista.tpu.cache_columns": "false"})
    ctx.register_arrow_table("t", t, partitions=1)
    with pytest.raises(RuntimeError, match="device failure"):
        ctx.sql("select k, sum(v) as s from t group by k").collect()


def test_cache_entries_never_cross_modes():
    """The same query under x64, then x32, on one session: two cache
    entries (the mode is in the signature), each run right, and the x32
    run's states x32."""
    from arrow_ballista_tpu_torch.ops import device_cache
    from benchmarks.tpch.queries import QUERIES

    device_cache.clear()
    ctx = _session(**{"ballista.mesh.enable": "false"})
    ctx.register_arrow_table("lineitem", tpch("lineitem"), partitions=1)
    cpu = tbt.SessionContext(tbt.BallistaConfig(settings(False)), device="cpu")
    cpu.register_arrow_table("lineitem", tpch("lineitem"), partitions=1)
    want = cpu.sql(QUERIES[1]).collect()
    outs = []
    for mode in ("x64", "x32", "x32", "x64"):
        TK.set_precision(mode)
        plan = ctx.sql(QUERIES[1]).physical_plan()
        outs.append((ctx.execute(plan), port_metrics(plan)))
    TK.set_precision("x32")
    assert device_cache.stats()["entries"] == 2
    hits = [m.get("cache_hits", 0) for _, m in outs]
    assert hits == [0, 0, 1, 1], hits
    from test_torch_precision_x32 import assert_close

    for (got, _), rel in zip(outs, (1e-9, REL, REL, 1e-9)):
        assert_close(want, got, "cache", rel=rel)
    device_cache.clear()
