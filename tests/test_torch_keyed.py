"""The PyTorch port's keyed route against the JAX package's.

The keyed route assigns group ids on the device: the key encode (B7a)
codes the raw key columns per batch, one stable radix sort orders the
buffered rows by (not mask, *codes), the gid kernel (B7b) numbers the
groups from key changes, the segmented scan reduces every aggregate and
the finish (B8) gathers each group's key codes into one fetch.

Kernel twins (the port's plain PyTorch versions, which the CUDA kernels
are held to on the card) are compared with the JAX package's functions
on the same seeded numpy inputs: codes, group ids, permutations and
packed integer words bit for bit, f64 sums within rel 1e-9.  The port's
identity key codes are zigzag images (``bridge.IdentityKeyEncoder``), the
reference's are value + 1, so identity codes are held to the port's host
encoder and, for non-negative keys, to ``2 * (value + 1) - 1``.

Whole stages run three ways on the same tables — the port's
``SessionContext(device="cpu")``, the JAX package's ``TpuStageExec`` (x64
on the CPU) and the JAX package's CPU operators — and must agree (floats
within rel 1e-9, everything else exact) and route alike.  These are the
x64 cases of ``tests/test_keyed_agg.py``, ``tests/test_device_key_encode.py``
and ``tests/test_packed_sort.py``.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu.catalog import MemoryTable as JMemoryTable
from arrow_ballista_tpu.exec import expressions as jpe
from arrow_ballista_tpu.ops import bridge as JB
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu.ops import stage_compiler as JSC
from arrow_ballista_tpu_torch.catalog import MemoryTable as TMemoryTable
from arrow_ballista_tpu_torch.exec import expressions as tpe
from arrow_ballista_tpu_torch.ops import bridge as TB
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops import stage_compiler as TSC

REL = 1e-9
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _x64_small_threshold(monkeypatch):
    """The JAX package in x64 on the CPU; both detectors shrunk so small
    fixtures count as groups ~ rows."""
    old = JK._PRECISION["mode"]
    JK.set_precision("x64")
    monkeypatch.setattr(JSC, "_HIGHCARD_MIN_GROUPS", 16)
    monkeypatch.setattr(TSC, "HIGHCARD_MIN_GROUPS", 16)
    try:
        yield
    finally:
        JK._PRECISION["mode"] = old


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------- key encode (B7a)
def _jax_code(kind, vals, valid):
    return np.asarray(JK.make_key_encode_kernel((kind,))(
        ((jnp.asarray(vals), jnp.asarray(valid)),))[0])


def _port_code(kind, vals, valid):
    host = TK.key_host_values(kind, vals)
    _inv, codes = TK.key_encode_reference(
        (kind,), ((_t(host), None if valid is None else _t(valid)),), (), len(vals), CPU
    )
    return codes[0].numpy()


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.int16, np.uint32])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ident_codes_match_host_encoder_and_reference(dtype, seed):
    rng = np.random.default_rng(seed)
    n = 4000
    hi = min(np.iinfo(dtype).max, 10**9)
    vals = rng.integers(0, hi, n).astype(dtype)
    valid = rng.random(n) > 0.1
    got = _port_code("ident", vals, valid)
    host = TB.IdentityKeyEncoder().encode(pa.array(vals, mask=~valid))
    assert np.array_equal(got, host)
    ref = _jax_code("ident", vals.astype(np.int64), valid).astype(np.int64)
    assert np.array_equal(got, np.where(valid, 2 * ref - 1, 0))


def test_ident_codes_date32():
    days = np.array([0, 9000, 10471, -5, 2000, 19000], dtype=np.int32)
    valid = np.array([True, True, False, True, True, True])
    arr = pa.array(days.astype("datetime64[D]"), pa.date32(), mask=~valid)
    vals, _ = TB.arrow_to_numpy(arr)
    got = _port_code("ident", vals, valid)
    assert np.array_equal(got, TB.IdentityKeyEncoder().encode(arr))
    dec = TB.IdentityKeyEncoder().decode(got, pa.date32())
    assert dec.to_pylist() == arr.to_pylist()


def test_ident_codes_wide_i64_and_negative_keys():
    """Keys past 2^32 and negative keys code on the device (the reference
    has no device code for negative keys and re-runs on the CPU)."""
    vals = np.array([2**40, -(2**40), -1, 0, 1, 2**60 - 1, -(2**60)], np.int64)
    got = _port_code("ident", vals, None)
    assert np.array_equal(got, TB.IdentityKeyEncoder().encode(pa.array(vals)))
    dec = TB.IdentityKeyEncoder().decode(got, pa.int64())
    assert dec.to_pylist() == vals.tolist()
    with pytest.raises(jbt.errors.ExecutionError):
        JB.IdentityKeyEncoder().encode(pa.array(vals))


@pytest.mark.parametrize("seed", [1, 2])
def test_bool_codes_match_reference(seed):
    rng = np.random.default_rng(seed)
    vals = rng.random(3000) > 0.5
    valid = rng.random(3000) > 0.2
    got = _port_code("bool", vals, valid)
    assert np.array_equal(got, _jax_code("bool", vals, valid))
    assert np.array_equal(got, TB.BoolKeyEncoder().encode(pa.array(vals, mask=~valid)))


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_float_codes_match_reference(f64, seed):
    rng = np.random.default_rng(seed)
    n = 3000
    dt = np.float64 if f64 else np.float32
    vals = rng.normal(0, 100, n).astype(dt)
    vals[::13] = -0.0
    vals[::17] = 0.0
    vals[::19] = np.nan
    vals[5] = np.inf
    valid = rng.random(n) > 0.15
    kind = "f64" if f64 else "f32"
    got = _port_code(kind, vals, valid)
    assert np.array_equal(got, _jax_code(kind, vals, valid).astype(np.int64))
    host = TB.FloatKeyEncoder(kind).encode(pa.array(vals, mask=~valid))
    assert np.array_equal(got, host)


def test_float_reserved_null_pattern_has_no_code():
    bad = np.array([TK.FLOAT64_NULL_BITS], np.int64).view(np.float64)
    with pytest.raises(tbt.errors.ExecutionError):
        TB.FloatKeyEncoder("f64").encode(pa.array(np.concatenate([[1.0], bad])))


def test_device_key_encoder_selection_matches_reference():
    for t in (pa.int64(), pa.int32(), pa.date32(), pa.bool_(), pa.float32(),
              pa.float64(), pa.string()):
        _enc, kind = TB.device_key_encoder(t, "x64")
        _jenc, jkind = JB.device_key_encoder(t, "x64")
        assert kind == jkind, t


def test_key_encode_folds_the_row_masks():
    rng = np.random.default_rng(4)
    n = 1000
    masks = [_t(rng.random(n) > 0.3) for _ in range(3)]
    codes = _t(rng.integers(0, 9, n).astype(np.int32))
    inv, out = TK.key_encode_reference(("code",), ((codes,),), tuple(masks), n, CPU)
    want = ~(masks[0] & masks[1] & masks[2])
    assert torch.equal(inv, want.to(torch.int32))
    assert out[0] is codes


# ---------------------------------------------- keyed sort and gids (B7b)
def _sort_both(mask, keys):
    out = JK.keyed_sort_kernel(len(keys))(jnp.asarray(mask), *map(jnp.asarray, keys))
    perm, gids, n_groups = TK.keyed_sort(_t((~mask).astype(np.int32)), [_t(k) for k in keys])
    assert n_groups == int(out[-1])
    assert np.array_equal(perm.numpy(), np.asarray(out[1]))
    assert np.array_equal(gids["s2"].numpy(), np.asarray(out[0]))
    for a, b in zip(gids["sk"], out[2:-1]):
        assert np.array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64))
    return perm, gids, n_groups


SORT_CASES = {
    "one_i32_key": lambda rng, n: [rng.integers(0, 700, n).astype(np.int32)],
    "two_keys_ties": lambda rng, n: [rng.integers(0, 5, n).astype(np.int32),
                                     rng.integers(0, 30, n).astype(np.int64)],
    "extreme_i32": lambda rng, n: [rng.choice(np.array(
        [np.iinfo(np.int32).min, -1, 0, 1, np.iinfo(np.int32).max], np.int32), n)],
    "extreme_i64_three_keys": lambda rng, n: [
        rng.choice(np.array([np.iinfo(np.int64).min, -(2**40), 0, 2**40,
                             np.iinfo(np.int64).max]), n),
        rng.integers(-3, 3, n).astype(np.int32),
        rng.integers(0, 2, n).astype(np.int64)],
    "float_bits": lambda rng, n: [rng.normal(size=n).round(1).view(np.int64)],
}


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_keyed_sort_twin_matches_reference(case):
    rng = np.random.default_rng(len(case))
    n = 5000
    mask = rng.random(n) > 0.25
    _, gids, n_groups = _sort_both(mask, SORT_CASES[case](rng, n))
    starts = gids["starts"].numpy()
    s2 = gids["s2"].numpy()
    assert starts[n_groups] == int(mask.sum())
    assert np.array_equal(s2[starts[:n_groups]], np.arange(n_groups))


def test_keyed_sort_all_rows_masked():
    mask = np.zeros(100, bool)
    _, gids, n_groups = _sort_both(mask, [np.arange(100, dtype=np.int32)])
    assert n_groups == 0 and (gids["s2"] == TK.INT32_MAX).all()


# ------------------------------------------------ packed-sort order contract
def _packed_order(keys):
    iota = jnp.arange(len(keys[0]), dtype=jnp.int32)
    perm, sk = JK.packed_multikey_sort(tuple(jnp.asarray(k) for k in keys), iota)
    return np.asarray(perm), [np.asarray(k) for k in sk]


ORDER_CASES = {
    "extreme_single": [np.array([2**31 - 1, -(2**31), 0, -1, 1, 2**31 - 1, -(2**31)],
                                np.int32)],
    "two_keys_ties": [np.array([1, 0, 1, 0, 1, 0, 1], np.int32),
                      np.array([3, 3, 2, 2, 3, 3, 2], np.int32)],
    "three_keys_odd": [np.array([0, 0, 1, 1, 0, 1], np.int32),
                       np.array([-5, 5, -5, 5, 5, -5], np.int32),
                       np.array([7, 7, 7, 7, 7, 7], np.int32)],
    "random_four_keys": [np.random.default_rng(5).integers(-3, 3, 2000).astype(np.int32)
                         for _ in range(4)],
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_radix_sort_twin_gives_the_packed_sort_order(case):
    keys = ORDER_CASES[case]
    perm, sk = _packed_order(keys)
    got = TK.radix_argsort_reference([_t(k) for k in keys]).numpy()
    assert np.array_equal(got, perm)
    for k, s in zip(keys, sk):
        assert np.array_equal(k[got], s)


@pytest.mark.parametrize("width", [np.int32, np.int64])
def test_radix_sort_twin_orders_int64_like_lexsort(width):
    """The reference packs only i32 operands (``packed_multikey_sort``
    returns None for i64); the port's sort takes i64 keys directly."""
    rng = np.random.default_rng(8)
    keys = [rng.integers(-(2**40), 2**40, 3000).astype(width) if width is np.int64
            else rng.integers(-9, 9, 3000).astype(width),
            rng.integers(-4, 4, 3000).astype(np.int64)]
    if width is np.int32:
        assert JK.packed_multikey_sort(tuple(jnp.asarray(k) for k in keys),
                                       jnp.arange(3000, dtype=jnp.int32)) is None
    got = TK.radix_argsort_reference([_t(k) for k in keys]).numpy()
    assert np.array_equal(got, np.lexsort(tuple(reversed(keys)), axis=0))


# ----------------------------------------------------- keyed finish (B8)
FINISH_CASES = [3, 4, "skew", "one_row", "all_masked", "full"]


def finish_keys(case: str, rng, n: int, mask):
    """The row mask and two int32 key columns of a named finish shape:
    "skew" 4 groups, one holding 90% of the rows; "one_row" every row its
    own group; "all_masked" no valid row; "full" 256 groups, all present,
    so n_groups is the capacity."""
    if case == "skew":
        g = np.where(rng.random(n) < 0.9, 0, rng.integers(1, 4, n))
        return mask, [(g // 2).astype(np.int32), (g % 2).astype(np.int32)]
    if case == "one_row":
        return mask, [rng.permutation(n).astype(np.int32), np.zeros(n, np.int32)]
    if case == "all_masked":
        return np.zeros(n, bool), [rng.integers(0, 300, n).astype(np.int32),
                                   rng.integers(0, 3, n).astype(np.int32)]
    if case == "full":
        return mask, [rng.integers(0, 128, n).astype(np.int32),
                      rng.integers(0, 2, n).astype(np.int32)]
    raise ValueError(case)


def _finish_inputs(seed=3, n=4000):
    """Seeded finish inputs; a named case (:func:`finish_keys`) draws its
    values from seed 5 and replaces the mask and keys."""
    case = seed
    rng = np.random.default_rng(seed if isinstance(seed, int) else 5)
    v = rng.uniform(-50, 50, n)
    v[::23] = np.nan
    w = rng.integers(-(10**12), 10**12, n)
    batch = pa.RecordBatch.from_pydict({
        "v": pa.array(v, mask=rng.random(n) < 0.1),
        "w": pa.array(w, pa.int64(), mask=rng.random(n) < 0.05),
    })
    mask = rng.random(n) > 0.2
    keys = [rng.integers(0, 300, n).astype(np.int32), rng.integers(0, 3, n).astype(np.int32)]
    if not isinstance(case, int):
        mask, keys = finish_keys(case, rng, n, mask)
    return batch, mask, keys


# (func, column, int_minmax)
FINISH_SPECS = [("count_star", None, False), ("sum", "v", False), ("min", "v", False),
                ("max", "v", False), ("avg", "v", False), ("count", "v", False),
                ("min", "w", True), ("max", "w", True)]


def _jax_finish(batch, mask, keys):
    comp = JK.JaxExprCompiler(batch.schema)
    closures, specs = [], []
    for func, col, imm in FINISH_SPECS:
        has = col is not None
        specs.append(JK.KernelAggSpec(func, has, int_minmax=imm))
        closures.append(comp._lower(jpe.Col(batch.schema.get_field_index(col), col))
                        if has else None)
    flat = JK.flat_arg_names(comp.leaves)
    env = JK.build_env(batch, comp.leaves, batch.num_rows)
    holder: dict = {}
    prep = JK.make_keyed_prep_kernel(None, closures, specs, flat, holder)
    out = prep(tuple(jnp.asarray(k) for k in keys), jnp.asarray(mask),
               *[jnp.asarray(env[nm]) for nm in flat])
    n_keys = len(keys)
    srt = JK.keyed_sort_kernel(n_keys)(out[0], *out[1:1 + n_keys])
    n_groups = int(srt[-1])
    cap = max(64, 1 << (max(n_groups, 1) - 1).bit_length())
    packed = JK.keyed_finish_kernel(holder["kinds"], holder["plan"], specs, n_keys,
                                    cap, "x64")(srt[0], srt[1], tuple(srt[2:-1]),
                                                tuple(out[1 + n_keys:]))
    return np.asarray(packed), specs, n_groups, cap


def _port_finish(batch, mask, keys):
    comp = TK.TorchExprCompiler(batch.schema)
    closures, specs = [], []
    for func, col, imm in FINISH_SPECS:
        has = col is not None
        specs.append(TK.KernelAggSpec(func, has, int_minmax=imm))
        closures.append(comp._lower(tpe.Col(batch.schema.get_field_index(col), col))
                        if has else None)
    flat = TK.flat_arg_names(comp.leaves)
    env = TB.DeviceStaging(CPU).put(TK.build_env(batch, comp.leaves, batch.num_rows))
    prep = TK.make_keyed_prep_kernel(None, closures, specs, flat, ("code",) * len(keys))
    kb = prep([(_t(k),) for k in keys], _t(mask), *[env[nm] for nm in flat])
    perm, gids, n_groups = TK.keyed_sort(kb.inv, kb.codes)
    cap = max(64, 1 << (max(n_groups, 1) - 1).bit_length())
    _columns, ops, cols = prep.layout
    columns, field_col = TK._build_scan_plan(kb.values, kb.valids, ops, cols)
    packed = TK.keyed_finish(specs, columns, field_col, ops, perm, gids, n_groups, cap)
    return packed.numpy(), specs, n_groups, cap


@pytest.mark.parametrize("seed", FINISH_CASES)
def test_keyed_finish_twin_matches_reference(seed):
    batch, mask, keys = _finish_inputs(seed)
    jp, jspecs, jng, jcap = _jax_finish(batch, mask, keys)
    tp, tspecs, tng, tcap = _port_finish(batch, mask, keys)
    assert (jng, jcap) == (tng, tcap)
    assert {"full": jng == jcap, "all_masked": jng == 0, "one_row": jng == mask.sum(),
            "skew": jng == 4}.get(seed, True)
    jstates, jkeys = JK.unpack_keyed_host(jspecs, jp, "x64", len(keys))
    tstates, tkeys = TK.unpack_keyed_host(tspecs, tp, len(keys))
    for a, b in zip(jkeys, tkeys):
        assert np.array_equal(a, b)
    assert len(jstates) == len(tstates)
    for f, (a, b) in enumerate(zip(jstates, tstates)):
        a, b = a[:jng], b[:tng]
        if a.dtype.kind == "f":
            # sums add in another order; -0.0 of JAX's scan is +0.0
            assert np.array_equal(np.isnan(a), np.isnan(b)), f
            ok = ~np.isnan(a)
            np.testing.assert_allclose(b[ok], a[ok], rtol=REL, atol=0)
        else:
            assert np.array_equal(a, b.astype(a.dtype)), f
    if seed == "all_masked":  # every slot holds its identity
        for f, (a, b) in enumerate(zip(jstates, tstates)):
            assert np.array_equal(a, b.astype(a.dtype)), f


def test_merge_keyed_host_matches_reference():
    rng = np.random.default_rng(12)
    specs_t = [TK.KernelAggSpec("sum", True), TK.KernelAggSpec("min", True),
               TK.KernelAggSpec("max", True, int_minmax=True),
               TK.KernelAggSpec("count_star", False)]
    specs_j = [JK.KernelAggSpec("sum", True), JK.KernelAggSpec("min", True),
               JK.KernelAggSpec("max", True, int_minmax=True),
               JK.KernelAggSpec("count_star", False)]

    def chunk(m):
        keys = [np.sort(rng.choice(50, m, replace=False)).astype(np.int64),
                rng.integers(0, 2, m).astype(np.int64)]
        states = [rng.uniform(-9, 9, m), rng.integers(1, 5, m),
                  rng.uniform(-9, 9, m), rng.integers(1, 5, m),
                  rng.integers(-99, 99, m), rng.integers(1, 5, m),
                  rng.integers(1, 5, m), rng.integers(1, 5, m)]
        return states, keys, m

    chunks = [chunk(m) for m in (30, 40, 0, 25)]
    got = TK.merge_keyed_host(specs_t, chunks)
    want = JK.merge_keyed_host(specs_j, "x64", chunks)
    assert got[2] == want[2]
    for a, b in zip(got[1], want[1]):
        assert np.array_equal(a, b)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_allclose(a, b, rtol=REL, atol=0)


# -------------------------------------------------------- whole stages
def _ctx_settings(tpu: bool, extra: dict) -> dict:
    s = {"ballista.tpu.enable": str(tpu).lower(), "ballista.tpu.min_rows": "0",
         "ballista.mesh.enable": "false", "ballista.tpu.highcard_mode": "device"}
    s.update({k: str(v) for k, v in extra.items()})
    return s


def _metrics(plan, cls) -> dict:
    m: dict = {}
    stack = [plan]
    while stack:
        nd = stack.pop()
        if isinstance(nd, cls):
            for k, v in nd.metrics.to_dict().items():
                m[k] = m.get(k, 0) + v
        stack.extend(nd.children())
    return m


def _assert_equal(a: pa.Table, b: pa.Table, what: str = ""):
    assert a.schema.names == b.schema.names, what
    assert a.num_rows == b.num_rows, (what, a.num_rows, b.num_rows)
    # sorted by every column, the non-float ones first (float group keys
    # order the rest; float aggregates only break ties)
    names = a.column_names
    key = [(c, "ascending") for c in names
           if not pa.types.is_floating(a.schema.field(c).type)]
    key += [(c, "ascending") for c in names if (c, "ascending") not in key]
    a, b = a.sort_by(key), b.sort_by(key)
    for name in a.schema.names:
        for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
            if isinstance(x, float) and x is not None and y is not None:
                assert y == pytest.approx(x, rel=REL, nan_ok=True), (what, name)
            else:
                assert x == y, (what, name, x, y)


def three_ways(sql: str, tables: dict, parts: int = 1, batches=None, budget=None,
               **extra):
    """(port metrics, JAX metrics) after asserting that the port, the JAX
    device stage and the JAX CPU operators give the same answer.
    ``batches`` cuts each table into record batches of that many rows;
    ``budget`` sets every device stage's keyed buffer budget in bytes."""
    out = []
    for mod, mem, cls, tpu in (
        (tbt, TMemoryTable, TSC.TorchStageExec, True),
        (jbt, JMemoryTable, JSC.TpuStageExec, True),
        (jbt, JMemoryTable, None, False),
    ):
        cfg = mod.BallistaConfig(_ctx_settings(tpu, extra))
        ctx = mod.SessionContext(cfg, device="cpu") if mod is tbt else mod.SessionContext(cfg)
        for name, t in tables.items():
            if batches:
                rb = t.to_batches(max_chunksize=batches)
                ctx.register_table(name, mem([rb], t.schema))
            else:
                ctx.register_table(name, mem.from_table(t, parts))
        plan = ctx.sql(sql).physical_plan()
        if budget is not None and cls is not None:
            stack = [plan]
            while stack:
                nd = stack.pop()
                if isinstance(nd, cls):
                    nd.keyed_buffer_bytes = budget
                stack.extend(nd.children())
        got = ctx.execute(plan)
        out.append((got, _metrics(plan, cls) if cls else None))
    (port, pm), (jax_, jm), (want, _) = out
    _assert_equal(port, want, "port vs the CPU operators")
    _assert_equal(jax_, want, "JAX vs the CPU operators")
    return pm, jm


def _highcard_table(n=4000, n_groups=1000, seed=7):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, n_groups, n).astype(np.int64)
    return pa.table({
        "k": pa.array(k),
        "ks": pa.array(np.char.add("key", k.astype("U4")).tolist()),
        "s": pa.array(np.char.add("tag", rng.integers(0, 40, n).astype("U3")).tolist()),
        "v": pa.array(rng.uniform(0, 100, n)),
        "w": pa.array(rng.integers(0, 1000, n).astype(np.int64)),
    })


def _keyed(pm, jm, fallback=0):
    for m in (pm, jm):
        assert m.get("keyed_path", 0) >= 1, m
        assert m.get("tpu_fallback", 0) == fallback, m
        assert m.get("highcard_fallback", 0) == 0, m


KEYED_CASES = {
    "single_int_key": ("select k, sum(v) as s, count(*) as c, min(w) as mn, max(w) as mx, "
                       "avg(v) as a from t group by k", {}),
    "multi_key_int_and_string": ("select k, s, sum(v) as sv, count(w) as cw from t "
                                 "group by k, s", {}),
    "multi_batch_buffering": ("select k, sum(v) as s, count(*) as c from t group by k",
                              {"batches": 1500}),
    "with_filter": ("select k, sum(v) as s, count(*) as c from t where v > 30 and w < 900 "
                    "group by k", {}),
    "multi_batch_minmax_with_median": ("select k, min(v) as mn, max(v) as mx, sum(v) as s, "
                                       "median(v) as md, count(*) as c from t group by k",
                                       {"parts": 2}),
    "string_key_only": ("select ks, sum(w) as sw, max(v) as mx from t group by ks", {}),
}


@pytest.mark.parametrize("case", sorted(KEYED_CASES))
def test_keyed_stage_matches_jax_and_cpu(case):
    sql, kw = KEYED_CASES[case]
    pm, jm = three_ways(sql, {"t": _highcard_table(n=6000)}, **kw)
    _keyed(pm, jm)


def test_keyed_null_keys_and_null_values():
    rng = np.random.default_rng(3)
    n = 3000
    kmask = rng.uniform(size=n) < 0.05
    t = pa.table({
        "k": pa.array(rng.integers(0, 800, n), pa.int64(), mask=kmask),
        "v": pa.array(rng.uniform(0, 10, n), pa.float64(), mask=rng.uniform(size=n) < 0.1),
    })
    pm, jm = three_ways("select k, sum(v) as s, count(v) as c, count(*) as n from t "
                        "group by k", {"t": t})
    _keyed(pm, jm)


def _dim_fact(seed, m_dim, n):
    rng = np.random.default_rng(seed)
    dim = pa.table({"dk": pa.array(np.arange(1, m_dim + 1).astype(np.int64)),
                    "dv": pa.array(rng.uniform(0.5, 1.5, m_dim)),
                    "dtag": pa.array(rng.integers(0, 3, m_dim).astype(np.int64))})
    fact = pa.table({"fk": pa.array(rng.integers(1, int(m_dim * 1.2), n).astype(np.int64)),
                     "v": pa.array(rng.uniform(0, 100, n))})
    return dim, fact


def test_keyed_with_device_join():
    """q3-shaped: the PK-FK join folded into the keyed stage, group key =
    the probe join key."""
    dim, fact = _dim_fact(11, 600, 5000)
    pm, jm = three_ways("select fk, sum(v * dv) as s, count(*) as c from dim, fact "
                        "where dk = fk and dtag < 2 group by fk", {"dim": dim, "fact": fact})
    _keyed(pm, jm)
    for m in (pm, jm):
        assert m.get("join_fallback", 0) == 0 and m.get("dense_join", 0) == 1, m


def test_keyed_partitions_route_independently():
    pm, jm = three_ways("select k, sum(v) as s from t group by k",
                        {"t": _highcard_table(n=6000)}, parts=3)
    assert pm.get("keyed_path", 0) == jm.get("keyed_path", 0) >= 2


def test_keyed_over_max_capacity_falls_back_correct():
    pm, jm = three_ways("select k, sum(v) as s from t group by k",
                        {"t": _highcard_table(n=3000, n_groups=2500)},
                        **{"ballista.tpu.max_capacity": "256"})
    assert pm.get("tpu_fallback", 0) >= 1 and jm.get("tpu_fallback", 0) >= 1


def test_keyed_highcard_mode_cpu_preserves_hash_agg_handoff():
    pm, jm = three_ways("select k, sum(v) as s from t group by k",
                        {"t": _highcard_table()}, **{"ballista.tpu.highcard_mode": "cpu"})
    for m in (pm, jm):
        assert m.get("highcard_fallback", 0) >= 1 and "keyed_path" not in m, m


def test_auto_mode_routes_to_hash_aggregate():
    """'auto' resolves to the builtin ``keyed_route_auto = False`` in both
    packages: groups ~ rows hands the stage to the CPU hash aggregate."""
    pm, jm = three_ways("select k, sum(v) as s, count(*) as c from t group by k",
                        {"t": _highcard_table(n=6000)},
                        **{"ballista.tpu.highcard_mode": "auto"})
    for m in (pm, jm):
        assert m.get("keyed_path", 0) == 0 and m.get("highcard_fallback", 0) >= 1, m


def _many_batch_table(n=40_000, n_groups=4000, seed=23):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(rng.integers(0, n_groups, n).astype(np.int64)),
                     "v": pa.array(rng.uniform(0, 100, n)),
                     "w": pa.array(rng.integers(0, 1000, n).astype(np.int64))})


def test_keyed_budget_chunks_and_merges():
    """Past the buffer budget each block reduces to its keyed states and
    the blocks merge by key on the host (``merge_keyed_host``)."""
    pm, jm = three_ways("select k, sum(v) as s, count(*) as c, min(v) as mn, max(v) as mx, "
                        "avg(w) as aw, min(w) as mnw from t group by k",
                        {"t": _many_batch_table()}, batches=2500, budget=256 * 1024)
    _keyed(pm, jm)
    assert pm.get("keyed_chunks", 0) >= 2 and jm.get("keyed_chunks", 0) >= 2
    assert pm["keyed_chunks"] == jm["keyed_chunks"]
    assert pm.get("keyed_merge_time_ns", 0) > 0


def test_keyed_budget_median_falls_back_before_oom():
    pm, jm = three_ways("select k, median(v) as md, count(*) as c from t group by k",
                        {"t": _many_batch_table(n=20_000)}, batches=2500,
                        budget=64 * 1024)
    assert pm.get("tpu_fallback", 0) >= 1 and jm.get("tpu_fallback", 0) >= 1


def test_keyed_budget_with_device_join():
    rng = np.random.default_rng(41)
    dim = pa.table({"dk": pa.array(np.arange(1, 501).astype(np.int64)),
                    "dv": pa.array(rng.uniform(0.5, 1.5, 500))})
    fact = pa.table({"fk": pa.array(rng.integers(1, 600, 24_000).astype(np.int64)),
                     "v": pa.array(rng.uniform(0, 100, 24_000))})
    pm, jm = three_ways("select fk, sum(v * dv) as s, min(v) as mn, count(*) as c "
                        "from dim, fact where dk = fk group by fk",
                        {"dim": dim, "fact": fact}, batches=3000, budget=128 * 1024)
    _keyed(pm, jm)
    for m in (pm, jm):
        assert m.get("keyed_chunks", 0) >= 2 and m.get("join_fallback", 0) == 0, m
    assert pm["keyed_chunks"] == jm["keyed_chunks"]


# ------------------------------------------- device key encode, end to end
def test_float_and_bool_keys_device_encoded():
    rng = np.random.default_rng(5)
    n = 3000
    fk = rng.integers(0, 300, n).astype(np.float64) / 4
    fk[::50] = -0.0
    fk[::77] = np.nan
    t = pa.table({"fk": pa.array(fk, mask=rng.random(n) < 0.05),
                  "b": pa.array(rng.random(n) > 0.5, mask=rng.random(n) < 0.05),
                  "v": pa.array(rng.uniform(0, 10, n))})
    pm, jm = three_ways("select fk, b, sum(v) as s, count(*) as c from t group by fk, b",
                        {"t": t})
    _keyed(pm, jm)
    for m in (pm, jm):
        assert m.get("device_encode_batches", 0) >= 1, m
    assert pm.get("key_encode_time_ns", 0) == 0, pm


def test_negative_int_keys_stay_on_the_keyed_route():
    """The port codes negative identity keys on the device (zigzag); the
    reference re-runs such a partition on the CPU.  Same answer."""
    rng = np.random.default_rng(6)
    t = pa.table({"k": pa.array(rng.integers(-400, 400, 3000)),
                  "v": pa.array(rng.uniform(0, 10, 3000))})
    pm, jm = three_ways("select k, sum(v) as s, count(*) as c from t group by k", {"t": t})
    assert pm.get("keyed_path", 0) == 1 and pm.get("tpu_fallback", 0) == 0, pm
    assert jm.get("tpu_fallback", 0) == 1, jm


def _record_fold_plans(monkeypatch) -> dict:
    """Every plan each package's ``_radix_combine_bits`` returns."""
    seen = {"port": [], "jax": []}
    for mod, name in ((TSC, "port"), (JSC, "jax")):
        inner = mod._radix_combine_bits

        def rec(key_state, n_keys, inner=inner, name=name):
            seen[name].append(inner(key_state, n_keys))
            return seen[name][-1]

        monkeypatch.setattr(mod, "_radix_combine_bits", rec)
    return seen


def test_wide_i64_multikey_stays_exact(monkeypatch):
    """A key past 2^40 with a narrow span: both packages decline the fold
    (codes past int32) and sort the keys unfolded in one dispatch."""
    plans = _record_fold_plans(monkeypatch)
    rng = np.random.default_rng(7)
    n = 3000
    t = pa.table({"k": pa.array((rng.integers(0, 300, n) + (1 << 40)).astype(np.int64)),
                  "p": pa.array(rng.integers(0, 4, n).astype(np.int64)),
                  "v": pa.array(rng.uniform(0, 10, n))})
    pm, jm = three_ways("select k, p, count(*) as c, sum(v) as s from t group by k, p",
                        {"t": t})
    _keyed(pm, jm)
    assert plans["port"] == plans["jax"] == [None], plans
    assert pm["fused_keyed_dispatches"] == jm["fused_keyed_dispatches"] == 1


def test_late_key_growth_past_i32_stays_exact(monkeypatch):
    """Batch 1 fits 32 bits, a later batch does not: the port ships
    identity keys as they come (no narrowing), so it stays keyed and runs
    its one key through the single dispatch unfolded; the reference
    re-runs the partition on the CPU before it plans a fold."""
    plans = _record_fold_plans(monkeypatch)
    rng = np.random.default_rng(8)
    k = rng.integers(0, 500, 6000).astype(np.int64)
    k[4000:] += 1 << 35
    t = pa.table({"k": pa.array(k), "v": pa.array(rng.uniform(0, 10, 6000))})
    pm, jm = three_ways("select k, sum(v) as s from t group by k", {"t": t}, batches=2000)
    assert pm.get("keyed_path", 0) == 1 and pm.get("tpu_fallback", 0) == 0, pm
    assert pm["fused_keyed_dispatches"] == 1 and plans["port"] == [None], (pm, plans)
    assert jm.get("tpu_fallback", 0) == 1 and jm.get("fused_keyed_dispatches", 0) == 0, jm
    assert plans["jax"] == [], plans


def test_device_encode_off_uses_host_codes():
    pm, jm = three_ways("select k, sum(v) as s from t group by k", {"t": _highcard_table()},
                        **{"ballista.tpu.device_encode": "false"})
    _keyed(pm, jm)
    assert pm.get("device_encode_batches", 0) == 0


def test_date32_group_key_device_encoded():
    rng = np.random.default_rng(9)
    days = rng.integers(-3000, 20000, 3000).astype("datetime64[D]")
    t = pa.table({"d": pa.array(days, pa.date32()),
                  "v": pa.array(rng.uniform(0, 10, 3000))})
    pm, _jm = three_ways("select d, sum(v) as s, min(d) as md from t group by d", {"t": t})
    assert pm.get("keyed_path", 0) == 1 and pm.get("device_encode_batches", 0) == 1, pm
