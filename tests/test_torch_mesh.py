"""The PyTorch port's mesh collectives against the JAX package, on the CPU.

Twins of ``tests/test_mesh.py``'s cases, plus the cross-shard reduce and
the route at 1, 3 and 8 shards with all-invalid and empty shards.  The JAX
side runs on the reference's 8 virtual CPU devices (``tests/conftest.py``);
the port's CPU mesh gets 8 shards by a fixture, and its kernels run their
plain twins.  The same seeded numpy inputs go to both.  Tolerance: states
ints exact and floats within rel 1e-9 (the shards' sums meet in another
order); the exchange bit for bit.
"""

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from arrow_ballista_tpu.exec import expressions as jpe
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu.parallel import mesh as JM
from arrow_ballista_tpu_torch.exec import expressions as tpe
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.parallel import mesh as TM

REL = 1e-9


@pytest.fixture(autouse=True)
def cpu8(monkeypatch):
    """The port's CPU mesh spans 8 shards, as the reference's does here;
    the reference pinned to x64 and its scatter route."""
    assert len(jax.devices()) >= 8, "conftest should force 8 virtual devices"
    monkeypatch.setattr(TM, "CPU_DEVICES", 8)
    old = JK._PRECISION["mode"]
    JK.set_precision("x64")
    JK.set_agg_algorithm("scatter")
    try:
        yield
    finally:
        JK.set_precision(old)
        JK.set_agg_algorithm(None)


def _kernels(specs_fn, capacity, n_args):
    """The same partial-agg function in both packages over one f64 column
    ``v``: ``n_args`` aggregates read it (the rest are count(*))."""
    schema = pa.schema([("v", pa.float64())])
    out = []
    for pe, K, Comp in ((jpe, JK, JK.JaxExprCompiler), (tpe, TK, TK.TorchExprCompiler)):
        comp = Comp(schema)
        arg = comp._lower(pe.Col(0, "v"))
        specs = specs_fn(K)
        closures = [arg] * n_args + [None] * (len(specs) - n_args)
        names = K.flat_arg_names(comp.leaves)
        out.append((specs, K.make_partial_agg_kernel(None, closures, specs, capacity, names)))
    return out


def _port_states(specs, state) -> list:
    return TK.unpack_host(specs, TK.fetch_states(state))


def _assert_states(jspecs, jout, tspecs, tstate, keep):
    roles = [r for s in jspecs for r in JK.state_fields(s, "x64")] + ["add"]
    got = _port_states(tspecs, tstate)
    assert len(got) == len(jout) == len(roles)
    for role, want, have in zip(roles, jout, got):
        want = np.asarray(want)[:keep]
        have = have[:keep]
        if want.dtype.kind == "f" and role == "add":
            np.testing.assert_allclose(have, want, rtol=REL, atol=0)
        else:
            np.testing.assert_array_equal(have, want)


# ------------------------------------------------------ test_mesh.py twins
def test_distributed_partial_agg_psum():
    capacity = 16
    (jspecs, jkern), (tspecs, tkern) = _kernels(
        lambda K: [K.KernelAggSpec("sum", True), K.KernelAggSpec("count_star", False)],
        capacity, 1,
    )
    n = 8 * 1000
    rng = np.random.default_rng(0)
    seg = rng.integers(0, 10, n).astype(np.int32)
    v = rng.normal(size=n)
    valid = np.ones(n, dtype=bool)

    jmesh = JM.make_mesh(8)
    jout = JM.make_distributed_agg_step(jkern, jspecs, jmesh, capacity)(
        *JM.shard_batch(jmesh, [seg, valid, v, valid])
    )
    tmesh = TM.make_mesh(8, "cpu")
    assert tmesh.size == 8
    tstate = TM.make_distributed_agg_step(tkern, tspecs, tmesh, capacity)(
        TM.shard_batch(tmesh, [seg, valid, v, valid])
    )
    _assert_states(jspecs, jout, tspecs, tstate, 10)
    sums, counts = _port_states(tspecs, tstate)[0], _port_states(tspecs, tstate)[2]
    for g in range(10):
        assert sums[g] == pytest.approx(v[seg == g].sum(), rel=1e-12)
        assert counts[g] == (seg == g).sum()


def _exchange_both(n_dev, cap, values, dest, valid):
    jmesh = JM.make_mesh(n_dev)
    jfn = JM.ici_all_to_all_repartition(jmesh, cap)
    jv, jok, jdrop = jfn(*JM.shard_batch(jmesh, [values, dest, valid]))
    tmesh = TM.make_mesh(n_dev, "cpu")
    tfn = TM.ici_all_to_all_repartition(tmesh, cap)
    tv, tok, tdrop = tfn(TM.shard_batch(tmesh, [values, dest, valid]))
    return (
        (np.asarray(jv), np.asarray(jok), int(jdrop)),
        (torch.cat(tv).numpy(), torch.cat(tok).numpy(), tdrop),
    )


def _assert_exchange_equal(jres, tres):
    (jv, jok, jdrop), (tv, tok, tdrop) = jres, tres
    assert tdrop == jdrop
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tv.view(np.int64), jv.view(np.int64))


def test_ici_all_to_all_repartition():
    n_dev, cap = 8, 64
    n = n_dev * 100
    rng = np.random.default_rng(1)
    values = rng.normal(size=n)
    dest = rng.integers(0, n_dev, n).astype(np.int32)
    valid = np.ones(n, dtype=bool)
    jres, tres = _exchange_both(n_dev, cap, values, dest, valid)
    _assert_exchange_equal(jres, tres)
    assert tres[2] == 0
    rv = tres[0].reshape(n_dev, n_dev * cap)
    rm = tres[1].reshape(n_dev, n_dev * cap)
    for d in range(n_dev):
        got = np.sort(rv[d][rm[d]])
        want = np.sort(values[dest == d])
        np.testing.assert_array_equal(got, want)


def test_sharded_agg_matches_single_device():
    capacity = 8
    (jspecs, jkern), (tspecs, tkern) = _kernels(
        lambda K: [K.KernelAggSpec("min", True), K.KernelAggSpec("max", True)],
        capacity, 2,
    )
    n = 8 * 64
    rng = np.random.default_rng(2)
    seg = rng.integers(0, 5, n).astype(np.int32)
    v = rng.normal(size=n)
    valid = np.ones(n, dtype=bool)
    jmesh = JM.make_mesh(8)
    jout = JM.make_distributed_agg_step(jkern, jspecs, jmesh, capacity)(
        *JM.shard_batch(jmesh, [seg, valid, v, valid])
    )
    tmesh = TM.make_mesh(8, "cpu")
    tmesh_state = TM.make_distributed_agg_step(tkern, tspecs, tmesh, capacity)(
        TM.shard_batch(tmesh, [seg, valid, v, valid])
    )
    t = [torch.from_numpy(a) for a in (seg, valid, v, valid)]
    single = tkern(*t, state=None)
    _assert_states(jspecs, jout, tspecs, tmesh_state, 5)
    np.testing.assert_array_equal(
        TK.fetch_states(tmesh_state)[:, :5], TK.fetch_states(single)[:, :5]
    )


def test_repartition_with_invalid_rows():
    n_dev, cap = 8, 32
    n = n_dev * 64
    rng = np.random.default_rng(3)
    values = rng.normal(size=n)
    dest = rng.integers(0, n_dev, n).astype(np.int32)
    valid = rng.random(n) < 0.5
    jres, tres = _exchange_both(n_dev, cap, values, dest, valid)
    _assert_exchange_equal(jres, tres)
    assert tres[2] == 0
    rv = tres[0].reshape(n_dev, n_dev * cap)
    rm = tres[1].reshape(n_dev, n_dev * cap)
    for d in range(n_dev):
        np.testing.assert_array_equal(
            np.sort(rv[d][rm[d]]), np.sort(values[valid & (dest == d)])
        )


# ------------------------------------------------ the kernels' twins vs JAX
def _shard_rows(n_dev: int, rows: int, layout: str):
    """Rows and validity for ``n_dev`` shards: "plain", "invalid" (shard 1,
    or the only one, all invalid) or "empty" (fewer rows than shards, so
    the last shards hold none)."""
    if layout == "empty":
        rows = max(1, n_dev // 2)
    valid = np.ones(rows, dtype=bool)
    if layout == "invalid":
        per = -(-rows // n_dev)
        s = 1 if n_dev > 1 else 0
        valid[s * per:(s + 1) * per] = False
    return rows, valid


@pytest.mark.parametrize("n_dev", [1, 3, 8])
@pytest.mark.parametrize("layout", ["plain", "invalid", "empty"])
def test_route_twin_matches_ici_batch_exchange(n_dev, layout):
    """The route twin and the block all-to-all give the reference's staged
    columns bit for bit, over int64, f64 (NaN and -0.0 included), int32 and
    bool columns, with a capacity below the largest bucket so rows drop."""
    rows, valid = _shard_rows(n_dev, 600, layout)
    rng = np.random.default_rng(40 + n_dev)
    dest = rng.integers(0, n_dev, rows).astype(np.int32)
    f = rng.normal(size=rows)
    f[::17] = np.nan
    f[5::19] = -0.0
    cols = [
        rng.integers(-(2**62), 2**62, rows),
        f,
        rng.integers(-(2**31), 2**31 - 1, rows).astype(np.int32),
        rng.random(rows) < 0.3,
    ]
    per = -(-rows // n_dev)
    shard_id = np.arange(rows) // per
    live = valid
    need = np.bincount(shard_id[live] * n_dev + dest[live], minlength=n_dev * n_dev)
    cap = max(1, int(need.max()) - 2) if layout == "plain" else max(1, int(need.max()))

    jmesh = JM.make_mesh(n_dev)
    jout = JM.ici_batch_exchange(jmesh, len(cols), cap)(
        *JM.shard_batch(jmesh, [dest, valid] + cols)
    )
    tmesh = TM.make_mesh(n_dev, "cpu")
    recv_cols, recv_valid, n_dropped = TM.ici_batch_exchange(tmesh, len(cols), cap)(
        TM.shard_batch(tmesh, [dest, valid] + cols)
    )
    assert n_dropped == int(jout[-1])
    if layout == "plain":
        assert n_dropped > 0
    np.testing.assert_array_equal(torch.cat(recv_valid).numpy(), np.asarray(jout[-2]))
    for c, want in enumerate(jout[:-2]):
        got = torch.cat(recv_cols[c]).numpy()
        want = np.asarray(want)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_route_twin_counts_out_of_range_destinations():
    """A valid row whose destination lies outside 0..n_dev-1 is never
    delivered and is counted as dropped (an invalid one is not)."""
    dest = torch.tensor([0, 5, 1, -1, 1, 7], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, True, False])
    vals = torch.arange(6, dtype=torch.int64)
    staged, sv, nd = TM.mesh_route(dest, valid, [vals], 2, 4)
    assert int(nd) == 2
    assert sv.tolist() == [[True, False, False, False], [True, True, False, False]]
    assert staged[0].tolist() == [[0, 0, 0, 0], [2, 4, 0, 0]]


@pytest.mark.parametrize("n_dev", [1, 3, 8])
@pytest.mark.parametrize("layout", ["plain", "invalid", "empty"])
def test_reduce_twin_matches_distributed_agg_step(n_dev, layout):
    """Every field role (f64 and int64 sums, counts, f64 min/max) through
    the port's step and the reference's on 1, 3 and 8 shards, with an
    all-invalid shard and with shards that hold no rows."""
    capacity = 16
    specs_fn = lambda K: [  # noqa: E731
        K.KernelAggSpec("sum", True), K.KernelAggSpec("min", True),
        K.KernelAggSpec("max", True), K.KernelAggSpec("avg", True),
        K.KernelAggSpec("count_star", False),
    ]
    (jspecs, jkern), (tspecs, tkern) = _kernels(specs_fn, capacity, 4)
    rows, valid = _shard_rows(n_dev, 900, layout)
    rng = np.random.default_rng(60 + n_dev)
    seg = rng.integers(0, 12, rows).astype(np.int32)
    v = rng.normal(size=rows) * 1e3
    vvalid = rng.random(rows) >= 0.1
    jmesh = JM.make_mesh(n_dev)
    jout = JM.make_distributed_agg_step(jkern, jspecs, jmesh, capacity)(
        *JM.shard_batch(jmesh, [seg, valid, v, vvalid])
    )
    tmesh = TM.make_mesh(n_dev, "cpu")
    shards = TM.shard_batch(tmesh, [seg, valid, v, vvalid])
    if layout == "empty":
        shards = [sh if sh[0].shape[0] else None for sh in shards]
        assert None in shards or n_dev == 1
    tstate = TM.make_distributed_agg_step(tkern, tspecs, tmesh, capacity)(shards)
    _assert_states(jspecs, jout, tspecs, tstate, capacity)


def test_reduce_twin_folds_in_shard_order_bit_for_bit():
    """The twin is ``combine_states`` folded over the shards in order:
    NaN propagates through min and max, -0.0 orders below +0.0, int sums
    wrap like int64 +, presence sums."""
    specs = [
        TK.KernelAggSpec("min", True), TK.KernelAggSpec("max", True),
        TK.KernelAggSpec("sum", True, int_sum=True),
    ]
    f = lambda *x: torch.tensor(x, dtype=torch.float64).view(torch.int64)  # noqa: E731
    i = lambda *x: torch.tensor(x, dtype=torch.int64)  # noqa: E731
    s0 = torch.stack([f(1.0, -0.0, float("nan")), i(1, 1, 1),
                      f(2.0, 0.0, 5.0), i(1, 1, 1), i(2**62, 3, -4), i(1, 1, 1), i(1, 1, 1)])
    s1 = torch.stack([f(0.5, 0.0, 1.0), i(2, 0, 1),
                      f(float("nan"), -0.0, 6.0), i(2, 0, 1), i(2**62, -3, 4), i(2, 0, 1), i(2, 0, 1)])
    ident = TK.init_states(specs, 3, torch.device("cpu"))
    out = TM.mesh_reduce(specs, [s0, ident, s1])
    want = TK.combine_states(specs, TK.combine_states(specs, s0, ident), s1)
    assert torch.equal(out, want)
    host = TK.unpack_host(specs, out.numpy())
    assert host[0][0] == 0.5 and np.signbit(host[0][1]) and np.isnan(host[0][2])
    assert np.isnan(host[2][0]) and not np.signbit(host[2][1]) and host[2][2] == 6.0
    assert host[4][0] == -(2**63) and host[4][1] == 0 and host[4][2] == 0
    assert host[-1].tolist() == [3, 1, 2]
    single = TM.mesh_reduce(specs, [s0])
    assert torch.equal(single, s0) and single.data_ptr() != s0.data_ptr()


def test_mesh_rejects_x32_pair_states():
    from arrow_ballista_tpu_torch.errors import ExecutionError

    class PairSpec:
        func, has_arg, ord_pair = "min", True, True

    with pytest.raises(ExecutionError):
        TM.make_distributed_agg_step(None, [PairSpec()], TM.make_mesh(2, "cpu"), 4)


def test_make_mesh_shards_and_widths():
    assert TM.visible_devices("cpu") == 8
    assert TM.make_mesh(None, "cpu").size == 8
    m = TM.make_mesh(3, "cpu")
    assert m.devices == [torch.device("cpu")] * 3
    per = TM.shard_batch(m, [np.arange(7)])
    assert [sh[0].tolist() for sh in per] == [[0, 1, 2], [3, 4, 5], [6]]
