"""The PyTorch port's CUDA kernels on the card, against their plain
PyTorch twins.  Every test needs an NVIDIA GPU and skips without one:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda

Tolerance: f64 sums within rel 1e-9 (kernel and twin add in different
orders), everything else exact; two kernel runs must be bit-identical.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu_torch.ops import kernels as TK
from benchmarks.tpch.datagen import gen_lineitem
from benchmarks.tpch.queries import QUERIES

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("torch.cuda.is_available() is False")
    return torch.device("cuda")


def _inputs(n, cap, device, seed=0):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, cap, n, dtype=np.int32)
    v = rng.uniform(1.0, 100.0, n)
    w = rng.integers(2**36, 2**37, n)
    pred = rng.random(n) >= 0.2
    if cap >= 4:
        pred[gid == cap - 1] = False
        z = gid == 2
        v[z] = np.where(rng.random(int(z.sum())) < 0.5, -0.0, 0.0)
        v[np.nonzero(gid == 1)[0][:3]] = np.nan
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (
        t(gid), t(np.arange(n) < n - 7), t(pred), t(rng.random(n) >= 0.02),
        [t(v), t(w)], [t(rng.random(n) >= 0.05), None],
    )


_SPECS = [
    TK.KernelAggSpec("count_star", False),
    TK.KernelAggSpec("sum", True),
    TK.KernelAggSpec("min", True),
    TK.KernelAggSpec("max", True),
    TK.KernelAggSpec("sum", True, int_sum=True),
    TK.KernelAggSpec("min", True, int_minmax=True),
    TK.KernelAggSpec("max", True, int_minmax=True),
]
_OPS = [TK.OP_COUNT, TK.OP_ADD_F64, TK.OP_COUNT, TK.OP_MIN_F64, TK.OP_COUNT,
        TK.OP_MAX_F64, TK.OP_COUNT, TK.OP_ADD_I64, TK.OP_COUNT, TK.OP_MIN_I64,
        TK.OP_COUNT, TK.OP_MAX_I64, TK.OP_COUNT, TK.OP_COUNT]
_COLS = [-1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, -1]


@pytest.mark.parametrize("cap", [1, 7, 64, 4096, 70000])
def test_segment_agg_kernel_matches_twin(cuda, cap):
    n = 300_000
    gid, tail, pred, pvalid, values, valids = _inputs(n, cap, cuda, seed=cap)
    runs = []
    for _ in range(2):
        state = TK.init_states(_SPECS, cap, cuda)
        TK.segment_agg_cuda(gid, tail, pred, pvalid, values, valids, _OPS, _COLS, state)
        runs.append(state)
    twin = TK.init_states(_SPECS, cap, cuda)
    TK.segment_agg_reference(gid, tail, pred, pvalid, values, valids, _OPS, _COLS, twin)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    k, t = runs[0].cpu().numpy(), twin.cpu().numpy()
    for f, op in enumerate(_OPS):
        if op == TK.OP_ADD_F64:
            kf, tf = k[f].view(np.float64), t[f].view(np.float64)
            np.testing.assert_allclose(kf, tf, rtol=1e-9, atol=0)
        else:
            np.testing.assert_array_equal(k[f], t[f])


def test_segment_agg_kernel_rejects_bad_input(cuda):
    gid, tail, pred, pvalid, values, valids = _inputs(1000, 4, cuda)
    state = TK.init_states(_SPECS, 4, cuda)
    with pytest.raises(ValueError, match="gid"):
        TK.segment_agg_cuda(gid.long(), tail, pred, pvalid, values, valids,
                            _OPS, _COLS, state)
    with pytest.raises(ValueError, match="does not match"):  # f64 op, i64 column
        TK.segment_agg_cuda(gid, tail, pred, pvalid, values, valids,
                            [TK.OP_ADD_F64] + _OPS[1:], [1] + _COLS[1:], state)
    with pytest.raises(ValueError, match="pred"):  # a mask left on the host
        TK.segment_agg_cuda(gid, tail, pred.cpu(), pvalid, values, valids,
                            _OPS, _COLS, state)
    with pytest.raises(ValueError, match="column 0"):  # a strided column
        TK.segment_agg_cuda(gid, tail, pred, pvalid,
                            [torch.stack([values[0], values[0]], 1)[:, 0], values[1]],
                            valids, _OPS, _COLS, state)


@pytest.mark.parametrize("q", [1, 6])
def test_tpch_on_cuda_matches_cpu_operators(cuda, q):
    lineitem = gen_lineitem(0.05)
    out = []
    for enable in ("false", "true"):
        ctx = tbt.SessionContext(
            tbt.BallistaConfig({"ballista.tpu.enable": enable,
                                "ballista.tpu.min_rows": "0"}),
            device=cuda,
        )
        ctx.register_arrow_table("lineitem", lineitem, partitions=2)
        before = TK.LAUNCHES["segment_agg"]
        out.append(ctx.sql(QUERIES[q]).collect())
        if enable == "true":
            assert TK.LAUNCHES["segment_agg"] > before
    a, b = out
    assert a.num_rows == b.num_rows
    for name in a.schema.names:
        for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
            if isinstance(x, float):
                assert y == pytest.approx(x, rel=1e-9)
            else:
                assert x == y


def _stage_table():
    rng = np.random.default_rng(5)
    n = 300_000
    return pa.table(
        {
            "g": pa.array(rng.integers(-50, 50, n), pa.int64()),
            "a": pa.array(rng.integers(0, 1000, n), pa.int64()),
            "b": pa.array(rng.integers(10**6, 2 * 10**6, n), pa.int64()),
            "x": pa.array(rng.normal(0, 1, n), pa.float64()),
            "y": pa.array(rng.normal(0, 1, n), pa.float64()),
        }
    )


@pytest.mark.parametrize(
    "sql",
    [
        # each aggregate keeps its own computed argument
        "select g, avg(a + 1) as ma, sum(x * y) as sxy, avg(b + 1) as mb, "
        "count(a) as ca from t group by g order by g",
        # negative group keys stay on the device route
        "select g, min(x) as lo, max(b) as hi, count(*) as c from t "
        "where y > -0.5 group by g order by g",
    ],
)
def test_stage_on_cuda_matches_cpu_operators(cuda, sql):
    tbl = _stage_table()
    out = []
    for enable in ("false", "true"):
        ctx = tbt.SessionContext(
            tbt.BallistaConfig({"ballista.tpu.enable": enable,
                                "ballista.tpu.min_rows": "0"}),
            device=cuda,
        )
        ctx.register_arrow_table("t", tbl, partitions=2)
        before = TK.LAUNCHES["segment_agg"]
        out.append(ctx.sql(sql).collect())
        if enable == "true":
            assert TK.LAUNCHES["segment_agg"] > before
    a, b = out
    assert a.num_rows == b.num_rows == 100
    for name in a.schema.names:
        for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
            if isinstance(x, float):
                assert y == pytest.approx(x, rel=1e-9)
            else:
                assert x == y


# ------------------------------------------------- sort, scan, windows
from arrow_ballista_tpu_torch.ops import window_kernel as WK  # noqa: E402


def _sort_keys(n, device, seed=0):
    """A window-like key set: pad flag, a partition code, a null rank and
    an i64 order key with ties."""
    rng = np.random.default_rng(seed)
    pad = (np.arange(n) >= n - 5).astype(np.int32)
    part = rng.integers(-3, 40, n).astype(np.int64)
    null_rank = (rng.random(n) < 0.1).astype(np.int32)
    order = rng.integers(-(2**40), 2**40, n) // (2**36)  # many ties
    return [torch.from_numpy(a).to(device) for a in (pad, part, null_rank, order)]


@pytest.mark.parametrize("n", [0, 1, 4095, 4097, 300_001])
def test_radix_sort_matches_twin(cuda, n):
    keys = _sort_keys(n, cuda, seed=n)
    runs = [TK.radix_argsort_cuda(keys) for _ in range(2)]
    want = TK.radix_argsort_reference(keys)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], want)


def test_radix_sort_one_key_and_skipped_passes(cuda):
    rng = np.random.default_rng(3)
    key = torch.from_numpy(rng.integers(0, 70_000, 500_000, dtype=np.int32)).to(cuda)
    perm = TK.radix_argsort_cuda([key])
    assert TK.radix_sort_pass_count([key]) == 3  # the high byte is constant
    assert torch.equal(perm, TK.radix_argsort_reference([key]))
    same = torch.zeros(1000, dtype=torch.int64, device=cuda)
    assert torch.equal(TK.radix_argsort_cuda([same]),
                       torch.arange(1000, dtype=torch.int32, device=cuda))
    assert TK.radix_sort_pass_count([same]) == 0


def _scan_inputs(n, device, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-100, 100, n)
    v[rng.random(n) < 0.01] = np.nan
    z = rng.random(n) < 0.05
    v[z] = np.where(rng.random(int(z.sum())) < 0.5, -0.0, 0.0)
    w = rng.integers(2**54, 2**55, n)  # int sums past 2^53
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return dict(
        perm=t(rng.permutation(n).astype(np.int32)),
        flag=t((rng.random(n) < 0.01).astype(np.uint8)),
        aux=t((rng.random(n) < 0.3).astype(np.uint8)),
        v=t(v), w=t(w), vm=t(rng.random(n) >= 0.1), wm=t(rng.random(n) >= 0.1),
    )


def _scan_cols(d):
    S = TK.ScanColumn
    return [
        S(TK.SS_VALUES, TK.OP_ADD_F64, d["v"], d["vm"]),
        S(TK.SS_VALUES, TK.OP_MIN_F64, d["v"], d["vm"]),
        S(TK.SS_VALUES, TK.OP_MAX_F64, d["v"], None),
        S(TK.SS_VALUES, TK.OP_ADD_I64, d["w"], d["wm"]),
        S(TK.SS_VALUES, TK.OP_MIN_I64, d["w"], d["wm"]),
        S(TK.SS_VALUES, TK.OP_MAX_I64, d["w"], None),
        S(TK.SS_VALUES, TK.OP_ADD_F64, d["w"], None),  # i64 under an f64 sum
        S(TK.SS_COUNT, TK.OP_ADD_I64, None, d["vm"]),
        S(TK.SS_IOTA, TK.OP_MIN_I64),
        S(TK.SS_AUX, TK.OP_ADD_I64),
    ]


def _assert_words(got, want, float_sum: bool):
    if float_sum:
        g, w = got.cpu().numpy().view(np.float64), want.cpu().numpy().view(np.float64)
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("reverse", [False, True])
def test_seg_scan_matches_twin(cuda, reverse):
    n = 300_007
    d = _scan_inputs(n, cuda)
    cols = _scan_cols(d)
    args = dict(perm=d["perm"], flag=d["flag"], aux=d["aux"], reverse=reverse)
    runs = [TK.seg_scan_cuda(cols, n, **args) for _ in range(2)]
    want = TK.seg_scan_reference(cols, n, **args)
    torch.cuda.synchronize()
    for k, (a, b, w) in enumerate(zip(runs[0], runs[1], want)):
        assert torch.equal(a, b), k
        _assert_words(a, w, cols[k].op == TK.OP_ADD_F64)


@pytest.mark.parametrize("cap", [4096, 70_000])
def test_sorted_route_matches_scatter_kernel(cuda, cap):
    n = 300_000
    gid, tail, pred, pvalid, values, valids = _inputs(n, cap, cuda, seed=cap)
    sort = [TK.init_states(_SPECS, cap, cuda) for _ in range(2)]
    for s in sort:
        TK.sorted_segment_agg_cuda(gid, tail, pred, pvalid, values, valids, _OPS, _COLS, s)
    scatter = TK.init_states(_SPECS, cap, cuda)
    TK.segment_agg_cuda(gid, tail, pred, pvalid, values, valids, _OPS, _COLS, scatter)
    twin = TK.init_states(_SPECS, cap, cuda)
    TK.sorted_segment_agg_reference(gid, tail, pred, pvalid, values, valids, _OPS, _COLS, twin)
    torch.cuda.synchronize()
    assert torch.equal(sort[0], sort[1])
    for other in (scatter, twin):
        k, t = sort[0].cpu().numpy(), other.cpu().numpy()
        for f, op in enumerate(_OPS):
            if op == TK.OP_ADD_F64:
                np.testing.assert_allclose(k[f].view(np.float64), t[f].view(np.float64),
                                           rtol=1e-9, atol=0)
            else:
                np.testing.assert_array_equal(k[f], t[f])


@pytest.mark.parametrize("frame", [(-6, 0), (None, 0), (1, 3), (-5, -2)])
@pytest.mark.parametrize("op", [TK.OP_MIN_F64, TK.OP_MAX_F64, TK.OP_MAX_I64])
def test_range_extremum_matches_twin(cuda, frame, op):
    n = 200_003
    d = _scan_inputs(n, cuda, seed=5)
    sf, sl = TK.seg_scan_cuda([TK.ScanColumn(TK.SS_IOTA, TK.OP_MIN_I64)], n,
                              flag=d["flag"])[0], None
    (sl,) = TK.seg_scan_cuda([TK.ScanColumn(TK.SS_IOTA, TK.OP_MAX_I64)], n,
                             flag=d["flag"], reverse=True)
    vals = d["w"] if op == TK.OP_MAX_I64 else d["v"]
    a, b = frame
    runs = [WK.range_extremum_cuda(vals, d["vm"], d["perm"], sf, sl, a, b, op)
            for _ in range(2)]
    want = WK.range_extremum_reference(vals, d["vm"], d["perm"], sf, sl, a, b, op)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], want)


_WINDOW_SPECS = (
    ("row_number",), ("rank",), ("dense_rank",), ("ntile", 7),
    ("agg", "sum", 0), ("agg", "count", None), ("agg", "min", 1),
    ("agg", "max", 0), ("agg", "count", 0),
    ("aggf", "avg", 0, -6, 0), ("aggf", "max", 0, -6, 0),
    ("aggf", "count", None, None, 1), ("aggf", "sum", 1, 2, 5),
    ("aggf", "min", 1, None, None),
    ("val", "lag", 0, 1), ("val", "lead", 1, 2),
    ("val", "first_value", 0, 1), ("val", "last_value", 1, 1),
)


def _window_inputs(n, device, seed=0):
    keys = _sort_keys(n, device, seed)
    d = _scan_inputs(n, device, seed)
    return keys[:2], keys[2:], [(d["v"], d["vm"]), (d["w"], None)]


def test_window_kernel_matches_twin(cuda):
    n = 1 << 18
    part, order, args = _window_inputs(n, cuda)
    fn = WK.make_window_kernel(_WINDOW_SPECS, 2, 2, 2)
    before = dict(TK.LAUNCHES)
    runs = [fn(part, order, args) for _ in range(2)]
    for k in ("radix_sort", "seg_scan", "range_extremum", "window_epilogue"):
        assert TK.LAUNCHES[k] > before[k], k
    cpu = lambda x: None if x is None else x.cpu()  # noqa: E731
    want = fn([k.cpu() for k in part], [k.cpu() for k in order],
              [(cpu(v), cpu(m)) for v, m in args])
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    got = runs[0].cpu()
    assert got.shape == want.shape
    # the f64 sum rows (RANGE sum, ROWS prefixes) add in another order
    sums = {4, 12, 13, 18, 19}
    for r in range(got.shape[0]):
        if r in sums:
            np.testing.assert_allclose(got[r].numpy().view(np.float64),
                                       want[r].numpy().view(np.float64),
                                       rtol=1e-9, atol=1e-6, err_msg=str(r))
        else:
            assert torch.equal(got[r], want[r]), r


def test_window_query_on_cuda_matches_cpu_operators(cuda):
    from arrow_ballista_tpu_torch.ops.window_compiler import TorchWindowExec

    sql = (
        "select l_orderkey, l_linenumber, "
        "row_number() over (partition by l_suppkey order by l_shipdate, "
        "l_orderkey, l_linenumber) rn, "
        "rank() over (partition by l_suppkey order by l_shipdate) rk, "
        "sum(l_extendedprice) over (partition by l_suppkey order by l_shipdate) rs, "
        "max(l_discount) over (partition by l_suppkey order by l_shipdate, "
        "l_orderkey, l_linenumber rows between 6 preceding and current row) mx, "
        "lag(l_extendedprice, 1) over (partition by l_suppkey order by "
        "l_shipdate, l_orderkey, l_linenumber) lg from lineitem"
    )
    lineitem = gen_lineitem(0.05)
    out = []
    for enable in ("false", "true"):
        ctx = tbt.SessionContext(
            tbt.BallistaConfig({"ballista.tpu.enable": enable,
                                "ballista.tpu.min_rows": "0",
                                "ballista.shuffle.partitions": "1"}),
            device=cuda,
        )
        ctx.register_arrow_table("lineitem", lineitem, partitions=1)
        plan = ctx.sql(sql).physical_plan()
        stack, found = [plan], False
        while stack:
            node = stack.pop()
            found |= isinstance(node, TorchWindowExec)
            stack.extend(node.children())
        assert found == (enable == "true")
        out.append(ctx.execute(plan))
    keys = [("l_orderkey", "ascending"), ("l_linenumber", "ascending")]
    a, b = (t.sort_by(keys) for t in out)
    assert a.num_rows == b.num_rows == lineitem.num_rows
    for name in a.schema.names:
        for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
            if isinstance(x, float):
                assert y == pytest.approx(x, rel=1e-9)
            else:
                assert x == y


def test_new_kernels_reject_bad_input(cuda):
    n = 1000
    keys = _sort_keys(n, cuda)
    with pytest.raises(ValueError, match="key 1"):
        TK.radix_argsort_cuda([keys[0], keys[1].float()])
    with pytest.raises(ValueError, match="CUDA tensors"):  # a key left on the host
        TK.radix_argsort_cuda([keys[0].cpu()])
    d = _scan_inputs(n, cuda)
    with pytest.raises(ValueError, match="perm"):
        TK.seg_scan_cuda(_scan_cols(d), n, perm=d["perm"].long(), flag=d["flag"])
    with pytest.raises(ValueError, match="exactly one"):
        TK.seg_scan_cuda(_scan_cols(d), n, perm=d["perm"])
    with pytest.raises(ValueError, match="column 3 values"):  # i64 op, f64 column
        bad = TK.ScanColumn(TK.SS_VALUES, TK.OP_ADD_I64, d["v"], None)
        TK.seg_scan_cuda(_scan_cols(d)[:3] + [bad], n, flag=d["flag"])
    sf = torch.zeros(n, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="seg_last"):
        WK.range_extremum_cuda(d["v"], None, d["perm"], sf, sf.int(), -1, 0,
                               TK.OP_MIN_F64)
    with pytest.raises(ValueError, match="needs"):
        WK.window_pack_cuda([WK.PackRow(WK.WP_RANK)], d["perm"], sf, None, None, None)


@pytest.mark.parametrize("n_out", [1, 7, 200, 65536])
@pytest.mark.parametrize("n_cols", [1, 3])
def test_partition_ids_kernel_matches_twin(cuda, n_cols, n_out):
    rng = np.random.default_rng(n_cols * 100 + n_out)
    n = 300_001
    words = rng.integers(-(2**63), 2**63 - 1, (n_cols, n), dtype=np.int64, endpoint=True)
    words[:, :64] = np.arange(-32, 32)
    nulls = rng.random((n_cols, n)) < 0.1
    bits, mask = torch.from_numpy(words).to(cuda), torch.from_numpy(nulls).to(cuda)
    runs = [TK.partition_ids_cuda(bits, mask, n_out) for _ in range(2)]
    twin = TK.partition_ids_twin(bits, mask, n_out)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], twin)
    assert torch.equal(runs[0].cpu(), TK.partition_ids_twin(bits.cpu(), mask.cpu(), n_out))


def test_partition_ids_kernel_rejects_bad_input(cuda):
    bits = torch.zeros((2, 100), dtype=torch.int64, device=cuda)
    nulls = torch.zeros((2, 100), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="nulls"):
        TK.partition_ids_cuda(bits, nulls[:1], 4)
    with pytest.raises(ValueError, match="nulls"):
        TK.partition_ids_cuda(bits, nulls.to(torch.uint8), 4)
    with pytest.raises(ValueError, match="bits"):
        TK.partition_ids_cuda(bits.int(), nulls, 4)
    with pytest.raises(ValueError, match="n_out"):
        TK.partition_ids_cuda(bits, nulls, (1 << 16) + 1)
    with pytest.raises(ValueError, match="n_out"):
        TK.partition_ids_cuda(bits, nulls, 0)
