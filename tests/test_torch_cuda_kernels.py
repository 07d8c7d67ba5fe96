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
from radix_cases import RADIX_EDGE_CASES, radix_edge_keys, radix_edge_rows

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


RUN = 8192  # segment_agg.h: kSegAggRunRows, the rows of one run


def _edge_inputs(n, cap, device, seed=0):
    """``_inputs`` with B1's edges: ±inf beside NaN and -0.0 in the f64
    column, int64 values that wrap their group sums, group 0 on every
    third row (it spans every run), and, past two runs, one run whose
    rows are all masked out."""
    gid, tail, pred, pvalid, (v, w), (vv, _) = _inputs(n, cap, torch.device("cpu"), seed)
    gid, pred, v, w = (x.numpy().copy() for x in (gid, pred, v, w))
    rng = np.random.default_rng(seed + 1)
    gid[::3] = 0
    v[rng.random(n) < 0.01] = np.inf
    v[rng.random(n) < 0.01] = -np.inf
    wrap = rng.random(n) < 0.2
    w[wrap] = np.iinfo(np.int64).max - rng.integers(0, 1000, int(wrap.sum()))
    if n > 2 * RUN:
        pred[RUN:2 * RUN] = False
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(gid), tail.to(device), t(pred), pvalid.to(device), [t(v), t(w)], [vv.to(device), None]


# (rows, capacity): a batch of one run or less (one launch, no scratch), one
# row past it, many runs of one each, and chunks of several runs
_B1_CASES = [(n, cap) for n in (1, RUN, RUN + 1, 300_000) for cap in (1, 7, 64, 4096, 8192, 70000)]
_B1_CASES += [(3_000_000, cap) for cap in (64, 8192, 70000)]


@pytest.mark.parametrize("n,cap", _B1_CASES)
def test_segment_agg_kernel_matches_twin(cuda, n, cap):
    """Two launches bit-identical; the twin within rel 1e-9 on f64 sums and
    exact elsewhere.  The fields share folds (each column's sum, min and
    max with one count of its validity; the i64 column, which has none,
    counts the row mask with count(*) and presence)."""
    gid, tail, pred, pvalid, values, valids = _edge_inputs(n, cap, cuda, seed=n + cap)
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


# (device on, cache_columns, the kernel that must launch): the CPU
# operators, the per-batch B1 path with the column cache off, and the
# default path, whose retained batches fold in one multi-entry launch.
# These pin the stage's own paths: with the mesh on (the default) the
# tables' two partitions would run as one gang (its own test is below)
_RUNS = (("false", "true", None), ("true", "false", "segment_agg"),
         ("true", "true", "segment_agg_entries"))
_NO_MESH = {"ballista.mesh.enable": "false"}


@pytest.mark.parametrize("q", [1, 6])
def test_tpch_on_cuda_matches_cpu_operators(cuda, q):
    lineitem = gen_lineitem(0.05)
    out = []
    for enable, cache, kernel in _RUNS:
        ctx = tbt.SessionContext(
            tbt.BallistaConfig({"ballista.tpu.enable": enable,
                                "ballista.tpu.cache_columns": cache,
                                "ballista.tpu.min_rows": "0", **_NO_MESH}),
            device=cuda,
        )
        ctx.register_arrow_table("lineitem", lineitem, partitions=2)
        before = dict(TK.LAUNCHES)
        out.append(ctx.sql(QUERIES[q]).collect())
        if kernel is not None:
            assert TK.LAUNCHES[kernel] > before[kernel], kernel
    a = out[0]
    for b in out[1:]:
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
    for enable, cache, kernel in _RUNS:
        ctx = tbt.SessionContext(
            tbt.BallistaConfig({"ballista.tpu.enable": enable,
                                "ballista.tpu.cache_columns": cache,
                                "ballista.tpu.min_rows": "0", **_NO_MESH}),
            device=cuda,
        )
        ctx.register_arrow_table("t", tbl, partitions=2)
        before = dict(TK.LAUNCHES)
        out.append(ctx.sql(sql).collect())
        if kernel is not None:
            assert TK.LAUNCHES[kernel] > before[kernel], kernel
    a = out[0]
    for b in out[1:]:
        assert a.num_rows == b.num_rows == 100
        for name in a.schema.names:
            for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
                if isinstance(x, float):
                    assert y == pytest.approx(x, rel=1e-9)
                else:
                    assert x == y


# ------------------------------------- multi-entry segment aggregate (B13a)
def _entries(n_entries, cap, device, seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 300_000, n_entries)
    sizes[1::3] = rng.integers(1, RUN + 1, len(sizes[1::3]))  # entries of one run or less
    sizes[0] = 300_000  # at least one entry cut into many chunks
    return [_edge_inputs(int(n), cap, device, seed=seed + j) for j, n in enumerate(sizes)]


@pytest.mark.parametrize("cap", [1, 64, 4096, 8192, 1 << 16])
@pytest.mark.parametrize("n_entries", [1, 8, 32])
def test_segment_agg_entries_matches_b1_launches_and_twin(cuda, n_entries, cap):
    """One multi-entry launch is bit-identical to one B1 launch per entry in
    entry order (two runs bit-identical too), and equals the twin within
    rel 1e-9 (f64 sums) and exactly elsewhere."""
    entries = _entries(n_entries, cap, cuda, seed=n_entries * 31 + cap)
    runs = []
    for _ in range(2):
        state = TK.init_states(_SPECS, cap, cuda)
        runs.append(TK.segment_agg_entries_cuda(entries, _OPS, _COLS, state))
    loop = TK.init_states(_SPECS, cap, cuda)
    for e in entries:
        TK.segment_agg_cuda(*e, _OPS, _COLS, loop)
    twin = TK.segment_agg_entries_reference(entries, _OPS, _COLS,
                                            TK.init_states(_SPECS, cap, cuda))
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], loop)
    k, t = runs[0].cpu().numpy(), twin.cpu().numpy()
    for f, op in enumerate(_OPS):
        if op == TK.OP_ADD_F64:
            np.testing.assert_allclose(k[f].view(np.float64), t[f].view(np.float64),
                                       rtol=1e-9, atol=0)
        else:
            np.testing.assert_array_equal(k[f], t[f])


def test_segment_agg_entries_rejects_bad_input(cuda):
    entries = _entries(3, 4, cuda, seed=3)
    state = TK.init_states(_SPECS, 4, cuda)
    with pytest.raises(ValueError, match="no entries"):
        TK.segment_agg_entries_cuda([], _OPS, _COLS, state)
    bad = list(entries[1])
    bad[0] = bad[0].long()
    with pytest.raises(ValueError, match="gid"):
        TK.segment_agg_entries_cuda([entries[0], tuple(bad)], _OPS, _COLS, state)
    bad = list(entries[2])
    bad[2] = bad[2].cpu()
    with pytest.raises(ValueError, match="pred"):
        TK.segment_agg_entries_cuda([entries[0], tuple(bad)], _OPS, _COLS, state)


def test_cache_hit_on_cuda_equals_the_cold_run(cuda):
    """q1 twice on one session: the warm run replays the retained entries
    (a cache hit, no host encode, no bridge) through the same multi-entry
    launch, and its answer is bit-identical to the cold run's."""
    from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec

    ctx = tbt.SessionContext(
        tbt.BallistaConfig({"ballista.tpu.min_rows": "0",
                            "ballista.batch.size": "65536", **_NO_MESH}),
        device=cuda,
    )
    ctx.register_arrow_table("lineitem", gen_lineitem(0.05), partitions=2)
    out, metrics = [], []
    for _ in range(2):
        plan = ctx.sql(QUERIES[1]).physical_plan()
        before = TK.LAUNCHES["segment_agg_entries"]
        out.append(ctx.execute(plan))
        assert TK.LAUNCHES["segment_agg_entries"] > before
        m: dict = {}
        stack = [plan]
        while stack:
            node = stack.pop()
            if isinstance(node, TorchStageExec):
                for k, v in node.metrics.to_dict().items():
                    m[k] = m.get(k, 0) + v
            stack.extend(node.children())
        metrics.append(m)
    assert metrics[0].get("cache_hits", 0) == 0
    assert metrics[1].get("cache_hits", 0) >= 1
    assert metrics[1].get("key_encode_time_ns", 0) == 0
    assert metrics[1].get("bridge_time_ns", 0) == 0
    assert out[0].equals(out[1])


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


@pytest.mark.parametrize("n", radix_edge_rows(TK.RADIX_TILE, TK.RADIX_SMALL_ROWS))
@pytest.mark.parametrize("case", RADIX_EDGE_CASES)
def test_radix_sort_edge_keys(cuda, case, n):
    """Two runs bit-identical and equal to the twin, on each side of the
    one-CTA sort's bound and at the tiled passes' tile edges."""
    keys = [torch.from_numpy(k).to(cuda) for k in radix_edge_keys(case, n, seed=n)]
    runs = [TK.radix_argsort_cuda(keys) for _ in range(2)]
    want = TK.radix_argsort_reference(keys)
    torch.cuda.synchronize()
    for got in runs:
        assert torch.equal(got, want)


def test_radix_sort_each_side_of_the_small_bound(cuda):
    """The last one-CTA size and the first tiled one, on the window-like
    key set and on one int32 key, equal to the twin; the tiled plan's pass
    count."""
    for n in (TK.RADIX_SMALL_ROWS, TK.RADIX_SMALL_ROWS + 1):
        keys = _sort_keys(n, cuda, seed=n)
        assert torch.equal(TK.radix_argsort_cuda(keys), TK.radix_argsort_reference(keys))
        key = torch.arange(n, 0, -1, dtype=torch.int32, device=cuda) % 300
        assert torch.equal(TK.radix_argsort_cuda([key]), TK.radix_argsort_reference([key]))
    assert TK.radix_sort_pass_count([key]) == 2


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


def test_seg_scan_launch_plan_is_the_mirror(cuda):
    """The plan a scan launch takes (seg_scan.h:scan_plan, read back
    through the binding) is ops/kernels.py's mirror for 1-32 columns from
    one row to 2^26, at each plan's tile edges too; the card holds at
    least one CTA of each, with no spill."""
    from scan_cases import SIZES

    for n_cols in range(1, TK.SCAN_MAX_COLUMNS + 1):
        sizes = set(SIZES)
        for n in SIZES:
            tile = TK.scan_launch_plan(n, n_cols)[2]
            sizes |= {max(1, tile - 1), tile, tile + 1}
        for n in sorted(sizes):
            plan = TK.scan_launch_describe(n, n_cols)
            got = tuple(plan[k] for k in ("threads", "rows", "tile", "smem"))
            assert got == TK.scan_launch_plan(n, n_cols), (n, n_cols, plan)
            assert plan["ctas_per_sm"] >= 1 and plan["registers"] > 0, (n, plan)
            assert plan["local_bytes"] == 0, plan
            assert 1 <= plan["grid"] <= -(-n // plan["tile"]), (n, plan)


_LOOKBACK_ROWS = 1 << 22


def _lookback_case(case: str, key_mode: bool, reverse: bool, device):
    """Inputs of a scan over 2^22 rows whose segments are ``case``: "one"
    (one segment over every row: the longest carry chain), "rows" (each
    row its own segment) or "edges" (segments ending exactly on the edges
    of the plan's tiles), by flags or by keys gathered through a random
    permutation; an f64 sum and a df32 sum of positive values."""
    n = _LOOKBACK_ROWS
    rng = np.random.default_rng(17)
    perm = rng.permutation(n).astype(np.int32)
    v = rng.uniform(0.5, 100.0, n)
    f = rng.uniform(0.5, 100.0, n).astype(np.float32)
    tile = TK.scan_launch_plan(n, 2)[2]
    pos = np.arange(n)
    seg = {"one": np.zeros(n, np.int64), "rows": pos, "edges": pos // tile}[case]
    # seg is the segment of each scan position; rows run backwards in reverse
    row_seg = seg[::-1] if reverse else seg
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    cols = [TK.ScanColumn(TK.SS_VALUES, TK.OP_ADD_F64, values=t(v)),
            TK.ScanColumn(TK.SS_VALUES, TK.OP_DF32, values=t(f))]
    kw = dict(perm=t(perm), reverse=reverse)
    if key_mode:
        key = np.empty(n, np.int32)
        key[perm] = row_seg.astype(np.int32)  # key[perm[r]] is row r's segment
        kw["key"] = t(key)
    else:
        flag = np.zeros(n, np.uint8)
        flag[1:] = row_seg[1:] != row_seg[:-1]
        kw["flag"] = t(flag)
    return cols, kw


def _busy(device, stream):
    """Float32 products on ``stream`` that hold most SMs for milliseconds."""
    a = torch.ones(4096, 4096, device=device)
    with torch.cuda.stream(stream):
        for _ in range(4):
            a = a @ a * 1e-4
    return a


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("key_mode", [False, True], ids=["flag", "key"])
@pytest.mark.parametrize("case", ["one", "rows", "edges"])
def test_seg_scan_look_back_is_deterministic(cuda, case, key_mode, reverse):
    """20 launches of the same f64-sum and df32 scan give identical words,
    every other one while products on another stream hold most SMs; and
    they match the twin (f64 within rel 1e-9, df32 hi + lo within 1e-6)."""
    n = _LOOKBACK_ROWS
    cols, kw = _lookback_case(case, key_mode, reverse, cuda)
    side = torch.cuda.Stream(cuda)
    runs, busy = [], []
    for i in range(20):
        if i % 2:
            busy.append(_busy(cuda, side))
        runs.append(TK.seg_scan_cuda(cols, n, **kw))
    torch.cuda.synchronize()
    for k in range(1, 20):
        for c in range(2):
            assert torch.equal(runs[0][c], runs[k][c]), (k, c)
    want = TK.seg_scan_reference(cols, n, **kw)
    g, w = runs[0][0].cpu().numpy().view(np.float64), want[0].cpu().numpy().view(np.float64)
    np.testing.assert_allclose(g, w, rtol=1e-9, atol=0)
    hi_lo = lambda x: sum(h.double() for h in TK._df32_split(x)).cpu().numpy()  # noqa: E731
    np.testing.assert_allclose(hi_lo(runs[0][1]), hi_lo(want[1]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("x32", [False, True], ids=["x64", "x32"])
def test_seg_scan_epilogue_segments_span_tiles(cuda, x32):
    """The sorted-aggregate epilogue when each segment spans many tiles (4
    groups over 2^22 rows, ~10% past the capacity): 20 launches into fresh
    states, every other one beside a busy stream, give identical states,
    and they match the twin (sums within rel 1e-9, x32 pairs 1e-6, counts
    exact)."""
    n, cap = _LOOKBACK_ROWS, 4
    rng = np.random.default_rng(29)
    gid = np.sort(rng.integers(0, cap + 1, n)).astype(np.int32)  # cap: the sentinel
    perm = rng.permutation(n).astype(np.int32)
    key = np.empty(n, np.int32)
    key[perm] = gid
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    valid = t(rng.random(n) >= 0.1)
    if x32:
        cols = [TK.ScanColumn(TK.SS_VALUES, TK.OP_DF32,
                              values=t(rng.uniform(0.5, 100, n).astype(np.float32)), valid=valid),
                TK.ScanColumn(TK.SS_COUNT, TK.OP_ADD_I64, valid=valid)]
        ops, field_col = [TK.XM_SUM_HI, TK.XM_SUM_LO, TK.XM_ADD_I32], [0, 0, 1]
        state0 = torch.zeros((3, cap), dtype=torch.int32, device=cuda)
        twin_fn = TK._scan_into_state_x32_reference
    else:
        cols = [TK.ScanColumn(TK.SS_VALUES, TK.OP_ADD_F64, values=t(rng.uniform(0.5, 100, n)),
                              valid=valid),
                TK.ScanColumn(TK.SS_COUNT, TK.OP_ADD_I64, valid=valid)]
        ops, field_col = [TK.OP_ADD_F64, TK.OP_COUNT], [0, 1]
        state0 = torch.zeros((2, cap), dtype=torch.int64, device=cuda)
        twin_fn = TK._scan_into_state_reference
    side = torch.cuda.Stream(cuda)
    runs, busy = [], []
    for i in range(20):
        if i % 2:
            busy.append(_busy(cuda, side))
        runs.append(TK._scan_into_state_cuda(cols, field_col, ops, state0.clone(), n,
                                             t(perm), t(key)))
    twin = twin_fn(cols, field_col, ops, state0.clone(), n, t(perm), t(key))
    torch.cuda.synchronize()
    for k in range(1, 20):
        assert torch.equal(runs[0], runs[k]), k
    got, want = runs[0].cpu(), twin.cpu()
    if x32:
        pair = lambda s: s[0].view(torch.float32).double() + s[1].view(torch.float32).double()  # noqa: E731,E501
        np.testing.assert_allclose(pair(got).numpy(), pair(want).numpy(), rtol=1e-6, atol=0)
        assert torch.equal(got[2], want[2])
    else:
        np.testing.assert_allclose(got[0].view(torch.float64).numpy(),
                                   want[0].view(torch.float64).numpy(), rtol=1e-9, atol=0)
        assert torch.equal(got[1], want[1])


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


def _join_case(n, m, device, seed=0, span_cap=None):
    """Unique sorted build keys (negatives included; span past 2^26 when
    ``span_cap`` is None); probe keys that hit, miss, fall below kmin,
    above kmax or far negative, with nulls; build columns f64 (NaN,
    -0.0), int64, bool, two of them with nulls."""
    rng = np.random.default_rng(seed)
    hi = (1 << 28) if span_cap is None else span_cap
    bkeys = np.unique(rng.integers(-5000, hi, m * 2))[:m].astype(np.int64)
    pick = rng.random(n)
    pkey = np.where(pick < 0.6, rng.choice(bkeys, n), rng.integers(-5000, hi, n))
    low = pick > 0.9
    pkey[low] = rng.integers(-(2**40), -5001, int(low.sum()))
    pkey[:4] = [bkeys[0] - 1, bkeys[-1] + 1, bkeys[0], bkeys[-1]]
    f = rng.uniform(-1e3, 1e3, len(bkeys))
    f[rng.random(len(bkeys)) < 0.02] = np.nan
    f[:2] = [-0.0, -0.0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    bvals = [t(f), t(rng.integers(2**53, 2**60, len(bkeys))), t(rng.random(len(bkeys)) < 0.5)]
    bvalids = [t(rng.random(len(bkeys)) >= 0.1), None, t(rng.random(len(bkeys)) >= 0.2)]
    return (t(bkeys), t(pkey), t(rng.random(n) >= 0.05), t(rng.random(n) >= 0.1),
            bvals, bvalids)


def _same_words(a, b) -> bool:
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return torch.equal(a, b)


def test_join_build_table_matches_twin(cuda):
    bkeys = _join_case(10, 200_000, cuda, seed=3, span_cap=1 << 22)[0]
    kmin = int(bkeys[0])
    span = 1 << (int(bkeys[-1]) - kmin).bit_length()
    runs = [TK.join_build_table_cuda(bkeys, kmin, span) for _ in range(2)]
    twin = TK.join_build_table_twin(bkeys, kmin, span)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], twin)


@pytest.mark.parametrize("n_cols", [0, 1, 3])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sorted"])
def test_join_probe_matches_twin(cuda, dense, n_cols):
    n = 1_000_003
    bkeys, pkey, pkey_valid, valid, bvals, bvalids = _join_case(
        n, 100_000, cuda, seed=n_cols, span_cap=(1 << 24) if dense else None)
    bvals, bvalids = bvals[:n_cols], bvalids[:n_cols]
    if dense:
        kmin = int(bkeys[0])
        span = 1 << (int(bkeys[-1]) - kmin).bit_length()
        form = dict(table=TK.join_build_table_cuda(bkeys, kmin, span), kmin=kmin)
    else:
        form = dict(bkeys=bkeys)
    runs = [TK.join_probe_cuda(pkey, pkey_valid, valid, bvals, bvalids, **form)
            for _ in range(2)]
    twin = TK.join_probe_twin(pkey, pkey_valid, valid, bvals, bvalids, **form)
    torch.cuda.synchronize()
    for got in runs:
        flat_got, flat_twin = got[0] + got[1] + [got[2]], twin[0] + twin[1] + [twin[2]]
        assert all(_same_words(a, b) for a, b in zip(flat_got, flat_twin))
    assert 0 < int(runs[0][2].sum()) < n


def test_join_probe_rejects_bad_input(cuda):
    bkeys, pkey, pkey_valid, valid, bvals, bvalids = _join_case(1000, 100, cuda)
    with pytest.raises(ValueError, match="pkey"):
        TK.join_probe_cuda(pkey.int(), pkey_valid, valid, bvals, bvalids, bkeys=bkeys)
    with pytest.raises(ValueError, match="exactly one"):
        TK.join_probe_cuda(pkey, pkey_valid, valid, bvals, bvalids)
    with pytest.raises(ValueError, match="build column 0"):  # a column left on the host
        TK.join_probe_cuda(pkey, pkey_valid, valid, [bvals[0].cpu()] + bvals[1:], bvalids,
                           bkeys=bkeys)
    with pytest.raises(ValueError, match="build validity 2"):
        TK.join_probe_cuda(pkey, pkey_valid, valid, bvals, bvalids[:2] + [bvalids[2][:5]],
                           bkeys=bkeys)
    with pytest.raises(ValueError, match="build columns of"):  # rows != build keys
        TK.join_probe_cuda(pkey, pkey_valid, valid, [v[:50] for v in bvals],
                           [None] * 3, bkeys=bkeys)
    with pytest.raises(ValueError, match="bkeys"):  # int64 or x32's int32 keys only
        TK.join_build_table_cuda(bkeys.to(torch.int16), 0, 1 << 10)
    with pytest.raises(ValueError, match="slots"):
        TK.join_build_table_cuda(bkeys, int(bkeys[0]), 0)


def test_star_join_on_cuda_matches_cpu_operators(cuda):
    rng = np.random.default_rng(9)
    m, n = 10_000, 500_000
    dim = pa.table({"dk": pa.array(np.arange(1, m + 1), pa.int64()),
                    "dv": pa.array(rng.uniform(0.5, 1.5, m))})
    fact = pa.table({"fk": pa.array(rng.integers(1, int(m * 1.2), n), pa.int64()),
                     "g": pa.array(rng.integers(0, 8, n), pa.int32()),
                     "v": pa.array(rng.uniform(0, 100, n))})
    sql = ("select g, sum(v * dv) as s, count(*) as c "
           "from dim, fact where dk = fk group by g order by g")
    out = []
    for enable in ("false", "true"):
        ctx = tbt.SessionContext(
            tbt.BallistaConfig({"ballista.tpu.enable": enable, "ballista.tpu.min_rows": "0",
                                "ballista.shuffle.partitions": "1"}),
            device=cuda,
        )
        ctx.register_arrow_table("dim", dim)
        ctx.register_arrow_table("fact", fact)
        before = TK.LAUNCHES["join_probe"]
        out.append(ctx.sql(sql).collect())
        if enable == "true":
            assert TK.LAUNCHES["join_probe"] > before
    a, b = out
    assert a.num_rows == b.num_rows == 8
    for name in a.schema.names:
        for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
            if isinstance(x, float):
                assert y == pytest.approx(x, rel=1e-9)
            else:
                assert x == y


# ------------------------------------------------ keyed route (B7-B10)
def _keyed_case(n, device, seed=0, n_keys=2):
    """Seeded sort operands: a mask, int32 and int64 key codes, an f64
    argument with nulls, NaN and duplicates as its order pair, and an
    int64 one."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    inv = t((rng.random(n) < 0.2).astype(np.int32))
    keys = [t(rng.integers(0, 5000, n).astype(np.int32)),
            t(rng.integers(-3, 3, n).astype(np.int64))][:n_keys]
    v = np.round(rng.normal(0, 50, n), 2)
    v[::97] = np.nan
    v[::89] = -0.0
    from arrow_ballista_tpu_torch.ops.bridge import split_u64_i32, to_u64_order

    ohi, olo = split_u64_i32(to_u64_order(v))
    return dict(inv=inv, keys=keys, v=t(v), ohi=t(ohi), olo=t(olo),
                valid=t(rng.random(n) > 0.1), w=t(rng.integers(1, 16, n)),
                wvalid=t(rng.random(n) > 0.05))


@pytest.mark.parametrize("n", [0, 1, 2047, 2049, 300_001])
def test_key_encode_matches_twin(cuda, n):
    rng = np.random.default_rng(n)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    f = rng.normal(size=n)
    f[::7] = -0.0
    kinds = ("ident", "ident", "bool", "f32", "f64", "code")
    keys = (
        (t(rng.integers(-(2**60), 2**60, n)), t(rng.random(n) > 0.1)),
        (t(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)), None),
        (t(rng.random(n) > 0.5), t(rng.random(n) > 0.2)),
        (t(f.astype(np.float32)), t(rng.random(n) > 0.2)),
        (t(f), None),
        (t(rng.integers(0, 99, n).astype(np.int32)),),
    )
    masks = (t(rng.random(n) > 0.1), None, t(rng.random(n) > 0.3))
    runs = [TK.key_encode_cuda(kinds, keys, masks, n, cuda) for _ in range(2)]
    twin = TK.key_encode_reference(kinds, keys, masks, n, cuda)
    torch.cuda.synchronize()
    for inv, codes in runs:
        assert torch.equal(inv, twin[0])
        for a, b in zip(codes, twin[1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 2048, 2049, 300_001])
@pytest.mark.parametrize("n_keys", [1, 2])
def test_keyed_gids_matches_twin(cuda, n, n_keys):
    c = _keyed_case(n, cuda, seed=n, n_keys=n_keys)
    perm = TK.radix_argsort_cuda([c["inv"]] + c["keys"])
    got = TK.keyed_gids_cuda(perm, c["inv"], c["keys"])
    twin = TK.keyed_gids_reference(perm, c["inv"], c["keys"])
    torch.cuda.synchronize()
    assert torch.equal(got["counts"], twin["counts"])
    ng = int(twin["counts"][0])
    for k in ("s2", "gid_in"):
        assert torch.equal(got[k], twin[k]), k
    for a, b in zip(got["sk"], twin["sk"]):
        assert torch.equal(a, b)
    assert torch.equal(got["starts"][:ng + 1], twin["starts"][:ng + 1])


def test_keyed_finish_matches_twin(cuda):
    n = 500_000
    c = _keyed_case(n, cuda, seed=5)
    specs = [TK.KernelAggSpec("count_star", False), TK.KernelAggSpec("sum", True),
             TK.KernelAggSpec("min", True), TK.KernelAggSpec("max", True, int_minmax=True)]
    ops = [TK.OP_COUNT, TK.OP_ADD_F64, TK.OP_COUNT, TK.OP_MIN_F64, TK.OP_COUNT,
           TK.OP_MAX_I64, TK.OP_COUNT, TK.OP_COUNT]
    cols = [-1, 0, 0, 0, 0, 1, 1, -1]
    columns, field_col = TK._build_scan_plan([c["v"], c["w"]], [c["valid"], c["wvalid"]],
                                             ops, cols)
    perm, gids, ng = TK.keyed_sort(c["inv"], c["keys"])
    cap = 1 << (ng - 1).bit_length()
    got = TK.keyed_finish(specs, columns, field_col, ops, perm, gids, ng, cap)
    twin_g = TK.keyed_gids_reference(perm, c["inv"], c["keys"])
    twin = TK.keyed_finish_reference(specs, columns, field_col, ops, perm, twin_g, ng, cap)
    flags = TK._field_flags(specs)
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), twin.cpu().numpy()
    for f, op in enumerate(ops):
        if op in (TK.OP_ADD_F64,):
            np.testing.assert_allclose(g[f].view(np.float64), w[f].view(np.float64),
                                       rtol=1e-9, atol=0)
        else:
            assert np.array_equal(g[f], w[f]), f
    assert np.array_equal(g[len(flags):], w[len(flags):])


def _finish_close(got, twin, ops, x32, what):
    if x32:
        SMOKE._x32_rows_close(TK, got, twin, ops, what)
    else:
        SMOKE._words_close(got, twin, {f for f, op in enumerate(ops) if op == TK.OP_ADD_F64})


@pytest.mark.parametrize("x32", [False, True])
@pytest.mark.parametrize("shape", ["one_row", "skew90", "zipf", "masked", "empty", "full",
                                   "sparse", "uniform"])
def test_keyed_finish_shapes_match_twin(cuda, shape, x32):
    """The finish kernel against its twin where its segments are hard: all
    groups of one row, one group of 90% of the rows, Zipf ids, every row
    masked, no rows, n_groups == capacity, n_groups far below it; NaN, +-inf
    and +-0.0 in the sums and extrema; x64's 9 columns in three passes, x32's
    pair sums and order pairs.  Two launches are bit-identical."""
    n = 0 if shape == "empty" else 300_001
    args = SMOKE.finish_case(TK, "uniform" if shape == "empty" else shape, n, x32, cuda,
                             seed=len(shape))
    fn = TK.keyed_finish_x32_cuda if x32 else TK.keyed_finish_cuda
    runs = [fn(*args) for _ in range(2)]
    twin = (TK.keyed_finish_x32_reference if x32 else TK.keyed_finish_reference)(*args)
    torch.cuda.synchronize()
    assert runs[0].dtype == twin.dtype
    assert torch.equal(runs[0], runs[1])
    _finish_close(runs[0], twin, args[3], x32, f"keyed_finish {shape}")


@pytest.mark.parametrize("x32", [False, True])
def test_keyed_finish_folded_matches_twin(cuda, x32):
    """After a folded sort: the finish kernel into the state rows, the
    unfold into the key rows, one launch each."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    dt = torch.int32 if x32 else torch.int64
    kinds, entries, plan = _fold_entries((300_001, 5000), cuda, x32, seed=8)
    inv, (comb,) = TK.keyed_encode_entries_cuda(kinds, entries, plan, dt)
    perm, gids, ng = TK.keyed_sort(inv, [comb])
    n = inv.numel()
    rng = np.random.default_rng(8)
    v = rng.normal(0, 9, n)
    v[::53] = np.nan
    ok = t(rng.random(n) > 0.1)
    KS = TK.KernelAggSpec
    specs = [KS("count_star", False), KS("sum", True)]
    if x32:
        columns = [TK.ScanColumn(TK.SS_VALUES, TK.OP_DF32, values=t(v.astype(np.float32)),
                                 valid=ok),
                   TK.ScanColumn(TK.SS_COUNT, TK.OP_ADD_I64),
                   TK.ScanColumn(TK.SS_COUNT, TK.OP_ADD_I64, valid=ok)]
        ops, field_col = TK.x32_merge_ops(specs), [1, 0, 0, 2, 1]
    else:
        ops = [TK.OP_COUNT, TK.OP_ADD_F64, TK.OP_COUNT, TK.OP_COUNT]
        columns, field_col = TK._build_scan_plan([t(v)], [ok], ops, [-1, 0, 0, -1])
    args = (specs, columns, field_col, ops, perm, gids, ng,
            max(64, 1 << (ng - 1).bit_length()), plan)
    before = dict(TK.LAUNCHES)
    fn = TK.keyed_finish_x32_cuda if x32 else TK.keyed_finish_cuda
    got = fn(*args)
    assert {k: TK.LAUNCHES[k] - before[k] for k in ("keyed_finish", "keyed_unfold",
                                                     "seg_scan")} == {
        "keyed_finish": 1, "keyed_unfold": 1, "seg_scan": 0}
    twin = (TK.keyed_finish_x32_reference if x32 else TK.keyed_finish_reference)(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, fn(*args))
    _finish_close(got, twin, ops, x32, "keyed_finish folded")


def test_keyed_finish_rejects_bad_input(cuda):
    args = SMOKE.finish_case(TK, "uniform", 5000, False, cuda, seed=1)
    specs, columns, field_col, ops, perm, gids, ng, cap = args
    with pytest.raises(ValueError, match="source"):
        TK.keyed_finish_cuda(specs, columns[:-1] + [TK.ScanColumn(TK.SS_IOTA, TK.OP_ADD_I64)],
                             field_col, ops, perm, gids, ng, cap)
    with pytest.raises(ValueError, match="n_groups"):
        TK.keyed_finish_cuda(specs, columns, field_col, ops, perm, gids, ng, ng - 1)
    with pytest.raises(ValueError, match="fields"):
        TK.keyed_finish_cuda(specs, columns, field_col[:-1] + [len(columns)], ops, perm, gids,
                             ng, cap)
    with pytest.raises(ValueError, match="s2"):
        TK.keyed_finish_cuda(specs, columns, field_col, ops, perm, dict(gids, s2=gids["s2"][1:]),
                             ng, cap)
    with pytest.raises(ValueError, match="0 columns"):
        TK._finish_cuda([], [], [], [], perm, gids, ng, cap, None, torch.int64)


@pytest.mark.parametrize("cap_extra", [1, 4])
def test_keyed_median_matches_twin(cuda, cap_extra):
    n = 400_000
    c = _keyed_case(n, cuda, seed=11)
    _perm, _gids, ng = TK.keyed_sort(c["inv"], c["keys"])
    cap = (1 << (ng - 1).bit_length()) * cap_extra
    runs = [TK.keyed_median_cuda(c["inv"], c["keys"], c["ohi"], c["olo"], c["valid"], cap)
            for _ in range(2)]
    twin = TK.keyed_median_reference(c["inv"], c["keys"], c["ohi"], c["olo"], c["valid"],
                                     cap)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], twin)


@pytest.mark.parametrize("ints", [False, True])
def test_keyed_corr_matches_twin(cuda, ints):
    n = 400_000
    c = _keyed_case(n, cuda, seed=13)
    perm, gids, ng = TK.keyed_sort(c["inv"], c["keys"])
    cap = 1 << (ng - 1).bit_length()
    x = c["w"] if ints else c["v"]
    y = (c["w"] * 3 + 1) if ints else c["v"] * 0.5 + c["w"].double()
    args = (gids["s2"], perm, gids["gid_in"], x, c["valid"], y, c["wvalid"], cap)
    runs = [TK.keyed_corr_cuda(*args) for _ in range(2)]
    twin = TK.keyed_corr_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    g, w = runs[0].cpu().numpy(), twin.cpu().numpy()
    assert np.array_equal(g[3], w[3])
    for r in range(3):
        np.testing.assert_allclose(g[r].view(np.float64), w[r].view(np.float64),
                                   rtol=1e-9, atol=0)


def _fold_entries(sizes, device, x32: bool, seed: int):
    """Pending batches of h2o-q6-like keys (two identity keys, one with
    negatives and nulls) and a host code, their row masks and the fold plan
    of their spans: ``(kinds, entries, plan)``."""
    from arrow_ballista_tpu_torch.ops import stage_compiler as TSC

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    idt = np.int32 if x32 else np.int64
    kinds = ("ident", "ident", "code")
    entries, ks = [], {}
    for n in sizes:
        a = rng.integers(1, 101, n).astype(np.int32)
        b = rng.integers(-60, 60, n).astype(idt)
        bvalid = rng.random(n) > 0.1
        c = rng.integers(0, 100, n).astype(np.int32)  # host codes may ship as int32
        if x32:
            # host codes near 2^32 ship as negative words
            c = ((c.astype(np.int64) + (1 << 32) - 100) & 0xFFFFFFFF).astype(
                np.uint32).view(np.int32)
        if n:  # an empty batch notes no span
            TSC._note_range(ks, 0, TSC._zigzag_span(a, None, x32))
            TSC._note_range(ks, 1, TSC._zigzag_span(b, bvalid, x32))
            TSC._note_range(ks, 2, (int(c.min()), int(c.max())))
        masks = (t(rng.random(n) > 0.1), None, t(rng.random(n) > 0.02))
        entries.append((((t(a), None), (t(b), t(bvalid)), (t(c),)), masks, n))
    return kinds, entries, TSC._radix_combine_bits(ks, 3)


@pytest.mark.parametrize("x32", [False, True])
@pytest.mark.parametrize("sizes", [(1,), (2047, 0, 2049), (300_001, 5000)])
def test_keyed_encode_entries_and_unfold_match_twins(cuda, sizes, x32):
    """B7c's entry-wise encode, folded and not, and the unfold against
    their twins, bit for bit; the folded sort gives the unfolded sort's
    permutation and key rows."""
    dt = torch.int32 if x32 else torch.int64
    kinds, entries, plan = _fold_entries(sizes, cuda, x32, seed=sum(sizes))
    assert plan is not None
    for fold in (None, plan):
        runs = [TK.keyed_encode_entries_cuda(kinds, entries, fold, dt) for _ in range(2)]
        twin = TK.keyed_encode_entries_reference(kinds, entries, fold, dt)
        torch.cuda.synchronize()
        for inv, keys in runs:
            assert torch.equal(inv, twin[0])
            assert len(keys) == len(twin[1])
            for a, b in zip(keys, twin[1]):
                assert a.dtype == b.dtype and torch.equal(a, b)
    inv, codes = TK.keyed_encode_entries_cuda(kinds, entries, None, dt)
    _finv, (comb,) = TK.keyed_encode_entries_cuda(kinds, entries, plan, dt)
    perm, gids, ng = TK.keyed_sort(inv, codes)
    fperm, fgids, fng = TK.keyed_sort(inv, [comb])
    assert ng == fng and torch.equal(perm, fperm)
    cap = 1 << max(ng - 1, 0).bit_length()
    want = TK.keyed_keys_reference(gids["sk"], gids["starts"], ng,
                                   torch.empty((3, cap), dtype=dt, device=cuda))
    got = TK.keyed_unfold_cuda(fgids["sk"][0], fgids["starts"], ng, plan,
                               torch.empty((3, cap), dtype=dt, device=cuda))
    twin = TK.keyed_unfold_reference(fgids["sk"][0], fgids["starts"], ng, plan,
                                     torch.empty((3, cap), dtype=dt, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, twin) and torch.equal(got, want)


def test_keyed_fold_rebases_wide_x64_codes(cuda):
    """x64 host codes near -2^40 with a 4-bit span: the kernel rebases the
    full int64 code, as the twin does."""
    rng = np.random.default_rng(17)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    entries = [(((t(-(1 << 40) + rng.integers(0, 11, n)),), (t(rng.integers(0, 9, n)), None)),
                (t(rng.random(n) > 0.1), None, None), n) for n in (5000, 70_001)]
    plan = ((-(1 << 40), 4), (0, 5))
    got = TK.keyed_encode_entries_cuda(("code", "ident"), entries, plan, torch.int64)
    twin = TK.keyed_encode_entries_reference(("code", "ident"), entries, plan, torch.int64)
    torch.cuda.synchronize()
    assert torch.equal(got[0], twin[0]) and torch.equal(got[1][0], twin[1][0])
    assert int(twin[1][0].min()) >= 0


def test_keyed_fold_kernels_reject_bad_input(cuda):
    kinds, entries, plan = _fold_entries((100,), cuda, False, seed=3)
    with pytest.raises(ValueError, match="code dtype"):
        TK.keyed_encode_entries_cuda(kinds, entries, None, torch.float64)
    with pytest.raises(ValueError, match="fold widths"):
        TK.keyed_encode_entries_cuda(kinds, entries, ((0, 16), (0, 16), (0, 1)))
    with pytest.raises(ValueError, match="entries"):
        TK.keyed_encode_entries_cuda(kinds, entries * 33, plan)


def test_keyed_kernels_reject_bad_input(cuda):
    c = _keyed_case(1000, cuda)
    with pytest.raises(ValueError, match="key 0 values"):
        TK.key_encode_cuda(("ident",), ((c["v"], None),), (), 1000, cuda)
    with pytest.raises(ValueError, match="inv"):
        TK.keyed_gids_cuda(torch.zeros(1000, dtype=torch.int32, device=cuda),
                           c["inv"].long(), c["keys"])
    with pytest.raises(ValueError, match="ohi"):
        TK.keyed_median_cuda(c["inv"], c["keys"], c["ohi"].long(), c["olo"], None, 64)
    with pytest.raises(ValueError, match="x must"):
        TK.keyed_corr_cuda(c["inv"], c["inv"], c["inv"], c["v"].float(), None, c["v"],
                           None, 64)


@pytest.mark.parametrize("sql", [
    "select k, sum(v) as s, count(*) as c, min(w) as mn from t group by k",
    "select k, median(v) as md, count(distinct w) as cd, stddev(v) as sd, "
    "corr(v, w) as r from t group by k",
])
def test_keyed_stage_on_cuda_matches_cpu_operators(cuda, sql):
    rng = np.random.default_rng(21)
    n = 300_000
    t = pa.table({"k": pa.array(rng.integers(-50_000, 50_000, n)),
                  "v": pa.array(rng.uniform(0, 100, n), mask=rng.random(n) < 0.05),
                  "w": pa.array(rng.integers(0, 1000, n))})
    out = []
    for enable in ("false", "true"):
        ctx = tbt.SessionContext(
            tbt.BallistaConfig({"ballista.tpu.enable": enable, "ballista.tpu.min_rows": "0",
                                "ballista.tpu.highcard_mode": "device",
                                "ballista.shuffle.partitions": "1"}),
            device=cuda,
        )
        ctx.register_arrow_table("t", t)
        before = dict(TK.LAUNCHES)
        out.append(ctx.sql(sql).collect().sort_by([("k", "ascending")]))
        if enable == "true":
            # one batch: the single dispatch's entry-wise encode, one key
            # (no fold), so the finish gathers the key rows
            for k in ("keyed_encode_entries", "keyed_gids", "keyed_finish"):
                assert TK.LAUNCHES[k] > before[k], k
    a, b = out
    assert a.num_rows == b.num_rows
    for name in a.schema.names:
        for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
            if isinstance(x, float) and y is not None:
                assert y == pytest.approx(x, rel=1e-9)
            else:
                assert x == y


# ------------------------------------------------ expression program (B3)
import chip_smoke as SMOKE  # noqa: E402  (the grid the smoke holds on the card)
from arrow_ballista_tpu_torch.exec import expressions as tpe  # noqa: E402

_GRID_ROWS = 300_001  # not a multiple of a CTA: ragged last block


@pytest.fixture(scope="module")
def grid_batch():
    return SMOKE.expr_grid_batch(_GRID_ROWS)


@pytest.mark.parametrize("name", sorted(SMOKE.expr_grid_cases()))
def test_expr_eval_grid_matches_twin(cuda, grid_batch, name):
    """Every opcode's case: two kernel runs, the twin and the closures it
    was compiled from, bit for bit (NaN payloads, -0.0, validity)."""
    program, leaves = SMOKE.expr_case(TK, tpe, grid_batch.schema,
                                      SMOKE.expr_grid_cases()[name])
    env = SMOKE.expr_env(TK, grid_batch, leaves, cuda)
    n = grid_batch.num_rows
    before = TK.LAUNCHES["expr_eval"]
    runs = [TK.expr_eval_cuda(program, env, n, cuda) for _ in range(2)]
    assert TK.LAUNCHES["expr_eval"] == before + 2
    for other in (runs[1], TK.expr_program_reference(program, env, n, cuda),
                  TK.closures_layout(program, env, n, cuda)):
        assert SMOKE.expr_diff(runs[0], other) is None, SMOKE.expr_diff(runs[0], other)


def test_expr_eval_int64_edges_match_torch_on_the_card(cuda):
    """INT64_MIN / -1 and % -1, which the twin guards, give what torch's
    own CUDA kernels give unguarded."""
    a = torch.tensor([SMOKE.I64_MIN, 7, -7, 2**62], dtype=torch.int64, device=cuda)
    b = torch.tensor([-1, -1, -1, -1], dtype=torch.int64, device=cuda)
    assert torch.equal(TK._trunc_div(a, b), torch.div(a, b, rounding_mode="trunc"))
    assert torch.equal(TK._floor_mod(a, b), torch.remainder(a, b))
    assert TK._trunc_div(a, b)[0].item() == SMOKE.I64_MIN


def _stage_program(cuda, q):
    """q's stage program and its first batch's env on the card, captured
    from a cache-off run through the port's session."""
    ctx = tbt.SessionContext(
        tbt.BallistaConfig({"ballista.tpu.cache_columns": "false",
                            "ballista.tpu.min_rows": "0"}), device=cuda)
    ctx.register_arrow_table("lineitem", gen_lineitem(0.05), partitions=1)
    seen = []
    inner = TK.expr_eval_cuda

    def hook(program, env, n, device):
        seen.append((program, dict(env), n))
        return inner(program, env, n, device)

    TK.expr_eval_cuda = hook
    try:
        ctx.sql(QUERIES[q]).collect()
    finally:
        TK.expr_eval_cuda = inner
    assert seen, f"q{q}: expr_eval never called"
    return seen[0]


@pytest.mark.parametrize("q", [1, 6])
def test_expr_eval_tpch_programs_match_twin(cuda, q):
    program, env, n = _stage_program(cuda, q)
    assert program.stores, "q1 and q6 compute their filter and arguments"
    got = TK.expr_eval_cuda(program, env, n, cuda)
    for other in (TK.expr_eval_cuda(program, env, n, cuda),
                  TK.expr_program_reference(program, env, n, cuda),
                  TK.closures_layout(program, env, n, cuda)):
        assert SMOKE.expr_diff(got, other) is None, SMOKE.expr_diff(got, other)


def test_expr_eval_square_empty_batch_and_threads(cuda, grid_batch):
    """The variance family's square, a batch of no rows (no launch), and
    four threads launching different programs on one card at once."""
    import threading

    comp = TK.TorchExprCompiler(grid_batch.schema)
    x = comp._lower(tpe.Col(grid_batch.schema.get_field_index("x"), "x"))
    square = TK.ExprProgram(None, [TK.square_closure(x)], [(0, torch.float64)])
    env = SMOKE.expr_env(TK, grid_batch, comp.leaves, cuda)
    n = grid_batch.num_rows
    assert SMOKE.expr_diff(TK.expr_eval_cuda(square, env, n, cuda),
                           TK.expr_program_reference(square, env, n, cuda)) is None
    empty = {k: None if v is None else v[:0] for k, v in env.items()}
    before = TK.LAUNCHES["expr_eval"]
    pred, pvalid, values, valids = TK.expr_eval_cuda(square, empty, 0, cuda)
    assert TK.LAUNCHES["expr_eval"] == before and values[0].shape == (0,)

    cases = SMOKE.expr_grid_cases()
    names = ["q1_charge", "case_nested", "in_int", "mod_float"]
    jobs = []
    for name in names:
        program, leaves = SMOKE.expr_case(TK, tpe, grid_batch.schema, cases[name])
        jobs.append((program, SMOKE.expr_env(TK, grid_batch, leaves, cuda)))
    results, errors = {}, []

    def work(k):
        try:
            program, env_k = jobs[k]
            for _ in range(10):
                results[k] = TK.expr_eval_cuda(program, env_k, n, cuda)
            torch.cuda.current_stream().synchronize()
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for k, (program, env_k) in enumerate(jobs):
        twin = TK.expr_program_reference(program, env_k, n, cuda)
        assert SMOKE.expr_diff(results[k], twin) is None, names[k]


def test_expr_eval_rejects_bad_input(cuda, grid_batch):
    program, leaves = SMOKE.expr_case(TK, tpe, grid_batch.schema,
                                      SMOKE.expr_grid_cases()["q1_charge"])
    env = SMOKE.expr_env(TK, grid_batch, leaves, cuda)
    n = grid_batch.num_rows
    before = TK.LAUNCHES["expr_eval"]
    value = next(k for k in env if not k.endswith("__valid"))
    valid = next(k for k in env if k.endswith("__valid") and env[k] is not None)
    for bad in ({value: env[value].float()},  # dtype
                {value: env[value].cpu()},  # left on the host
                {value: torch.stack([env[value], env[value]], 1)[:, 0]},  # strided
                {value: env[value][:-1]},  # short
                {valid: env[valid].long()}):
        with pytest.raises(ValueError, match="expr_eval"):
            TK.expr_eval_cuda(program, {**env, **bad}, n, cuda)
    with pytest.raises(ValueError, match="not CUDA"):
        TK.expr_eval_cuda(program, env, n, torch.device("cpu"))
    assert TK.LAUNCHES["expr_eval"] == before


# the tile's edges: programs of every register kind (tile, uniform, leaf
# with and without a validity, mask), IN tables, nested selects, the
# int64 edges and past 64 registers
_TILE_CASES = ("q1_charge", "case_nested", "case_else", "in_int", "in_float",
               "not_in_int_items_float_column", "div_int", "mod_int", "mul_int_overflow",
               "and_bool_leaf", "le_bool_int", "is_null_never_null", "cast_float_int",
               "fn_sin", "wide_program")
_TILE_ROWS = (1 << 20) + 3


@pytest.fixture(scope="module")
def tile_batches():
    return {mode: SMOKE.expr_grid_batch(_TILE_ROWS, mode=mode) for mode in ("x64", "x32")}


def _expr_same(program, env, n, cuda):
    """Two launches bit-identical, equal to the twin and the closures."""
    runs = [TK.expr_eval_cuda(program, env, n, cuda) for _ in range(2)]
    for other in (runs[1], TK.expr_program_reference(program, env, n, cuda),
                  TK.closures_layout(program, env, n, cuda)):
        assert SMOKE.expr_diff(runs[0], other) is None, (n, SMOKE.expr_diff(runs[0], other))


def _tile_rows(program, env, n) -> int:
    """T x R of the launch over ``n`` rows, as the C side plans it."""
    widths = {s: env[program.inputs[s]].element_size() for s in program._staged
              if env[program.inputs[s]] is not None}
    plan = TK.expr_launch_describe(program, n, widths)
    return plan["threads"] * plan["rows"]


@pytest.mark.parametrize("mode", ["x64", "x32"])
def test_expr_eval_launch_plan_is_the_mirrors(cuda, mode):
    """The plan a launch takes (expr_eval.h:expr_plan, read back through
    the binding) is ops/kernels.py's mirror, for the grid's programs and
    the TPC-H stage programs, at batch sizes from 1 row to past 2^23 with
    each staged slot at its widest; and the card holds at least one CTA
    of every such plan."""
    from test_torch_expr_plan import _tpch_programs, widest

    batch = SMOKE.expr_grid_batch(64, mode=mode)
    TK.set_precision(None if mode == "x64" else "x32")
    try:
        programs = [SMOKE.expr_case(TK, tpe, batch.schema, build)[0]
                    for build in SMOKE.expr_grid_cases().values()]
    finally:
        TK.set_precision(None)
    programs += _tpch_programs(mode)
    for program in programs:
        assert program.mode == mode
        widths = widest(program)
        for n in (1, 1000, 8192, 8193, 1 << 20, (1 << 20) + 3, 1 << 23, 1 << 26):
            plan = TK.expr_launch_describe(program, n, widths)
            got = tuple(plan[k] for k in ("threads", "rows", "stages", "smem"))
            assert got == TK.expr_program_plan(program, n, widths), (n, plan)
            assert plan["ctas_per_sm"] >= 1 and plan["registers"] > 0, (n, plan)


@pytest.mark.parametrize("mode", ["x64", "x32"])
@pytest.mark.parametrize("name", _TILE_CASES)
def test_expr_eval_rows_that_cut_a_tile(cuda, tile_batches, name, mode):
    """1 row, one row either side of a full batch's tile, distributed q1's
    8,192 rows and 2^20 + 3, in both modes: two launches identical, equal
    to the twin and the closures."""
    batch = tile_batches[mode]
    TK.set_precision(None if mode == "x64" else "x32")
    try:
        program, leaves = SMOKE.expr_case(TK, tpe, batch.schema, SMOKE.expr_grid_cases()[name])
        assert program.mode == mode
        env = SMOKE.expr_env(TK, batch, leaves, cuda, mode=mode)
        tr = _tile_rows(program, env, _TILE_ROWS)
        for n in sorted({1, tr - 1, tr + 1, 8192, _TILE_ROWS}):
            cut = {k: None if v is None else v[:n] for k, v in env.items()}
            _expr_same(program, cut, n, cuda)
    finally:
        TK.set_precision(None)


def _wide_sum(terms: int):
    def build(pe, col):
        e = col("x")
        for k in range(1, terms + 1):
            e = pe.Binary(e, "+", pe.Binary(col("y"), "*", pe.Lit(float(k))))
        return e
    return build


def test_expr_eval_the_largest_program_the_admission_rule_takes(cuda, tile_batches):
    """x + y*1 + ... + y*k at the largest k the admission rule takes (past
    700 registers: each plan one row a thread), then k + 1 refused with
    ValueError before any launch."""
    batch = tile_batches["x64"]
    k = 200
    while True:
        program, leaves = SMOKE.expr_case(TK, tpe, batch.schema, _wide_sum(k + 1))
        if not TK.expr_fits(program, len(program.inputs)):
            break
        k += 1
    program, leaves = SMOKE.expr_case(TK, tpe, batch.schema, _wide_sum(k))
    assert program.n_regs > 700 and TK.expr_fits(program, len(program.inputs))
    env = SMOKE.expr_env(TK, batch, leaves, cuda)
    for n in (1000, _TILE_ROWS):
        cut = {key: None if v is None else v[:n] for key, v in env.items()}
        _expr_same(program, cut, n, cuda)
    refused, leaves = SMOKE.expr_case(TK, tpe, batch.schema, _wide_sum(k + 1))
    before = TK.LAUNCHES["expr_eval"]
    with pytest.raises(ValueError, match="exceed the kernel"):
        TK.expr_eval_cuda(refused, SMOKE.expr_env(TK, batch, leaves, cuda), 1000, cuda)
    assert TK.LAUNCHES["expr_eval"] == before


def test_expr_eval_leaves_off_a_16_byte_boundary(cuda, tile_batches):
    """Columns that are views at an odd offset (not 16-byte aligned) are
    copied before the kernel stages them: the same bits as the twin."""
    batch = tile_batches["x64"]
    program, leaves = SMOKE.expr_case(TK, tpe, batch.schema,
                                      SMOKE.expr_grid_cases()["case_else"])
    env = SMOKE.expr_env(TK, batch, leaves, cuda)
    n = _TILE_ROWS - 1
    shifted = {k: None if v is None else v[1:] for k, v in env.items()}
    assert any(v is not None and v.data_ptr() % 16 for v in shifted.values())
    _expr_same(program, shifted, n, cuda)


def test_expr_eval_x32_square_pair_program_at_tile_edges(cuda):
    """x32's variance program (``sqpair_lo``, B12f) at the rows that cut
    its tile, the edge grid repeated past 2^20 rows."""
    program = SMOKE.sqpair_program(TK)
    hi, lo = SMOKE.sqpair_edge_grid()
    reps = -(-_TILE_ROWS // len(hi))
    hi, lo = np.tile(hi, reps)[:_TILE_ROWS], np.tile(lo, reps)[:_TILE_ROWS]
    env = {"col_0__pair__hi": torch.from_numpy(hi).to(cuda),
           "col_0__pair__lo": torch.from_numpy(lo).to(cuda),
           "col_0__pair__valid": torch.from_numpy(np.arange(len(hi)) % 3 > 0).to(cuda)}
    tr = _tile_rows(program, env, _TILE_ROWS)
    for n in sorted({1, tr - 1, tr + 1, 8192, _TILE_ROWS}):
        cut = {k: v[:n] for k, v in env.items()}
        _expr_same(program, cut, n, cuda)


def test_extension_error_formatting_an_integer_raises(cuda):
    """An exception thrown inside the extension with an integer in its
    message raises RuntimeError (ROADMAP fault C4: built by another GCC,
    the extension carried its own static libstdc++, whose integer
    formatting ended the process with SIGSEGV).  Run in a child process,
    so that a crash fails this test only."""
    import os
    import subprocess
    import sys

    code = """
import torch
from arrow_ballista_tpu_torch.ops.cuda.build import load
ext = load()
dev = torch.device("cuda")
empty = torch.empty(0, dtype=torch.bool, device=dev)
gid = torch.zeros(8, dtype=torch.int32, device=dev)
state = torch.zeros(1, 8, dtype=torch.int64, device=dev)
try:
    ext.segment_agg(gid, empty, empty, empty, [empty] * 40, [empty] * 40, [0], [0], [0], [-1],
                    state)
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0])
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, (r.returncode, r.stderr[-2000:])
    assert "raised: columns 40" in r.stdout, r.stdout


# ------------------------------------------------------------ mesh (B13b)
def _mesh_states(cuda, n_shards, cap, seed):
    """Each shard's state from the segment-aggregate kernel over its rows."""
    states = []
    for s in range(n_shards):
        gid, tail, pred, pvalid, values, valids = _inputs(50_000, cap, cuda, seed=seed + s)
        state = TK.init_states(_SPECS, cap, cuda)
        TK.segment_agg_cuda(gid, tail, pred, pvalid, values, valids, _OPS, _COLS, state)
        states.append(state)
    return states


@pytest.mark.parametrize("n_shards", [1, 3, 4])
@pytest.mark.parametrize("cap", [64, 70000])
def test_mesh_reduce_matches_twin(cuda, n_shards, cap):
    """Bit for bit: the kernel folds the shards in order with B1's merge,
    as the twin folds combine_states (NaN, -0.0 and int wrap included)."""
    from arrow_ballista_tpu_torch.parallel import mesh as TM

    states = _mesh_states(cuda, n_shards, cap, seed=11 * n_shards)
    states.append(TK.init_states(_SPECS, cap, cuda))  # an empty shard
    before = TK.LAUNCHES["mesh_reduce"]
    got = TM.mesh_reduce_cuda(_SPECS, states)
    again = TM.mesh_reduce_cuda(_SPECS, states)
    want = TM.mesh_reduce_reference(_SPECS, states)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["mesh_reduce"] == before + 2
    assert torch.equal(got, again) and torch.equal(got, want)


def _route_inputs(cuda, n, n_dev, seed, invalid=0.1):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    f = rng.normal(size=n)
    f[::97] = np.nan
    f[3::101] = -0.0
    cols = [
        t(rng.integers(-(2**62), 2**62, n)), t(f),
        t(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)),
        t(rng.random(n) < 0.5), t(rng.integers(0, 2**15, n).astype(np.int16)),
    ]
    return t(rng.integers(0, n_dev, n).astype(np.int32)), t(rng.random(n) >= invalid), cols


@pytest.mark.parametrize("n,n_dev", [(1, 1), (5000, 3), (300_001, 4), (70_000, 200)])
@pytest.mark.parametrize("tight", [False, True])
def test_mesh_route_matches_twin(cuda, n, n_dev, tight):
    """Bit for bit: the staged columns (every dtype width), the staged
    validity and the dropped count, with capacity at the largest bucket or
    one below it."""
    from arrow_ballista_tpu_torch.parallel import mesh as TM

    dest, valid, cols = _route_inputs(cuda, n, n_dev, seed=n + n_dev)
    live = dest[valid]
    need = int(torch.bincount(live, minlength=n_dev).max()) if live.numel() else 1
    cap = max(1, need - 1 if tight else need)
    before = TK.LAUNCHES["mesh_route"]
    got = TM.mesh_route_cuda(dest, valid, cols, n_dev, cap)
    want = TM.mesh_route_reference(dest, valid, cols, n_dev, cap)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["mesh_route"] == before + 1
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype and torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    assert torch.equal(got[1], want[1])
    counts = torch.bincount(live, minlength=n_dev) if live.numel() else torch.zeros(1)
    surplus = int(torch.clamp(counts - cap, min=0).sum())
    assert int(got[2]) == int(want[2]) == surplus
    assert (surplus > 0) == (tight and need > 1)


def test_mesh_route_many_columns_and_out_of_range(cuda):
    """More columns than one scatter launch copies, and destinations
    outside 0..n_dev-1 counted as dropped, as the twin counts them."""
    from arrow_ballista_tpu_torch.parallel import mesh as TM

    dest, valid, cols = _route_inputs(cuda, 20_000, 4, seed=3)
    dest[::50] = 9
    dest[1::50] = -2
    cols = cols * 8  # 40 columns
    got = TM.mesh_route_cuda(dest, valid, cols, 4, 8192)
    want = TM.mesh_route_reference(dest, valid, cols, 4, 8192)
    torch.cuda.synchronize()
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    assert torch.equal(got[1], want[1]) and int(got[2]) == int(want[2]) > 0


@pytest.mark.parametrize("q", [1, 6])
def test_mesh_gang_on_cuda_matches_cpu_operators(cuda, q):
    """The default plan (mesh on) gangs q1's and q6's two partitions: one
    shard on the card, B3 and B1 over its rows, one mesh_reduce; equal to
    the CPU operators."""
    from arrow_ballista_tpu_torch.parallel.mesh_stage import MeshGangExec

    lineitem = gen_lineitem(0.05)
    out = []
    for enable in ("false", "true"):
        ctx = tbt.SessionContext(
            tbt.BallistaConfig({"ballista.tpu.enable": enable,
                                "ballista.tpu.min_rows": "0"}),
            device=cuda,
        )
        ctx.register_arrow_table("lineitem", lineitem, partitions=2)
        before = dict(TK.LAUNCHES)
        plan = ctx.sql(QUERIES[q]).physical_plan()
        out.append(ctx.execute(plan))
    gang = [n for n in _walk(plan) if isinstance(n, MeshGangExec)]
    assert gang and gang[0].metrics.to_dict()["mesh_devices"] == torch.cuda.device_count()
    for kernel in ("mesh_reduce", "segment_agg", "expr_eval"):
        assert TK.LAUNCHES[kernel] > before[kernel], kernel
    a, b = out
    assert a.num_rows == b.num_rows
    for name in a.schema.names:
        for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
            if isinstance(x, float):
                assert y == pytest.approx(x, rel=1e-9)
            else:
                assert x == y


def _walk(plan):
    stack = [plan]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(node.children())


def test_mesh_kernels_reject_bad_input(cuda):
    from arrow_ballista_tpu_torch.parallel import mesh as TM

    s = TK.init_states(_SPECS, 64, cuda)
    with pytest.raises(ValueError):
        TM.mesh_reduce_cuda(_SPECS, [s, s[:, :32].contiguous()])
    with pytest.raises(ValueError):
        TM.mesh_reduce_cuda(_SPECS, [s] * (TM.MESH_MAX_SHARDS + 1))
    dest, valid, cols = _route_inputs(cuda, 100, 2, seed=1)
    with pytest.raises(ValueError):
        TM.mesh_route_cuda(dest.to(torch.int64), valid, cols, 2, 64)
    with pytest.raises(ValueError):
        TM.mesh_route_cuda(dest, valid, cols, TM.MESH_MAX_DEVICES + 1, 64)
    with pytest.raises(ValueError):
        TM.mesh_route_cuda(dest, valid, [cols[0][:50]], 2, 64)


# ------------------------------------------------------------ x32 (B12)
# D (df32_agg), E (ord_extremum), M (x32_merge) and the x32 forms of K2,
# mesh_reduce and B3.  Tolerance: D and K2's df32 within rel 1e-6 on
# hi + lo (the kernel adds each block in a tree, the twin rounds it once),
# counts and everything else bit-identical, two launches bit-identical.
X32_REL = 1e-6


@pytest.fixture
def x32():
    TK.set_precision("x32")
    yield
    TK.set_precision(None)
    TK.set_agg_algorithm(None)


def _close_df32(hi, lo, want_hi, want_lo):
    k = (hi.double() + lo.double()).cpu().numpy()
    t = (want_hi.double() + want_lo.double()).cpu().numpy()
    np.testing.assert_allclose(k, t, rtol=X32_REL, atol=0)


@pytest.mark.parametrize("form", ["matmul", "scatter"])
@pytest.mark.parametrize("cap", [1, 64, 8192])
def test_df32_agg_matches_twin(cuda, form, cap):
    d = SMOKE._x32_wide_inputs(TK, 300_001, cap, cap, cuda)
    block = TK.DF32_BLOCK if form == "matmul" else TK.df32_scatter_block(300_001, cap, cuda)
    args = (d["gid"], d["tail"], d["pred"], None, d["values"], d["valids"],
            [(0, -1), (1, -1), (5, 6)], [-1, 0, 5], cap, block)
    runs = [TK.df32_agg_cuda(*args) for _ in range(2)]
    twin = TK.df32_agg_reference(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    _close_df32(runs[0][0], runs[0][1], twin[0], twin[1])
    assert torch.equal(runs[0][2], twin[2])


def _df32_case(n, cap, seed):
    """D's edge-case inputs as numpy: two f32 columns in [1, 1e5) (the
    first with nulls), an int64 pair's f32 halves with nulls, a tail and a
    filter; sums (0), (1) and the pair, counts of the row mask and of two
    validities."""
    rng = np.random.default_rng(seed)
    big = rng.integers(1 << 33, 1 << 40, n)
    hi = big.astype(np.float32)
    ok = rng.random(n) >= 0.05
    return dict(
        gid=rng.integers(0, cap, n, dtype=np.int32), tail=np.arange(n) < n - n // 97,
        pred=rng.random(n) >= 0.2,
        values=[rng.uniform(1.0, 1e5, n).astype(np.float32),
                rng.uniform(1.0, 1e5, n).astype(np.float32), hi,
                (big - hi.astype(np.float64)).astype(np.float32)],
        valids=[rng.random(n) >= 0.05, None, ok, ok])


def _df32_edge(name, n, cap):
    d = _df32_case(n, cap, n + cap)
    if name == "one group":
        d["gid"][:] = cap // 3
    elif name == "zipf":
        d["gid"] = SMOKE.zipf_gid(n, cap, SMOKE.X32_ZIPF_S, 7)
    elif name == "all masked":
        d["pred"][:] = False
    elif name == "nan inf":
        rows = np.flatnonzero(d["gid"] == 3)[:9]
        d["values"][0][rows[:3]] = np.nan
        d["values"][0][rows[3:6]] = np.inf
        d["values"][0][rows[6:]] = -np.inf
        d["tail"][rows] = d["pred"][rows] = d["valids"][0][rows] = True
    return d


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("name,n,cap", [
    ("one group", 300_001, 64), ("one group", 300_001, 8192), ("zipf", 1 << 20, 8192),
    ("all masked", 300_001, 64), ("n", 0, 64), ("n", 1, 64), ("n", 31, 64),
    ("n", (1 << 14) - 1, 64), ("n", (1 << 14) + 1, 8192), ("n", 300_001, 100),
    ("n", (1 << 23) + 1, 64), ("n", (1 << 23) + 1, 8192), ("tiled", 300_001, 70_000),
    ("nan inf", 300_001, 64)])
def test_df32_agg_edge_cases_match_twin(cuda, name, n, cap):
    """D in both forms on its edge cases: hi + lo within rel 1e-6 of the
    twin (NaN where the twin is NaN), counts exact, two launches
    bit-identical.  n = 2^23 + 1 gives a scatter block (131,073 rows) that
    is no multiple of its runs and, at capacity 8192, 1024 matmul blocks
    (pass 2's deep register stack); capacity 70,000 takes pass 1's group
    tiles; the NaN and ±inf of group 3 stay in group 3."""
    d = _df32_edge(name, n, cap)
    t = lambda a: None if a is None else torch.from_numpy(a).to(cuda)  # noqa: E731
    for block in (TK.DF32_BLOCK, TK.df32_scatter_block(n, cap, cuda)):
        args = (t(d["gid"]), t(d["tail"]), t(d["pred"]), None, [t(v) for v in d["values"]],
                [t(v) for v in d["valids"]], [(0, -1), (1, -1), (2, 3)], [-1, 0, 2], cap, block)
        runs = [TK.df32_agg_cuda(*args) for _ in range(2)]
        twin = TK.df32_agg_reference(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(*runs)), block
        _close_df32(runs[0][0], runs[0][1], twin[0], twin[1])
        assert torch.equal(runs[0][2], twin[2]), block
        if name == "nan inf":
            bad = ~torch.isfinite(runs[0][0][0]).cpu().numpy()
            assert bad[3] and bad.sum() == 1, block
        if name == "all masked" or n == 0:
            assert not runs[0][0].any() and not runs[0][2].any(), block


@pytest.mark.parametrize("kind", ["pair", "f32", "i32"])
@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("cap", [7, 70_000])
def test_ord_extremum_matches_twin(cuda, kind, is_min, cap):
    d = SMOKE._x32_wide_inputs(TK, 300_001, cap, cap + is_min, cuda)
    v, ok = d["values"], d["valids"]
    f = v[0].clone()
    f[:200:3] = float("nan")
    f[1:200:3] = -0.0
    f[2:200:3] = 0.0
    hi, lo, valid = {"pair": (v[7], v[8], ok[7]), "f32": (f, None, ok[0]),
                     "i32": (v[9], None, None)}[kind]
    args = (d["gid"], d["tail"], d["pred"], None, valid, hi, lo, cap, is_min)
    runs = [TK.ord_extremum_cuda(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], TK.ord_extremum_reference(*args))


def _x32_specs():
    KS = TK.KernelAggSpec
    return [KS("count_star", False), KS("sum", True), KS("avg", True, pair=True),
            KS("min", True), KS("max", True, int_minmax=True),
            KS("min", True, ord_pair=True), KS("max", True, ord_pair=True)]


@pytest.mark.parametrize("cap", [64, 70_000])
def test_x32_merge_matches_twin(cuda, cap):
    specs = _x32_specs()
    s = SMOKE._shard_states_x32(TK, specs, cap, 2, cap, cuda)
    ops = TK.x32_merge_ops(specs)
    runs = [TK.x32_merge_cuda(s[0].clone(), ops, list(s[1])) for _ in range(2)]
    twin = TK.x32_merge_reference(s[0].clone(), ops, list(s[1]))
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], twin)


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_mesh_reduce_x32_matches_twin(cuda, n_shards):
    from arrow_ballista_tpu_torch.parallel import mesh as TM

    specs = _x32_specs()
    states = SMOKE._shard_states_x32(TK, specs, 70_000, n_shards, n_shards, cuda)
    runs = [TM.mesh_reduce_cuda(specs, states) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], TM.mesh_reduce_reference(specs, states))


def test_seg_scan_x32_ops_match_twin(cuda):
    d = SMOKE._x32_wide_inputs(TK, 300_001, 4096, 5, cuda)
    v, ok = d["values"], d["valids"]
    cols = [TK.ScanColumn(TK.SS_VALUES, TK.OP_DF32, values=v[0], valid=ok[0]),
            TK.ScanColumn(TK.SS_VALUES, TK.OP_DF32, values=v[5], valid=ok[5], values2=v[6]),
            TK.ScanColumn(TK.SS_VALUES, TK.OP_UMIN_U64, values=v[7], valid=ok[7], values2=v[8]),
            TK.ScanColumn(TK.SS_VALUES, TK.OP_UMAX_U64, values=v[7], valid=ok[7], values2=v[8]),
            TK.ScanColumn(TK.SS_VALUES, TK.OP_MIN_F64, values=v[1], valid=ok[1]),
            TK.ScanColumn(TK.SS_VALUES, TK.OP_MAX_I64, values=v[9])]
    key = torch.sort(d["gid"]).values
    runs = [TK.seg_scan_cuda(cols, 300_001, key=key) for _ in range(2)]
    twin = TK.seg_scan_reference(cols, 300_001, key=key)
    torch.cuda.synchronize()
    for c, (a, b, w) in enumerate(zip(runs[0], runs[1], twin)):
        assert torch.equal(a, b), c
        if cols[c].op == TK.OP_DF32:
            _close_df32(*TK._df32_split(a), *TK._df32_split(w))
        else:
            assert torch.equal(a, w), c


def test_df32_agg_cancellation_mix(cuda):
    """D (both forms) on the cancellation mix: hi + lo of the kernel and of
    its twin meet the f64 sum at rel 1e-6 on every group, a bar its hi word
    alone and numpy's f32 pairwise sum each fail."""
    for form, r in SMOKE._df32_cancel_check(TK, cuda).items():  # raises past the bar
        assert r["hi_alone_err"] > 0.0 and r["f32_pairwise_err"] > 0.0, form


def test_seg_scan_df32_cancellation_mix(cuda):
    """K2's df32 fold on the cancellation mix: each segment's total meets
    the f64 sum at rel 1e-6, a bar numpy's f32 pairwise sum fails."""
    r = SMOKE._scan_cancel_check(TK, cuda)  # raises past the bar
    assert r["f32_pairwise_err"] > 0.0


@pytest.mark.parametrize("algo", ["matmul", "scatter", "sort"])
def test_x32_routes_match_twin(cuda, x32, algo):
    """One x32 batch on each route, the card against its twin on the CPU
    (the same stage function over the same inputs): sums within rel 1e-6,
    the rest bit-identical."""
    from arrow_ballista_tpu_torch.exec import expressions as pe

    specs = _x32_specs()
    cap = 4096
    d = SMOKE._x32_wide_inputs(TK, 300_001, cap, 11, torch.device("cpu"))
    v, ok = d["values"], d["valids"]
    env = {"v": v[0], "v__valid": ok[0], "p__hi": v[5], "p__lo": v[6], "p__valid": ok[5],
           "o__ohi": v[7], "o__olo": v[8], "o__valid": ok[7], "i": v[9], "i__valid": None}
    comp = TK.TorchExprCompiler(pa.schema([("v", pa.float32()), ("i", pa.int32())]), "x32")
    vc = comp._lower(pe.Col(0, "v"))
    ic = comp._lower(pe.Col(1, "i"))
    env = {("col_0" + k[1:] if k.startswith("v") else "col_1" + k[1:] if k.startswith("i")
            else k): t for k, t in env.items()}
    pair = lambda e: ((e["p__hi"], e["p__lo"]), e["p__valid"])  # noqa: E731
    opair = lambda e: ((e["o__ohi"], e["o__olo"]), e["o__valid"])  # noqa: E731
    closures = [None, vc, pair, vc, ic, opair, opair]
    names = list(env)
    out = []
    for dev in (cuda, torch.device("cpu")):
        fn = TK.make_partial_agg_kernel(None, closures, specs, cap, names, algo=algo,
                                        mode="x32")
        arrays = [None if env[k] is None else env[k].to(dev) for k in names]
        out.append(fn(d["gid"].to(dev), d["tail"].to(dev), *arrays).cpu())
    ops = TK.x32_merge_ops(specs)
    k, t = out[0].numpy(), out[1].numpy()
    for f, op in enumerate(ops):
        if op == TK.XM_SUM_HI:
            np.testing.assert_allclose(
                k[f].view(np.float32).astype(np.float64) + k[f + 1].view(np.float32),
                t[f].view(np.float32).astype(np.float64) + t[f + 1].view(np.float32),
                rtol=X32_REL, atol=0)
        elif op != TK.XM_SUM_LO:
            np.testing.assert_array_equal(k[f], t[f], err_msg=str(f))


@pytest.fixture(scope="module")
def grid_batch_x32():
    return SMOKE.expr_grid_batch(_GRID_ROWS, mode="x32")


@pytest.mark.parametrize("name", sorted(SMOKE.expr_grid_cases()))
def test_expr_eval_x32_grid_matches_twin(cuda, x32, grid_batch_x32, name):
    """B3's int32/float32 registers: every opcode's case compiled in x32,
    two kernel runs, the twin and the closures bit for bit."""
    program, leaves = SMOKE.expr_case(TK, tpe, grid_batch_x32.schema,
                                      SMOKE.expr_grid_cases()[name])
    assert program.mode == "x32"
    env = SMOKE.expr_env(TK, grid_batch_x32, leaves, cuda, mode="x32")
    n = grid_batch_x32.num_rows
    runs = [TK.expr_eval_cuda(program, env, n, cuda) for _ in range(2)]
    for other in (runs[1], TK.expr_program_reference(program, env, n, cuda),
                  TK.closures_layout(program, env, n, cuda)):
        assert SMOKE.expr_diff(runs[0], other) is None, SMOKE.expr_diff(runs[0], other)


@pytest.mark.parametrize("q", [1, 6])
@pytest.mark.parametrize("algo", [None, "scatter", "sort"])
def test_tpch_x32_on_cuda_matches_cpu_operators(cuda, x32, q, algo):
    li = gen_lineitem(0.01)
    outs = []
    for enable in ("false", "true"):
        TK.set_agg_algorithm(algo if enable == "true" else None)
        ctx = tbt.SessionContext(tbt.BallistaConfig({"ballista.tpu.enable": enable,
                                                     "ballista.tpu.min_rows": "0"}),
                                 device=cuda)
        ctx.register_arrow_table("lineitem", li, partitions=2)
        outs.append(ctx.sql(QUERIES[q]).collect())
    want, got = outs
    assert want.num_rows == got.num_rows
    for name in want.column_names:
        for x, y in zip(want.column(name).to_pylist(), got.column(name).to_pylist()):
            if isinstance(x, float):
                assert y == pytest.approx(x, rel=X32_REL), name
            else:
                assert x == y, name


# ------------------------------------------------- x32's forms (A7b, B12f)
def test_sqpair_opcode_matches_twin_on_the_edge_grid(cuda):
    """B12f's square-pair opcode in B3: bit-identical to its twin over the
    edge grid and random normal pairs (NaN as NaN), two runs identical."""
    SMOKE.sqpair_edge_check(TK, cuda)
    program = SMOKE.sqpair_program(TK)
    hi, lo = SMOKE.sqpair_edge_grid()
    env = {"col_0__pair__hi": torch.from_numpy(hi).to(cuda),
           "col_0__pair__lo": torch.from_numpy(lo).to(cuda),
           "col_0__pair__valid": torch.from_numpy(np.arange(len(hi)) % 3 > 0).to(cuda)}
    runs = [TK.expr_eval_cuda(program, env, len(hi), cuda) for _ in range(2)]
    assert SMOKE.expr_diff(runs[0], runs[1]) is None
    twin = TK.expr_program_reference(program, env, len(hi), cuda)
    assert all(torch.equal(a, b) for a, b in zip(runs[0][3], twin[3]))


def _x32_keyed_inputs(n, seed, device):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    inv = t((rng.random(n) < 0.2).astype(np.int32))
    keys = [t(rng.integers(-(2**31) + 1, 2**31 - 1, n).astype(np.int32) % 997),
            t(rng.integers(0, 3, n).astype(np.int32))]
    return rng, t, inv, keys


@pytest.mark.parametrize("n", [1, 5000, 300_001])
def test_key_encode_int32_form_matches_twin(cuda, n):
    rng = np.random.default_rng(n)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    keys = ((t(rng.integers(-(2**31) + 1, 2**31 - 1, n).astype(np.int32)),
             t(rng.random(n) > 0.1)), (t(rng.random(n) > 0.5), None),
            (t(rng.normal(0, 9, n).astype(np.float32)), t(rng.random(n) > 0.2)),
            (t(rng.integers(0, 2**31 - 1, n).astype(np.int32)),))
    args = (("ident", "bool", "f32", "code"), keys, (t(rng.random(n) > 0.3), None, None),
            n, cuda, torch.int32)
    got, twin = TK.key_encode_cuda(*args), TK.key_encode_reference(*args)
    assert torch.equal(got[0], twin[0])
    assert all(a.dtype == torch.int32 and torch.equal(a, b) for a, b in zip(got[1], twin[1]))


@pytest.mark.parametrize("n", [5000, 300_001])
def test_keyed_median_and_gather_int32_forms_match_twin(cuda, n):
    rng, t, inv, keys = _x32_keyed_inputs(n, n, cuda)
    vals = rng.normal(0, 5, n)
    from arrow_ballista_tpu_torch.ops.bridge import split_u64_i32, to_u64_order

    ohi, olo = (t(a) for a in split_u64_i32(to_u64_order(vals)))
    ovalid = t(rng.random(n) > 0.1)
    got = TK.keyed_median_cuda(inv, keys, ohi, olo, ovalid, 1024, torch.int32)
    twin = TK.keyed_median_reference(inv, keys, ohi, olo, ovalid, 1024, torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, twin)
    # the key gather's int32 form: the x32 finish's key rows
    perm, gids, ng = TK.keyed_sort(inv, keys)
    specs = [TK.KernelAggSpec("count_star", False)]
    ops = TK.x32_merge_ops(specs)
    out = TK.keyed_finish_x32_cuda(specs, [TK.ScanColumn(TK.SS_COUNT, TK.OP_ADD_I64)],
                                   [0] * len(ops), ops, perm, gids, ng, 4096)
    want = torch.zeros((2, 4096), dtype=torch.int32)
    TK.keyed_keys_reference([k.cpu() for k in gids["sk"]], gids["starts"].cpu(), ng, want)
    assert out.dtype == torch.int32 and torch.equal(out[len(ops):].cpu(), want)


def test_keyed_finish_x32_matches_twin(cuda):
    """The x32 finish: K2's x32 epilogue into int32 state rows and the key
    gather's int32 form, against the twins (pair sums within rel 1e-6,
    the rest bit for bit)."""
    n = 300_001
    rng, t, inv, keys = _x32_keyed_inputs(n, 3, cuda)
    v = torch.from_numpy(rng.uniform(-50, 50, n).astype(np.float32)).to(cuda)
    ok = torch.from_numpy(rng.random(n) > 0.1).to(cuda)
    KS = TK.KernelAggSpec
    specs = [KS("count_star", False), KS("sum", True), KS("max", True)]
    columns = [TK.ScanColumn(TK.SS_VALUES, TK.OP_DF32, values=v, valid=ok),
               TK.ScanColumn(TK.SS_COUNT, TK.OP_ADD_I64),
               TK.ScanColumn(TK.SS_COUNT, TK.OP_ADD_I64, valid=ok),
               TK.ScanColumn(TK.SS_VALUES, TK.OP_MAX_F64, values=v, valid=ok)]
    ops = TK.x32_merge_ops(specs)
    field_col = [1, 0, 0, 2, 3, 2, 1]
    perm, gids, ng = TK.keyed_sort(inv, keys)
    cap = 1 << (ng - 1).bit_length()
    args = (specs, columns, field_col, ops, perm, gids, ng, cap)
    got = TK.keyed_finish_x32_cuda(*args)
    twin = TK.keyed_finish_x32_reference(*args)
    assert got.dtype == torch.int32
    SMOKE._x32_rows_close(TK, got, twin, ops, "keyed_finish x32")


def test_keyed_corr_x32_matches_twin(cuda):
    n = 300_001
    rng, t, inv, keys = _x32_keyed_inputs(n, 9, cuda)
    perm, gids, ng = TK.keyed_sort(inv, keys)
    x = rng.normal(1e3, 7.0, n)
    y = 0.3 * x + rng.normal(0, 2.0, n)
    x[::31] = np.nan
    xh, yh = x.astype(np.float32), y.astype(np.float32)
    xl = (x - xh.astype(np.float64)).astype(np.float32)
    yl = (y - yh.astype(np.float64)).astype(np.float32)
    args = (gids["s2"], perm, gids["gid_in"], t(xh), t(xl), t(rng.random(n) > 0.05),
            t(yh), t(yl), None, 1 << (ng - 1).bit_length())
    got, twin = TK.keyed_corr_x32_cuda(*args), TK.keyed_corr_x32_reference(*args)
    assert got.dtype == torch.int32 and got.shape[0] == 7
    SMOKE._x32_rows_close(TK, got, twin, [TK.XM_SUM_HI, TK.XM_SUM_LO] * 3 + [None],
                          "keyed_corr x32")


@pytest.mark.parametrize("dense", [True, False])
def test_join_probe_int32_form_matches_twin(cuda, dense):
    rng = np.random.default_rng(6)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    bk = np.unique(rng.integers(-50_000, 50_000, 20_000)).astype(np.int32)
    pk = t(rng.integers(-60_000, 60_000, 300_001).astype(np.int32))
    bvals = [t(rng.normal(0, 1, len(bk)).astype(np.float32)),
             t(rng.integers(-9, 9, len(bk)).astype(np.int32)), t(rng.random(len(bk)) > 0.5)]
    bvalids = [t(rng.random(len(bk)) > 0.1), None, None]
    bkeys = t(bk)
    if dense:
        kmin = int(bk[0])
        table = TK.join_build_table_cuda(bkeys, kmin, 1 << 17)
        assert torch.equal(table, TK.join_build_table_twin(bkeys, kmin, 1 << 17))
        form = dict(table=table, kmin=kmin)
    else:
        form = dict(bkeys=bkeys)
    args = (pk, t(rng.random(300_001) > 0.05), None, bvals, bvalids)
    assert SMOKE._same_probe(TK.join_probe_cuda(*args, **form), TK.join_probe_twin(*args, **form))


def test_window_x32_forms_match_twin(cuda):
    """K4's int32 pack and K3 over f32/int32 arguments inside the x32
    window kernel, against the whole kernel's twin on the CPU (sums within
    rel 1e-6, all else bit for bit)."""
    from arrow_ballista_tpu_torch.ops import window_kernel as TW

    specs = SMOKE.X32_WINDOW_SPECS
    pkeys, okeys, args = SMOKE.x32_window_inputs(2, n=200_001)
    fn = TW.make_window_kernel(specs, len(pkeys), len(okeys), len(args), "x32")

    def run(dev):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        targs = [((t(v[0]), t(v[1])) if isinstance(v, tuple) else t(v), t(m)) for v, m in args]
        return fn([t(k) for k in pkeys], [t(k) for k in okeys], targs).cpu().numpy()

    got, twin = run(cuda), run(torch.device("cpu"))
    assert got.dtype == np.int32
    floats = SMOKE.x32_window_float_rows(specs, args)
    for r in range(got.shape[0]):
        if floats.get(r) == "pair":
            g = got[r].view(np.float32).astype(np.float64) + got[r + 1].view(np.float32)
            w = twin[r].view(np.float32).astype(np.float64) + twin[r + 1].view(np.float32)
            np.testing.assert_allclose(g, w, rtol=X32_REL, atol=1e-3)
        elif floats.get(r - 1) != "pair":
            assert np.array_equal(got[r], twin[r]), r


@pytest.mark.parametrize("sql", [
    "select k, median(v) as md, stddev(v) as sd, var_pop(v) as vp, count(distinct w) as cd "
    "from t group by k",
    "select k, corr(v, y) as r from t group by k",
    "select k, sum(v) as s, min(x) as mn, max(w) as mx from t group by k",
])
def test_x32_routes_on_cuda_match_cpu_operators(cuda, x32, sql):
    """The keyed route's statistical aggregates and B12f in x32 on the card
    (100 groups of about 500 rows) against the CPU operators at rel 1e-6."""
    rng = np.random.default_rng(3)
    n = 50_000
    t = pa.table({"k": pa.array(rng.integers(0, 100, n)),
                  "v": pa.array(rng.uniform(0, 100, n), mask=rng.random(n) < 0.05),
                  "x": pa.array(rng.normal(10, 3, n)),
                  "w": pa.array(rng.integers(-1000, 1000, n))})
    # corr over correlated columns, as tests/test_device_median.py's x32
    # case: x32's f32 centring keeps r only to about 1e-7 absolute, which
    # no relative bar holds for r near 0 (the smoke's h2o q9 leg bounds
    # that case absolutely)
    v = t.column("v").to_numpy(zero_copy_only=False)
    t = t.append_column("y", pa.array(3.0 * np.nan_to_num(v) + rng.normal(0, 25, n)))
    outs = []
    for enable in ("false", "true"):
        ctx = tbt.SessionContext(tbt.BallistaConfig({
            "ballista.tpu.enable": enable, "ballista.tpu.min_rows": "0",
            "ballista.mesh.enable": "false", "ballista.tpu.highcard_mode": "device"}),
            device=cuda)
        ctx.register_arrow_table("t", t)
        outs.append(ctx.sql(sql).collect().sort_by([("k", "ascending")]))
    want, got = outs
    assert want.num_rows == got.num_rows
    for name in want.column_names:
        for a, b in zip(want.column(name).to_pylist(), got.column(name).to_pylist()):
            if isinstance(a, float):
                assert b == pytest.approx(a, rel=X32_REL), name
            else:
                assert a == b, name
