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
        before = TK.segment_agg_cuda.launches
        out.append(ctx.sql(QUERIES[q]).collect())
        if enable == "true":
            assert TK.segment_agg_cuda.launches > before
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
        before = TK.segment_agg_cuda.launches
        out.append(ctx.sql(sql).collect())
        if enable == "true":
            assert TK.segment_agg_cuda.launches > before
    a, b = out
    assert a.num_rows == b.num_rows == 100
    for name in a.schema.names:
        for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
            if isinstance(x, float):
                assert y == pytest.approx(x, rel=1e-9)
            else:
                assert x == y
