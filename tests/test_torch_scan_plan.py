"""The segmented scan's tile rule (``ops/cuda/seg_scan.h:scan_plan``,
mirrored by ``ops/kernels.py:scan_launch_plan``) on the CPU.

Every column count the kernel takes (1-32) gets, at every call size from
one row to 2^26, a plan of 256 threads and R rows a thread whose staged
tile leaves room for three CTAs an SM or, where that would take R below 4,
for two (each within a CTA's opt-in 232,448 bytes), with R the largest
that fits, halved only while the call has fewer tiles than two an SM.  At
the row counts each plan puts on a tile's edges (n = 1, tile - 1, tile,
tile + 1) the scan's plain twin matches the JAX package's
``window_kernel._seg_scan`` on the same inputs.  No card needed.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu.ops import window_kernel as JW
from arrow_ballista_tpu_torch.ops import kernels as TK
from scan_cases import SIZES

HEADER = Path(TK.__file__).parent / "cuda" / "seg_scan.h"
SMEM_OPT_IN = 232448  # a CTA's shared bytes on the H100 (opt-in)
SMEM_PER_SM = 233472
REL = 1e-9


@pytest.fixture(autouse=True)
def _jax_x64():
    old = JK._PRECISION["mode"]
    JK.set_precision("x64")
    try:
        yield
    finally:
        JK._PRECISION["mode"] = old


def _tiles(n: int, tile: int) -> int:
    return -(-n // tile)


def test_the_mirror_holds_the_header_constants():
    text = HEADER.read_text()

    def const(name):
        return int(re.search(rf"{name} = (\d+)", text).group(1))

    assert const("kScanMaxCols") == TK.SCAN_MAX_COLUMNS
    assert const("kScanThreads") == TK.SCAN_THREADS
    assert const("kScanMaxRows") == TK.SCAN_MAX_ROWS
    assert const("kScanPlanSms") == TK.SCAN_PLAN_SMS
    assert const("kScanSmemBudget") == TK.SCAN_SMEM_BUDGET
    assert const("kScanSmemBudgetWide") == TK.SCAN_SMEM_BUDGET_WIDE
    assert const("kScanFixedBytes") == TK.SCAN_FIXED_BYTES
    # the budgets leave room for three and two CTAs an SM (and the
    # runtime's 1 KB each); the kernel's launch bounds ask for three
    assert 3 * (TK.SCAN_SMEM_BUDGET + 1024) <= SMEM_PER_SM
    assert 2 * (TK.SCAN_SMEM_BUDGET_WIDE + 1024) <= SMEM_PER_SM
    assert "__launch_bounds__(kScanThreads, 3)" in (HEADER.parent / "seg_scan.cu").read_text()
    assert "n_cols * 8 * scan_padded(t) + 4 * t + 4 * (t + 2)" in text
    assert "tiles() < 2 * kScanPlanSms" in text
    assert "if (rows < 4) {" in text
    srcs = re.search(r"enum ScanSrc : int8_t \{(.*?)\};", text, re.S).group(1)
    assert re.findall(r"(SS_\w+) = (\d)", srcs) == [
        ("SS_VALUES", str(TK.SS_VALUES)), ("SS_COUNT", str(TK.SS_COUNT)),
        ("SS_IOTA", str(TK.SS_IOTA)), ("SS_AUX", str(TK.SS_AUX))]
    widths = re.search(r"enum ScanWidth : int8_t \{(.*?)\};", text, re.S).group(1)
    assert re.findall(r"(SW_\w+) = (\d)", widths) == [
        ("SW_WORD", str(TK.SW_WORD)), ("SW_F32", str(TK.SW_F32)),
        ("SW_I32", str(TK.SW_I32)), ("SW_F32_PAIR", str(TK.SW_F32_PAIR)),
        ("SW_ORD_PAIR", str(TK.SW_ORD_PAIR))]


@pytest.mark.parametrize("n_cols", range(1, TK.SCAN_MAX_COLUMNS + 1))
def test_every_plan_fits_and_takes_the_largest_rows(n_cols):
    def largest(budget):
        rows = TK.SCAN_MAX_ROWS
        while rows > 1 and TK.scan_smem_bytes(rows, n_cols) > budget:
            rows //= 2
        return rows

    widest = largest(TK.SCAN_SMEM_BUDGET)
    budget = TK.SCAN_SMEM_BUDGET
    if widest < 4:
        widest, budget = largest(TK.SCAN_SMEM_BUDGET_WIDE), TK.SCAN_SMEM_BUDGET_WIDE
    assert widest >= 1
    for n in SIZES:
        threads, rows, tile, smem = TK.scan_launch_plan(n, n_cols)
        assert threads == TK.SCAN_THREADS and rows in (1, 2, 4, 8), (n, rows)
        assert tile == threads * rows
        assert smem == TK.scan_smem_bytes(rows, n_cols)
        assert smem <= budget < SMEM_OPT_IN, (n, smem)
        assert rows <= widest
        if rows < widest:  # halved for a small call: twice the rows would
            # leave fewer tiles than two an SM
            assert _tiles(n, 2 * tile) < 2 * TK.SCAN_PLAN_SMS, (n, rows)
        if rows > 1:
            assert _tiles(n, tile) >= 2 * TK.SCAN_PLAN_SMS, (n, rows)


def test_plans_at_known_shapes():
    # the window leg's 4 columns at 2^24 rows: 1,024-row tiles, three CTAs
    # an SM
    assert TK.scan_launch_plan(1 << 24, 4) == (256, 4, 1024, 49160)
    # one and two columns (the window's iota scans): 8 rows a thread; three
    # (the corr passes): 4; three CTAs an SM each
    for n_cols, rows in ((1, 8), (2, 8), (3, 4)):
        plan = TK.scan_launch_plan(1 << 23, n_cols)
        assert plan[1] == rows and 3 * (plan[3] + 1024) <= SMEM_PER_SM
    # scan_phase's 10 columns: R = 4 at 2^20 and 2^23, two CTAs an SM
    assert TK.scan_launch_plan(1 << 20, 10) == (256, 4, 1024, 101384)
    assert TK.scan_launch_plan(1 << 23, 10)[1] == 4
    # 32 columns: one row a thread
    assert TK.scan_launch_plan(1 << 23, 32)[1] == 1
    # q3's captured batch and the 8,192-row calls: 256-row tiles
    for n in (8192, 32768, 33151):
        assert TK.scan_launch_plan(n, 3)[:3] == (256, 1, 256)


def _edge_sizes() -> list:
    """n = 1, tile - 1, tile, tile + 1 for each tile some plan takes, where
    the plan at n keeps that tile (small tiles only: the twin and the JAX
    scan run on the CPU)."""
    out = {1}
    for n_cols in (1, 4, 10):
        for n in SIZES:
            tile = TK.scan_launch_plan(n, n_cols)[2]
            for m in (tile - 1, tile, tile + 1):
                if 1 <= m <= 4096:
                    out.add(m)
    return sorted(out)


def test_edge_sizes_cover_each_small_tile():
    sizes = _edge_sizes()
    for tile in (256, 512, 1024, 2048):
        assert {tile - 1, tile, tile + 1} <= set(sizes) or tile > 4096


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", _edge_sizes())
def test_scan_twin_matches_jax_at_tile_edges(n, reverse):
    """The port's scan (on the CPU: its plain twin) against the JAX
    package's ``_seg_scan`` over flags with a start every ~7 rows, an f64
    sum (rel 1e-9, NaN where NaN), min and max (bit-equal), and an int64
    sum (exact)."""
    rng = np.random.default_rng(n * 2 + reverse)
    v = rng.uniform(-100, 100, n)
    v[rng.random(n) < 0.05] = np.nan
    w = rng.integers(-(2**40), 2**40, n)
    flag = rng.random(n) < 0.15
    flag[0] = True
    t = torch.from_numpy
    S = TK.ScanColumn
    cols = [S(TK.SS_VALUES, TK.OP_ADD_F64, t(v)), S(TK.SS_VALUES, TK.OP_MIN_F64, t(v)),
            S(TK.SS_VALUES, TK.OP_MAX_F64, t(v)), S(TK.SS_VALUES, TK.OP_ADD_I64, t(w))]
    got = TK.seg_scan(cols, n, flag=t(flag.astype(np.uint8)), reverse=reverse)
    # the JAX scan runs forward: a reverse scan is the forward scan of the
    # flipped rows, whose segments start at each segment's last row
    jflag = np.concatenate([flag[1:], [True]])[::-1] if reverse else flag
    jv, jw = (v[::-1], w[::-1]) if reverse else (v, w)
    want = JW._seg_scan(jnp.asarray(jflag),
                        [jnp.asarray(jv), jnp.asarray(jv), jnp.asarray(jv), jnp.asarray(jw)],
                        ["sum", "min", "max", "sum"])
    want = [np.asarray(x)[::-1] if reverse else np.asarray(x) for x in want]
    g = [x.numpy() for x in got]
    np.testing.assert_allclose(g[0].view(np.float64), want[0], rtol=REL, atol=0,
                               equal_nan=True)
    for k in (1, 2):
        np.testing.assert_array_equal(g[k].view(np.int64), want[k].view(np.int64))
    np.testing.assert_array_equal(g[3], want[3])
