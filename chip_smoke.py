#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``arrow_ballista_tpu_torch``) on one
NVIDIA card.  Run from the repository root:

    python3 chip_smoke.py [--sf 10]

Phases; any failure exits non-zero and prints no result line:

1. card   — the card's name and power limit (nvidia-smi), and an ``env``
            line with the versions of grpc, protobuf and pyarrow (Flight);
2. build  — the CUDA kernels from this checkout's sources, built in a
            background thread while the TPC-H data (lineitem, orders,
            customer) is generated and written as parquet (several files
            per table) to a temporary directory;
3. kernel — every kernel against its plain PyTorch twin on the card over
            seeded inputs (nulls, NaN, ±0.0, int64 past 2^53): floats
            within rel 1e-9, everything else exact, two kernel runs
            bit-identical, each case's time per launch (median of 20)
            beside its bound:
            * ``segment_agg`` (B1) at n in {2^20, 2^23} x capacity in
              {1, 4, 64, 4096, 2^16, 2^20}, and at n = 2^23 x capacity in
              {4096, 2^16, 2^20} the sort route (radix sort + segmented
              scan, B6) against B1, with both routes' ms per launch;
            * ``radix_sort`` at n in {2^20, 2^23, 2^26}: B6's one key at
              capacity in {2^13, 2^16, 2^20} and the window key set, its
              permutation equal to the twin's;
            * ``seg_scan``, ``range_extremum`` and ``window_epilogue`` at
              n in {2^20, 2^23}, and the whole window kernel against its
              twin;
            * ``partition_ids`` (B4) at n in {2^20, 2^23} x key columns in
              {1, 3} x partitions in {1, 7, 200, 2^16} over seeded keys
              (negative ints, nulls, NaN, ±0.0, float32, date32,
              timestamp): equal to its twin and to the host partitioner
              ``hash_partition_indices``;
4. query  — TPC-H q1 and q6 over ``--sf`` lineitem (``gen_lineitem``'s
            seed, streamed as ``ballista.batch.size`` = 2^23-row batches,
            ``ballista.shuffle.partitions`` = 1) through
            ``SessionContext(device="cuda")``, held against the same session
            with ``ballista.tpu.enable=false`` (the CPU operators);
5. q3     — TPC-H q3 (BASELINE config #3) the same way: the aggregate above
            the CPU join must run on the card with no fallback, and its sort
            route must launch;
6. window — the per-supplier running revenue / moving average query over
            the same lineitem: TorchWindowExec against the CPU WindowExec;
7. distributed — TPC-H q3 and q1 over the parquet files through
            ``BallistaContext.standalone(device="cuda", num_executors=1,
            concurrent_tasks=4)`` (the port's scheduler, executor, shuffle
            and Flight; 8 shuffle partitions, mesh off, the default
            ``ballista.batch.size``), held against the
            same cluster with ``ballista.tpu.enable=false``: equal results,
            no fallback, q3's map stage hashing its shuffle ids with
            ``partition_ids`` (equal to the host hash on every batch, the
            writers' ``device_pid_batches`` above 0) and its aggregate on
            the sort route;
8. timing — every kernel at the first shape its main path gave it: the
            kernel, its twin and, where one PyTorch call computes the same
            function, that call (CUDA events, median of 20 launches),
            beside the least time the card could take (the bytes the call
            must move at 3.35 TB/s, or its f64 operations at 34 TFLOP/s).

Launch counts are set to 0 just before each main-path run (q1/q6, q3,
window, distributed q3 and q1) and read just after; a kernel of that path
that never launched fails the run.  Then one ``{"kernels": [...]}`` line and, last,
``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# kernel-phase cases
AGG_ROWS = (1 << 20, 1 << 23)
AGG_CAPACITIES = (1, 4, 64, 4096, 1 << 16, 1 << 20)
SORT_ROUTE_ROWS = 1 << 23  # B6 against B1 at capacity >= 4096
SORT_ROWS = (1 << 20, 1 << 23, 1 << 26)
SORT_CAPACITIES = (1 << 13, 1 << 16, 1 << 20)
SCAN_ROWS = (1 << 20, 1 << 23)
PID_ROWS = (1 << 20, 1 << 23)
PID_COLUMNS = (1, 3)
PID_PARTITIONS = (1, 7, 200, 1 << 16)
PARQUET_FILES = 8  # per table (one file for the small ones)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F64_OPS_PER_S = 34e12  # H100 SXM f64 outside the tensor cores
REL = 1e-9
CUDA_DIR = "arrow_ballista_tpu_torch/ops/cuda/"
# name -> (source, the JAX function it replaces)
KERNELS = {
    "segment_agg": ("segment_agg.cu", "arrow_ballista_tpu/ops/kernels.py:1158"),
    "radix_sort": ("radix_sort.cu", "arrow_ballista_tpu/ops/window_kernel.py:165"),
    "seg_scan": ("seg_scan.cu", "arrow_ballista_tpu/ops/kernels.py:1051"),
    "range_extremum": ("range_extremum.cu", "arrow_ballista_tpu/ops/window_kernel.py:128"),
    "window_epilogue": ("window_epilogue.cu", "arrow_ballista_tpu/ops/window_kernel.py:165"),
    "partition_ids": ("partition_id.cu", "arrow_ballista_tpu/ops/kernels.py:2438"),
}


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def env_line() -> str:
    """Versions of the distributed path's wire libraries."""
    import google.protobuf
    import grpc
    import pyarrow
    import pyarrow.flight  # noqa: F401

    return (f"env: grpc {grpc.__version__} protobuf {google.protobuf.__version__} "
            f"pyarrow.flight {pyarrow.__version__}")


# ------------------------------------------------------------ kernel phase
def _fields(TK):
    """(specs, ops, cols) of the kernel-phase state: every op kind over one
    f64 column (0) and one i64 column (1), count(*) first, presence last."""
    KS = TK.KernelAggSpec
    specs = [
        KS("count_star", False), KS("sum", True), KS("min", True),
        KS("max", True), KS("sum", True, int_sum=True),
        KS("min", True, int_minmax=True), KS("max", True, int_minmax=True),
    ]
    ops = [TK.OP_COUNT]
    cols = [-1]
    for op, c in (
        (TK.OP_ADD_F64, 0), (TK.OP_MIN_F64, 0), (TK.OP_MAX_F64, 0),
        (TK.OP_ADD_I64, 1), (TK.OP_MIN_I64, 1), (TK.OP_MAX_I64, 1),
    ):
        ops += [op, TK.OP_COUNT]
        cols += [c, c]
    return specs, ops + [TK.OP_COUNT], cols + [-1]


def _inputs(n: int, cap: int, seed: int, device):
    import torch

    rng = np.random.default_rng(seed)
    gid = rng.integers(0, cap, n, dtype=np.int32)
    v = rng.uniform(1.0, 100.0, n)
    w = rng.integers(2**36, 2**37, n)  # per-group sums pass 2^53
    pred = rng.random(n) >= 0.2
    if cap >= 4:
        pred[gid == cap - 1] = False  # a group whose rows are all filtered
        zeros = gid == 2  # a group of signed zeros only
        v[zeros] = np.where(rng.random(int(zeros.sum())) < 0.5, -0.0, 0.0)
        v[np.nonzero(gid == 1)[0][:3]] = np.nan
    else:
        v[:64:2], v[1:64:2] = -0.0, 0.0
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return dict(
        gid=t(gid),
        tail=t(np.arange(n) < n - 1000),
        pred=t(pred),
        pvalid=t(rng.random(n) >= 0.02),
        values=[t(v), t(w)],
        valids=[t(rng.random(n) >= 0.05), t(rng.random(n) >= 0.05)],
    )


def _call(fn, args: dict, ops, cols, state):
    return fn(
        args["gid"], args["tail"], args["pred"], args["pvalid"],
        args["values"], args["valids"], ops, cols, state,
    )


def compare_states(TK, kernel, twin, ops) -> float:
    """Raise unless ``kernel`` equals ``twin`` (f64 sums within REL, all
    else bit-exact with NaN matching NaN); returns the largest absolute
    difference of the f64 sums."""
    k, t = kernel.cpu().numpy(), twin.cpu().numpy()
    worst = 0.0
    for f, op in enumerate(ops):
        if op in (TK.OP_ADD_F64, TK.OP_MIN_F64, TK.OP_MAX_F64):
            kf, tf = k[f].view(np.float64), t[f].view(np.float64)
            if not np.array_equal(np.isnan(kf), np.isnan(tf)):
                raise AssertionError(f"field {f}: NaN positions differ")
            ok = ~np.isnan(tf)
            if op == TK.OP_ADD_F64:
                diff = np.abs(kf[ok] - tf[ok])
                if diff.size:
                    worst = max(worst, float(diff.max()))
                if np.any(diff > REL * np.abs(tf[ok])):
                    raise AssertionError(f"field {f}: sum off by {diff.max()}")
            elif not np.array_equal(k[f][ok], t[f][ok]):
                raise AssertionError(f"field {f}: extremum bits differ")
        elif not np.array_equal(k[f], t[f]):
            raise AssertionError(f"field {f}: integer field differs")
    return worst


def kernel_phase(TK, device) -> tuple[float, dict, dict]:
    """B1 vs its twin over every (n, capacity) case, and the sort route vs
    B1 at n = 2^23 and the capacities where it is taken; returns the
    largest sum error, each B1 case's ms per launch with its bound, and the
    sort route's cases."""
    import torch

    specs, ops, cols = _fields(TK)
    worst = 0.0
    times: dict = {}
    sorted_times: dict = {}
    for n in AGG_ROWS:
        for cap in AGG_CAPACITIES:
            args = _inputs(n, cap, seed=n + cap, device=device)
            runs = []
            for _ in range(2):
                s = TK.init_states(specs, cap, device)
                runs.append(_call(TK.segment_agg_cuda, args, ops, cols, s))
            twin = _call(
                TK.segment_agg_reference, args, ops, cols,
                TK.init_states(specs, cap, device),
            )
            torch.cuda.synchronize()
            if not torch.equal(runs[0], runs[1]):
                raise AssertionError(f"n={n} cap={cap}: two runs differ")
            err = compare_states(TK, runs[0], twin, ops)
            worst = max(worst, err)
            state = runs[0]
            ms = _median_ms(lambda: _call(TK.segment_agg_cuda, args, ops, cols, state))
            bound = _bytes_moved(args, state) / HBM_BYTES_PER_S * 1e3
            times[f"n={n},capacity={cap}"] = dict(ms=ms, bound_ms=bound)
            print(f"kernel n={n} capacity={cap}: ok, max_abs_err={err!r} "
                  f"ms={ms!r} bound_ms={bound!r}")
            if n == SORT_ROUTE_ROWS and cap >= 4096:
                # B6 against B1, both on the card, on the same inputs
                b6 = []
                for _ in range(2):
                    s6 = TK.init_states(specs, cap, device)
                    b6.append(_call(TK.sorted_segment_agg_cuda, args, ops, cols, s6))
                torch.cuda.synchronize()
                if not torch.equal(b6[0], b6[1]):
                    raise AssertionError(f"sort route n={n} cap={cap}: two runs differ")
                b1 = _call(TK.segment_agg_cuda, args, ops, cols,
                           TK.init_states(specs, cap, device))
                err6 = compare_states(TK, b6[0], b1, ops)
                worst = max(worst, err6)
                s6 = b6[0]
                ms6 = _median_ms(
                    lambda: _call(TK.sorted_segment_agg_cuda, args, ops, cols, s6)
                )
                sorted_times[f"n={n},capacity={cap}"] = dict(
                    sort_ms=ms6, scatter_ms=ms, bound_ms=bound,
                    max_abs_err_vs_scatter=err6,
                )
                print(f"sort route n={n} capacity={cap}: ok vs B1, "
                      f"max_abs_err={err6!r} sort_ms={ms6!r} scatter_ms={ms!r}")
                del b6, b1, s6
            del args, runs, twin, state
    return worst, times, sorted_times


# ------------------------------------------------ sort, scan and windows
class Capture:
    """Wraps ``module.name`` to keep its first call's arguments (the main
    path's shape) for the timing phase; ``keep`` copies what the call
    changes in place.  The wrapped function still runs."""

    def __init__(self, module, name: str, keep=None):
        self.module, self.name, self.keep = module, name, keep
        self.args = None

    def __enter__(self):
        inner = self.inner = getattr(self.module, self.name)

        def hook(*args, **kwargs):
            if self.args is None:
                self.args = (self.keep(args) if self.keep else args, kwargs)
            return inner(*args, **kwargs)

        setattr(self.module, self.name, hook)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def _reset_counts(TK) -> None:
    for k in TK.LAUNCHES:
        TK.LAUNCHES[k] = 0


def _bound(bytes_: int, f64_ops: int = 0) -> dict:
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = f64_ops / F64_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _sort_bytes(keys) -> int:
    return _nbytes(*keys) + 4 * keys[0].numel()  # keys read, perm written


def _scan_bytes(TK, cols, n, perm=None, flag=None, key=None, aux=None,
                reverse=False) -> int:
    total = _nbytes(perm, flag, key)
    if any(c.src == TK.SS_AUX for c in cols):
        total += _nbytes(aux)
    for c in cols:
        if c.src == TK.SS_VALUES:
            total += _nbytes(c.values)
        total += _nbytes(c.valid) + 8 * n  # validity read, scan written
    return total


def _f64_sums(TK, cols, n) -> int:
    return n * sum(c.op == TK.OP_ADD_F64 for c in cols)


def _gid_key(n: int, cap: int, seed: int):
    """B6's sort key: group ids with ~10% masked rows at the sentinel."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, cap, n, dtype=np.int32)
    key[rng.random(n) < 0.1] = cap
    return key


def _window_keys(n: int, seed: int) -> list:
    """The window query's key set: pad flag, partition code, then a null
    rank and an i64 key per ORDER BY expression (a date with ties and
    nulls, an order key, a line number)."""
    rng = np.random.default_rng(seed)
    pad = (np.arange(n) >= n - n // 64).astype(np.int32)
    part = rng.integers(1, 100_001, n).astype(np.int64)
    date_null = rng.random(n) < 0.05
    date = np.where(date_null, 0, rng.integers(8000, 10600, n)).astype(np.int64)
    return [pad, part, date_null.astype(np.int32), date,
            np.zeros(n, np.int32), rng.integers(1, 60_000_001, n).astype(np.int64),
            np.zeros(n, np.int32), rng.integers(1, 8, n).astype(np.int64)]


def _time_sort(TK, keys) -> dict:
    import torch

    out = dict(rows=keys[0].numel(), keys=len(keys),
               ms=_median_ms(lambda: TK.radix_argsort_cuda(keys)),
               passes=TK.radix_sort_pass_count(keys),
               plain_ms=_median_ms(lambda: TK.radix_argsort_reference(keys), 5),
               library_ms=(_median_ms(lambda: torch.sort(keys[0], stable=True))
                           if len(keys) == 1 else None),
               max_abs_err=0.0)
    out.update(_bound(_sort_bytes(keys)))
    return out


def sort_phase(TK, device) -> dict:
    """radix_sort vs its twin: B6's one key and the window key set."""
    import torch

    times: dict = {}
    for n in SORT_ROWS:
        cases = [(f"one key capacity={cap}", lambda cap=cap: [_gid_key(n, cap, n + cap)])
                 for cap in SORT_CAPACITIES]
        cases.append(("window keys", lambda: _window_keys(n, n)))
        for name, make in cases:
            keys = [torch.from_numpy(k).to(device) for k in make()]
            runs = [TK.radix_argsort_cuda(keys) for _ in range(2)]
            twin = TK.radix_argsort_reference(keys)
            torch.cuda.synchronize()
            if not torch.equal(runs[0], runs[1]):
                raise AssertionError(f"radix_sort n={n} {name}: two runs differ")
            if not torch.equal(runs[0], twin):
                raise AssertionError(f"radix_sort n={n} {name}: perm differs from the twin")
            del runs, twin
            t = _time_sort(TK, keys)
            times[f"n={n},{name}"] = t
            print(f"radix_sort n={n} {name}: ok, passes={t['passes']} ms={t['ms']!r} "
                  f"library_ms={t['library_ms']!r} bound_ms={t['bound_ms']!r}")
            del keys
    return times


def _scan_inputs(n: int, device, seed: int) -> dict:
    import torch

    rng = np.random.default_rng(seed)
    v = rng.uniform(-100, 100, n)
    v[rng.random(n) < 0.01] = np.nan
    z = rng.random(n) < 0.05
    v[z] = np.where(rng.random(int(z.sum())) < 0.5, -0.0, 0.0)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return dict(
        perm=t(rng.permutation(n).astype(np.int32)),
        flag=t((rng.random(n) < 0.002).astype(np.uint8)),
        aux=t((rng.random(n) < 0.3).astype(np.uint8)),
        v=t(v), w=t(rng.integers(2**54, 2**55, n)),
        vm=t(rng.random(n) >= 0.1), wm=t(rng.random(n) >= 0.1),
    )


def _scan_cols(TK, d) -> list:
    S = TK.ScanColumn
    return [
        S(TK.SS_VALUES, TK.OP_ADD_F64, d["v"], d["vm"]),
        S(TK.SS_VALUES, TK.OP_MIN_F64, d["v"], d["vm"]),
        S(TK.SS_VALUES, TK.OP_MAX_F64, d["v"], None),
        S(TK.SS_VALUES, TK.OP_ADD_I64, d["w"], d["wm"]),
        S(TK.SS_VALUES, TK.OP_MIN_I64, d["w"], d["wm"]),
        S(TK.SS_VALUES, TK.OP_MAX_I64, d["w"], None),
        S(TK.SS_VALUES, TK.OP_ADD_F64, d["w"], None),
        S(TK.SS_COUNT, TK.OP_ADD_I64, None, d["vm"]),
        S(TK.SS_IOTA, TK.OP_MIN_I64),
        S(TK.SS_AUX, TK.OP_ADD_I64),
    ]


def _compare_words(TK, cols, got, want, what: str) -> float:
    """f64 sum columns within REL (NaN matching NaN), all else bit-equal;
    returns the largest absolute difference of the sums."""
    import torch

    worst = 0.0
    for k, (c, g, w) in enumerate(zip(cols, got, want)):
        if c.op == TK.OP_ADD_F64 and c.src == TK.SS_VALUES:
            gf = g.cpu().numpy().view(np.float64)
            wf = w.cpu().numpy().view(np.float64)
            if not np.array_equal(np.isnan(gf), np.isnan(wf)):
                raise AssertionError(f"{what} column {k}: NaN positions differ")
            ok = ~np.isnan(wf)
            diff = np.abs(gf[ok] - wf[ok])
            if diff.size:
                worst = max(worst, float(diff.max()))
            if np.any(diff > REL * np.abs(wf[ok])):
                raise AssertionError(f"{what} column {k}: sum off by {diff.max()}")
        elif not torch.equal(g, w):
            raise AssertionError(f"{what} column {k}: words differ")
    return worst


def _time_scan(TK, cols, n, kwargs: dict, err: float) -> dict:
    out = dict(rows=n, columns=len(cols),
               ms=_median_ms(lambda: TK.seg_scan_cuda(cols, n, **kwargs)),
               plain_ms=_median_ms(lambda: TK.seg_scan_reference(cols, n, **kwargs), 5),
               library_ms=None, max_abs_err=err)
    out.update(_bound(_scan_bytes(TK, cols, n, **kwargs), _f64_sums(TK, cols, n)))
    return out


def scan_phase(TK, WK, device) -> tuple[dict, dict, dict]:
    """seg_scan, range_extremum and window_epilogue vs their twins."""
    import torch

    scans, extrema, epilogues = {}, {}, {}
    for n in SCAN_ROWS:
        d = _scan_inputs(n, device, seed=n)
        cols = _scan_cols(TK, d)
        for reverse in (False, True):
            kw = dict(perm=d["perm"], flag=d["flag"], aux=d["aux"], reverse=reverse)
            runs = [TK.seg_scan_cuda(cols, n, **kw) for _ in range(2)]
            want = TK.seg_scan_reference(cols, n, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError(f"seg_scan n={n}: two runs differ")
            err = _compare_words(TK, cols, runs[0], want, f"seg_scan n={n}")
            del runs, want
            t = _time_scan(TK, cols, n, kw, err)
            scans[f"n={n},reverse={reverse}"] = t
            print(f"seg_scan n={n} reverse={reverse}: ok, max_abs_err={err!r} "
                  f"ms={t['ms']!r} bound_ms={t['bound_ms']!r}")
        (sf,) = TK.seg_scan_cuda([TK.ScanColumn(TK.SS_IOTA, TK.OP_MIN_I64)], n, flag=d["flag"])
        (sl,) = TK.seg_scan_cuda([TK.ScanColumn(TK.SS_IOTA, TK.OP_MAX_I64)], n,
                                 flag=d["flag"], reverse=True)
        for (a, b), op, vals in (((-6, 0), TK.OP_MAX_F64, d["v"]),
                                 ((None, 0), TK.OP_MIN_F64, d["v"]),
                                 ((-3, 2), TK.OP_MAX_I64, d["w"])):
            args = (vals, d["vm"], d["perm"], sf, sl, a, b, op)
            runs = [WK.range_extremum_cuda(*args) for _ in range(2)]
            want = WK.range_extremum_reference(*args)
            torch.cuda.synchronize()
            if not (torch.equal(runs[0], runs[1]) and torch.equal(runs[0], want)):
                raise AssertionError(f"range_extremum n={n} frame={(a, b)}: differs")
            t = _time_extremum(WK, args)
            extrema[f"n={n},frame={(a, b)},op={op}"] = t
            print(f"range_extremum n={n} frame={(a, b)} op={op}: ok, "
                  f"ms={t['ms']!r} bound_ms={t['bound_ms']!r}")
        # the whole window kernel on the card; its flags and pack calls
        # against their twins on the same inputs
        keys = [torch.from_numpy(k).to(device) for k in _window_keys(n, seed=n + 1)]
        fn = WK.make_window_kernel(WINDOW_SPECS, 2, 6, 2)
        args = [(d["v"], d["vm"]), (d["w"], None)]
        with Capture(WK, "window_flags_cuda") as flags, \
                Capture(WK, "window_pack_cuda") as pack:
            runs = [fn(keys[:2], keys[2:], args) for _ in range(2)]
        torch.cuda.synchronize()
        if not torch.equal(runs[0], runs[1]):
            raise AssertionError(f"window kernel n={n}: two runs differ")
        t_flags, t_pack = _time_flags(WK, flags.args), _time_pack(WK, pack.args)
        epilogues[f"n={n},flags"], epilogues[f"n={n},pack"] = t_flags, t_pack
        if n == SCAN_ROWS[0]:  # the whole kernel's twin runs on the host CPU
            cpu = lambda x: None if x is None else x.cpu()  # noqa: E731
            want = fn([k.cpu() for k in keys[:2]], [k.cpu() for k in keys[2:]],
                      [(cpu(v), cpu(m)) for v, m in args])
            got = runs[0].cpu()
            for r in range(want.shape[0]):
                if r in WINDOW_SUM_ROWS:
                    g, w = got[r].numpy().view(np.float64), want[r].numpy().view(np.float64)
                    if not np.allclose(g, w, rtol=REL, atol=0, equal_nan=True):
                        raise AssertionError(f"window kernel row {r}: sums differ")
                elif not torch.equal(got[r], want[r]):
                    raise AssertionError(f"window kernel row {r} differs from the twin")
        print(f"window_epilogue n={n}: ok, flags_ms={t_flags['ms']!r} "
              f"pack_ms={t_pack['ms']!r} pack_bound_ms={t_pack['bound_ms']!r}")
        del d, cols, keys, runs, args, sf, sl
    return scans, extrema, epilogues


# the window kernel's kernel-phase specs: every kind of packed row
WINDOW_SPECS = (
    ("row_number",), ("rank",), ("dense_rank",), ("ntile", 7),
    ("agg", "sum", 0), ("agg", "count", None), ("agg", "min", 1),
    ("agg", "max", 0), ("agg", "count", 0),
    ("aggf", "avg", 0, -6, 0), ("aggf", "max", 0, -6, 0),
    ("aggf", "count", None, None, 1), ("aggf", "sum", 1, 2, 5),
    ("aggf", "min", 1, None, None),
    ("val", "lag", 0, 1), ("val", "lead", 1, 2),
    ("val", "first_value", 0, 1), ("val", "last_value", 1, 1),
)
WINDOW_SUM_ROWS = {4, 12, 13, 18, 19}  # f64 sums: another summation order


def _time_extremum(WK, args) -> dict:
    values, valid, perm, sf, sl = args[:5]
    n = perm.numel()
    out = dict(rows=n, ms=_median_ms(lambda: WK.range_extremum_cuda(*args)),
               plain_ms=_median_ms(lambda: WK.range_extremum_reference(*args), 5),
               library_ms=None, max_abs_err=0.0)
    out.update(_bound(_nbytes(values, valid, perm, sf, sl) + 8 * n))
    return out


def _time_flags(WK, captured) -> dict:
    import torch

    (keys, perm, n_part), _ = captured
    got = WK.window_flags_cuda(keys, perm, n_part)
    want = WK.window_flags_reference(keys, perm, n_part)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("window_flags differ from the twin")
    n = perm.numel()
    out = dict(rows=n, keys=len(keys),
               ms=_median_ms(lambda: WK.window_flags_cuda(keys, perm, n_part)),
               plain_ms=_median_ms(lambda: WK.window_flags_reference(keys, perm, n_part), 5),
               library_ms=None, max_abs_err=0.0)
    out.update(_bound(_nbytes(*keys, perm) + 2 * n))
    return out


def _time_pack(WK, captured) -> dict:
    import torch

    args, _ = captured
    got = WK.window_pack_cuda(*args)
    want = WK.window_pack_reference(*args)
    if not torch.equal(got, want):
        raise AssertionError("window_pack differs from the twin")
    rows, perm, sf, sl, pf, pl = args
    n = perm.numel()
    read = _nbytes(perm, sf, sl, pf, pl)
    read += sum(_nbytes(r.x, r.values, r.valid) for r in rows)
    out = dict(rows=n, packed_rows=len(rows),
               ms=_median_ms(lambda: WK.window_pack_cuda(*args)),
               plain_ms=_median_ms(lambda: WK.window_pack_reference(*args), 5),
               library_ms=None, max_abs_err=0.0)
    out.update(_bound(read + 8 * n * len(rows)))
    return out


def _time_sort_route(TK, captured) -> dict:
    """The sort route (K1 + K2) at a captured batch, against B1 and the
    twin on the same batch; the yardstick is one scatter_reduce of the
    first f64 sum field."""
    import torch

    (gid, tail, pred, pvalid, values, valids, ops, cols, state0), _ = captured
    args = dict(gid=gid, tail=tail, pred=pred, pvalid=pvalid,
                values=list(values), valids=list(valids))
    k = _call(TK.sorted_segment_agg_cuda, args, ops, cols, state0.clone())
    b1 = _call(TK.segment_agg_cuda, args, ops, cols, state0.clone())
    tw = _call(TK.sorted_segment_agg_reference, args, ops, cols, state0.clone())
    err = max(compare_states(TK, k, b1, ops), compare_states(TK, k, tw, ops))
    ms = _median_ms(lambda: _call(TK.sorted_segment_agg_cuda, args, ops, cols, k))
    b1_ms = _median_ms(lambda: _call(TK.segment_agg_cuda, args, ops, cols, b1))
    plain = _median_ms(lambda: _call(TK.sorted_segment_agg_reference, args, ops, cols, tw), 5)
    n, cap = gid.numel(), state0.shape[1]
    library = None
    f = next((i for i, op in enumerate(ops) if op == TK.OP_ADD_F64), None)
    if f is not None:
        mask = torch.ones(n, dtype=torch.bool, device=gid.device)
        for m in (tail, pred, pvalid, valids[cols[f]]):
            if m is not None:
                mask &= m
        v = torch.where(mask, values[cols[f]], 0.0)
        g = gid.long()
        acc = torch.zeros(cap, dtype=torch.float64, device=gid.device)
        library = _median_ms(lambda: acc.scatter_reduce(0, g, v, "sum"))
    out = dict(rows=n, capacity=cap, fields=len(ops), ms=ms, scatter_ms=b1_ms,
               plain_ms=plain, library_ms=library, max_abs_err=err)
    out.update(_bound(_bytes_moved(args, state0)))
    return out


def _keep_state(args):
    return args[:-1] + (args[-1].clone(),)


# ------------------------------------------------------ partition ids (B4)
def _pid_batch(n: int, n_cols: int, seed: int):
    """Seeded hash keys: one int64 column (negatives, nulls), or a float
    column (NaN, ±0.0, nulls; float32 at 2^20 rows, float64 above) beside a
    date32 and a timestamp column."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    if n_cols == 1:
        v = rng.integers(-(2**40), 2**40, n)
        v[:1000] = np.arange(-500, 500)
        return pa.record_batch([pa.array(v, mask=rng.random(n) < 0.05)], ["k"])
    f = rng.standard_normal(n) * 1e6
    f[rng.random(n) < 0.01] = np.nan
    z = rng.random(n) < 0.02
    f[z] = np.where(rng.random(int(z.sum())) < 0.5, -0.0, 0.0)
    f = f.astype(np.float32) if n <= PID_ROWS[0] else f
    days = rng.integers(-3000, 12000, n).astype("datetime64[D]")
    us = rng.integers(0, 2**50, n).astype("datetime64[us]")
    return pa.record_batch([
        pa.array(f, mask=rng.random(n) < 0.05),
        pa.array(days, pa.date32(), mask=rng.random(n) < 0.05),
        pa.array(us, pa.timestamp("us")),
    ], ["f", "d", "t"])


def _pid_inputs(TK, batch, device):
    """The kernel's inputs for every column of ``batch``, as the stage
    prepares them (``_pid_bits``)."""
    import torch

    prep = [TK._pid_bits(batch.column(i)) for i in range(batch.num_columns)]
    bits = torch.from_numpy(np.stack([b for b, _ in prep])).to(device)
    nulls = torch.from_numpy(np.stack([m for _, m in prep])).to(device)
    return bits, nulls


def _pid_bytes(bits) -> int:
    n_cols, n = bits.shape
    return n * n_cols * 9 + 4 * n  # each key's word and null flag, the id


def _time_pids(TK, bits, nulls, n_out: int) -> dict:
    import torch

    got = TK.partition_ids_cuda(bits, nulls, n_out)
    if not torch.equal(got, TK.partition_ids_twin(bits, nulls, n_out)):
        raise AssertionError("partition_ids differs from the twin")
    out = dict(rows=bits.shape[1], columns=bits.shape[0], partitions=n_out,
               ms=_median_ms(lambda: TK.partition_ids_cuda(bits, nulls, n_out)),
               plain_ms=_median_ms(lambda: TK.partition_ids_twin(bits, nulls, n_out), 5),
               library_ms=None, max_abs_err=0.0)
    out.update(_bound(_pid_bytes(bits)))
    return out


def pid_phase(TK, device) -> dict:
    """partition_ids vs its twin and the host partitioner."""
    import torch

    from arrow_ballista_tpu_torch.exec.expressions import Col
    from arrow_ballista_tpu_torch.exec.operators import hash_partition_indices

    times: dict = {}
    for n in PID_ROWS:
        for n_cols in PID_COLUMNS:
            batch = _pid_batch(n, n_cols, seed=n + n_cols)
            bits, nulls = _pid_inputs(TK, batch, device)
            exprs = [Col(i, f.name) for i, f in enumerate(batch.schema)]
            for n_out in PID_PARTITIONS:
                runs = [TK.partition_ids_cuda(bits, nulls, n_out) for _ in range(2)]
                twin = TK.partition_ids_twin(bits, nulls, n_out)
                torch.cuda.synchronize()
                if not torch.equal(runs[0], runs[1]):
                    raise AssertionError(f"partition_ids n={n}: two runs differ")
                host = hash_partition_indices(batch, exprs, n_out)
                if not (torch.equal(runs[0], twin)
                        and np.array_equal(runs[0].cpu().numpy(), host)):
                    raise AssertionError(
                        f"partition_ids n={n} cols={n_cols} n_out={n_out}: "
                        "differs from the twin or the host hash")
                t = _time_pids(TK, bits, nulls, n_out)
                times[f"n={n},columns={n_cols},partitions={n_out}"] = t
                print(f"partition_ids n={n} columns={n_cols} partitions={n_out}: ok "
                      f"(= twin = host hash), ms={t['ms']!r} bound_ms={t['bound_ms']!r} "
                      f"plain_ms={t['plain_ms']!r}")
                del runs, twin
            del bits, nulls, batch
    return times


# ------------------------------------------------------------- query phase
def _tables_equal(a, b, what: str) -> None:
    if a.schema.names != b.schema.names or a.num_rows != b.num_rows:
        raise AssertionError(f"{what}: shape {a.shape} vs {b.shape}")
    for name in a.schema.names:
        for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
            if isinstance(x, float) and y is not None:
                if not abs(x - y) <= REL * abs(x):
                    raise AssertionError(f"{what}.{name}: {x!r} vs {y!r}")
            elif x != y:
                raise AssertionError(f"{what}.{name}: {x!r} vs {y!r}")


def _stage_nodes(plan, cls) -> list:
    out, stack = [], [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, cls):
            out.append(node)
        stack.extend(node.children())
    return out


def lineitem_batches(lineitem) -> list:
    """2^23-row batches of lineitem, as ``ballista.batch.size`` cuts them."""
    import pyarrow as pa

    # to_batches cuts at every chunk boundary of every column, so make one
    # chunk per column first; l_comment passes 2 GiB at SF10 and needs
    # 64-bit offsets for that
    i = lineitem.schema.get_field_index("l_comment")
    lineitem = lineitem.set_column(
        i, "l_comment", lineitem.column(i).cast(pa.large_string())
    ).combine_chunks()
    return lineitem.to_batches(max_chunksize=1 << 23)


SETTINGS = {  # bench.py's
    "ballista.batch.size": str(1 << 23),
    "ballista.shuffle.partitions": "1",
}


def _stage_metrics(stages) -> dict:
    metrics: dict = {}
    for s in stages:
        for k, v in s.metrics.to_dict().items():
            metrics[k] = metrics.get(k, 0) + v
    return metrics


BREAKDOWN = ("tpu_stage_time_ns", "bridge_time_ns", "key_encode_time_ns",
             "device_time_ns", "tpu_compile_ns", "tpu_execute_ns")


def query_phase(tbt, TK, batches, device) -> dict:
    import torch

    from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec
    from benchmarks.tpch.queries import QUERIES

    n_rows = sum(b.num_rows for b in batches)

    def session(enable: bool):
        cfg = dict(SETTINGS, **{"ballista.tpu.enable": str(enable).lower()})
        ctx = tbt.SessionContext(tbt.BallistaConfig(cfg), device=device)
        ctx.register_record_batches("lineitem", [batches])
        return ctx

    out = {}
    for q in (1, 6):
        cpu_ctx = session(False)
        plan = cpu_ctx.sql(QUERIES[q]).physical_plan()
        t0 = time.perf_counter()
        want = cpu_ctx.execute(plan)
        cpu_s = time.perf_counter() - t0

        ctx = session(True)
        plan = ctx.sql(QUERIES[q]).physical_plan()
        stages = _stage_nodes(plan, TorchStageExec)
        if not stages:
            raise AssertionError(f"q{q}: no TorchStageExec in the plan")
        _reset_counts(TK)
        with Capture(TK, "segment_agg", keep=_keep_state) as first:
            t0 = time.perf_counter()
            got = ctx.execute(plan)
            torch.cuda.synchronize()
            dev_s = time.perf_counter() - t0
        launches = dict(TK.LAUNCHES)
        if launches["segment_agg"] < 1:
            raise AssertionError(f"q{q}: the kernel never launched")
        metrics = _stage_metrics(stages)
        for k in ("tpu_fallback", "cpu_fallback", "highcard_fallback"):
            if metrics.get(k, 0):
                raise AssertionError(f"q{q}: {k}={metrics[k]}")
        _tables_equal(want, got, f"q{q}")
        breakdown = {k: metrics.get(k, 0) for k in BREAKDOWN}
        print(
            f"q{q}: rows={n_rows} launches={json.dumps(launches)} "
            f"cuda_rows_per_s={n_rows / dev_s!r} cpu_rows_per_s={n_rows / cpu_s!r} "
            f"cuda_s={dev_s!r} cpu_s={cpu_s!r} breakdown={json.dumps(breakdown)}"
        )
        out[q] = dict(launches=launches, args=first.args)
    return out


def q3_phase(tbt, TK, batches, orders, customer, device) -> dict:
    """TPC-H q3: the aggregate above the CPU join on the card, against the
    CPU operators; its sort route must launch."""
    import torch

    from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec
    from benchmarks.tpch.queries import QUERIES

    n_rows = sum(b.num_rows for b in batches)

    def session(enable: bool):
        cfg = dict(SETTINGS, **{"ballista.tpu.enable": str(enable).lower()})
        ctx = tbt.SessionContext(tbt.BallistaConfig(cfg), device=device)
        ctx.register_record_batches("lineitem", [batches])
        ctx.register_arrow_table("orders", orders)
        ctx.register_arrow_table("customer", customer)
        return ctx

    cpu_ctx = session(False)
    plan = cpu_ctx.sql(QUERIES[3]).physical_plan()
    t0 = time.perf_counter()
    want = cpu_ctx.execute(plan)
    cpu_s = time.perf_counter() - t0

    ctx = session(True)
    plan = ctx.sql(QUERIES[3]).physical_plan()
    stages = _stage_nodes(plan, TorchStageExec)
    if not stages:
        raise AssertionError("q3: no TorchStageExec in the plan")
    _reset_counts(TK)
    with Capture(TK, "radix_argsort_cuda") as sort, \
            Capture(TK, "sorted_segment_agg_cuda", keep=_keep_state) as route:
        t0 = time.perf_counter()
        got = ctx.execute(plan)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
    launches = dict(TK.LAUNCHES)
    metrics = _stage_metrics(stages)
    for k in ("tpu_fallback", "cpu_fallback", "highcard_fallback"):
        if metrics.get(k, 0):
            raise AssertionError(f"q3: {k}={metrics[k]} ({json.dumps(metrics)})")
    for k in ("radix_sort", "seg_scan"):
        if launches[k] < 1:
            raise AssertionError(f"q3: the sort route's {k} never launched")
    _tables_equal(want, got, "q3")
    breakdown = {k: metrics.get(k, 0) for k in BREAKDOWN + (
        "capacity_growths", "input_rows", "output_rows")}
    print(
        f"q3: lineitem_rows={n_rows} launches={json.dumps(launches)} "
        f"cuda_rows_per_s={n_rows / dev_s!r} cpu_rows_per_s={n_rows / cpu_s!r} "
        f"cuda_s={dev_s!r} cpu_s={cpu_s!r} "
        f"breakdown={json.dumps(breakdown)}"
    )
    return dict(launches=launches, sort=sort.args, route=route.args)


WINDOW_SQL = """select l_orderkey, l_linenumber,
 row_number() over (partition by l_suppkey order by l_shipdate, l_orderkey, l_linenumber) rn,
 rank() over (partition by l_suppkey order by l_shipdate) rk,
 sum(l_extendedprice) over (partition by l_suppkey order by l_shipdate) rs,
 avg(l_quantity) over (partition by l_suppkey order by l_shipdate, l_orderkey, l_linenumber rows between 6 preceding and current row) ma,
 max(l_discount) over (partition by l_suppkey order by l_shipdate, l_orderkey, l_linenumber rows between 6 preceding and current row) mx,
 lag(l_extendedprice, 1) over (partition by l_suppkey order by l_shipdate, l_orderkey, l_linenumber) lg
from lineitem"""


def _tables_close(a, b, what: str) -> None:
    """Vectorised _tables_equal for large results, row by row in the
    order both legs produce (a window keeps its input order): floats
    within REL with NaN matching NaN, all else exact."""
    import pyarrow.compute as pc

    if a.schema.names != b.schema.names or a.num_rows != b.num_rows:
        raise AssertionError(f"{what}: shape {a.shape} vs {b.shape}")
    for name in a.schema.names:
        x, y = a.column(name), b.column(name)
        xv = np.asarray(pc.is_valid(x))
        if not np.array_equal(xv, np.asarray(pc.is_valid(y))):
            raise AssertionError(f"{what}.{name}: null positions differ")
        xn = x.fill_null(0).to_numpy()[xv]
        yn = y.fill_null(0).to_numpy()[xv]
        if xn.dtype.kind == "f":
            if not np.array_equal(np.isnan(xn), np.isnan(yn)):
                raise AssertionError(f"{what}.{name}: NaN positions differ")
            ok = ~np.isnan(xn)
            bad = ~(np.abs(xn[ok] - yn[ok]) <= REL * np.abs(xn[ok]))
            if bad.any():
                i = int(np.argmax(bad))
                raise AssertionError(f"{what}.{name}: {xn[ok][i]!r} vs {yn[ok][i]!r}")
        elif not np.array_equal(xn, yn):
            raise AssertionError(f"{what}.{name}: values differ")


def window_phase(tbt, TK, WK, batches, device) -> dict:
    """The window query: TorchWindowExec against the CPU WindowExec."""
    import torch

    from arrow_ballista_tpu_torch.ops.window_compiler import TorchWindowExec

    n_rows = sum(b.num_rows for b in batches)

    def session(enable: bool):
        cfg = dict(SETTINGS, **{"ballista.tpu.enable": str(enable).lower()})
        ctx = tbt.SessionContext(tbt.BallistaConfig(cfg), device=device)
        ctx.register_record_batches("lineitem", [batches])
        return ctx

    cpu_ctx = session(False)
    plan = cpu_ctx.sql(WINDOW_SQL).physical_plan()
    t0 = time.perf_counter()
    want = cpu_ctx.execute(plan)
    cpu_s = time.perf_counter() - t0

    ctx = session(True)
    plan = ctx.sql(WINDOW_SQL).physical_plan()
    nodes = _stage_nodes(plan, TorchWindowExec)
    if not nodes:
        raise AssertionError("window: no TorchWindowExec in the plan")
    _reset_counts(TK)
    with Capture(TK, "radix_argsort_cuda") as sort, \
            Capture(TK, "seg_scan_cuda") as scan, \
            Capture(WK, "range_extremum_cuda") as rx, \
            Capture(WK, "window_flags_cuda") as flags, \
            Capture(WK, "window_pack_cuda") as pack:
        t0 = time.perf_counter()
        got = ctx.execute(plan)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
    launches = dict(TK.LAUNCHES)
    metrics = _stage_metrics(nodes)
    print(
        f"window: rows={n_rows} launches={json.dumps(launches)} "
        f"cuda_rows_per_s={n_rows / dev_s!r} cpu_rows_per_s={n_rows / cpu_s!r} "
        f"cuda_s={dev_s!r} cpu_s={cpu_s!r} "
        f"window_time_ns={metrics.get('window_time_ns', 0)}"
    )
    if metrics.get("tpu_window", 0) < 1 or metrics.get("tpu_fallback", 0):
        raise AssertionError(f"window: metrics {json.dumps(metrics)}")
    for k in ("radix_sort", "seg_scan", "range_extremum", "window_epilogue"):
        if launches[k] < 1:
            raise AssertionError(f"window: {k} never launched")
    t0 = time.perf_counter()
    _tables_close(want, got, "window")
    print(f"window: equal to the CPU WindowExec, compared in s={time.perf_counter() - t0!r}")
    return dict(launches=launches, sort=sort.args, scan=scan.args, rx=rx.args,
                flags=flags.args, pack=pack.args)


# ------------------------------------------------------- distributed phase
DIST_TABLES = ("lineitem", "orders", "customer")
DIST_SETTINGS = {
    "ballista.shuffle.partitions": "8",
    "ballista.mesh.enable": "false",
}


def write_parquet(tables: dict, root: str) -> None:
    """Each table as PARQUET_FILES parquet files under ``root/<name>/``
    (one file for a table of 100 rows or fewer), written in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow.parquet as pq

    jobs = []
    for name, tbl in tables.items():
        os.makedirs(os.path.join(root, name))
        n_parts = PARQUET_FILES if tbl.num_rows > 100 else 1
        per = -(-tbl.num_rows // n_parts)
        for i in range(n_parts):
            path = os.path.join(root, name, f"part-{i}.parquet")
            jobs.append((tbl.slice(i * per, per), path))
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: pq.write_table(*job), jobs))


class PidCheck:
    """Wraps ``TK.device_partition_ids`` to keep every batch a stage hashed
    and the ids it got; ``check`` then holds them against the host hash."""

    def __init__(self, TK):
        self.TK, self.seen = TK, []

    def __enter__(self):
        inner = self.inner = self.TK.device_partition_ids

        def hook(batch, exprs, n, device):
            pids = inner(batch, exprs, n, device)
            if pids is not None:
                self.seen.append((batch, list(exprs), n, pids))
            return pids

        self.TK.device_partition_ids = hook
        return self

    def __exit__(self, *exc):
        self.TK.device_partition_ids = self.inner

    def check(self) -> int:
        from arrow_ballista_tpu_torch.exec.operators import hash_partition_indices

        rows = 0
        for batch, exprs, n, pids in self.seen:
            if not np.array_equal(pids, hash_partition_indices(batch, exprs, n)):
                raise AssertionError("device partition ids differ from the host hash")
            rows += batch.num_rows
        return rows


def _run_job(ctx, sql: str):
    """One distributed job: (result, wall seconds, its stage metrics summed
    per operator)."""
    import torch

    before = set(ctx._job_ids)
    t0 = time.perf_counter()
    out = ctx.sql(sql).collect()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    (job_id,) = set(ctx._job_ids) - before
    scheduler, _ = ctx._standalone_handles
    detail = scheduler.server.state.task_manager.get_job_detail(job_id)
    metrics: dict = {}
    for stage in detail["stages"]:
        for op, vals in (stage.get("metrics") or {}).items():
            acc = metrics.setdefault(op, {})
            for k, v in vals.items():
                if isinstance(v, (int, float)):
                    acc[k] = acc.get(k, 0) + v
    return out, seconds, metrics


def distributed_phase(tbt, TK, root: str, lineitem_rows: int, device) -> dict:
    """q3 and q1 through the port's standalone cluster on the card, each
    held against the same cluster with ``ballista.tpu.enable=false``."""
    from benchmarks.tpch.queries import QUERIES

    ctx = tbt.BallistaContext.standalone(
        tbt.BallistaConfig(dict(DIST_SETTINGS)), num_executors=1,
        concurrent_tasks=4, device=device,
    )
    out: dict = {}
    try:
        for name in DIST_TABLES:
            ctx.register_parquet(name, os.path.join(root, name))
        for q in (3, 1):
            ctx.sql("SET ballista.tpu.enable = false")
            want, cpu_s, _ = _run_job(ctx, QUERIES[q])
            ctx.sql("SET ballista.tpu.enable = true")
            _reset_counts(TK)
            with Capture(TK, "partition_ids_cuda") as first, PidCheck(TK) as pids:
                got, dev_s, metrics = _run_job(ctx, QUERIES[q])
            launches = dict(TK.LAUNCHES)
            stage = metrics.get("TorchStageExec", {})
            writer = metrics.get("ShuffleWriterExec", {})
            if stage.get("input_rows", 0) < 1:
                raise AssertionError(f"distributed q{q}: no device stage ran ({json.dumps(metrics)})")
            for k in ("tpu_fallback", "cpu_fallback", "highcard_fallback"):
                if stage.get(k, 0):
                    raise AssertionError(f"distributed q{q}: {k}={stage[k]}")
            _tables_equal(want, got, f"distributed q{q}")
            hashed = pids.check()
            need = ("partition_ids", "radix_sort", "seg_scan") if q == 3 else ("segment_agg",)
            for k in need:
                if launches[k] < 1:
                    raise AssertionError(f"distributed q{q}: {k} never launched")
            if q == 3 and writer.get("device_pid_batches", 0) < 1:
                raise AssertionError("distributed q3: the writers hashed no batch on the card")
            breakdown = {k: stage.get(k, 0) for k in BREAKDOWN + ("input_rows", "output_rows")}
            print(
                f"distributed q{q}: lineitem_rows={lineitem_rows} "
                f"launches={json.dumps(launches)} "
                f"cuda_rows_per_s={lineitem_rows / dev_s!r} "
                f"cpu_rows_per_s={lineitem_rows / cpu_s!r} cuda_s={dev_s!r} cpu_s={cpu_s!r} "
                f"device_pid_batches={writer.get('device_pid_batches', 0)} "
                f"device_pid_rows={hashed} breakdown={json.dumps(breakdown)} "
                f"repart_time_ns={writer.get('repart_time_ns', 0)} "
                f"write_time_ns={writer.get('write_time_ns', 0)}"
            )
            out[q] = dict(launches=launches, pids=first.args)
    finally:
        ctx.close()
    return out


# ------------------------------------------------------------ timing phase
def _median_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _bytes_moved(args: dict, state) -> int:
    n = args["gid"].numel()
    total = 4 * n + 2 * state.numel() * 8  # gid, state read + written
    for m in (args["tail"], args["pred"], args["pvalid"], *args["valids"]):
        total += 0 if m is None else n
    for v in args["values"]:
        total += 0 if v is None else 8 * n
    return total


def time_shape(TK, captured) -> dict:
    import torch

    (gid, tail, pred, pvalid, values, valids, ops, cols, state0), _ = captured
    args = dict(gid=gid, tail=tail, pred=pred, pvalid=pvalid,
                values=list(values), valids=list(valids))
    k_state = _call(TK.segment_agg_cuda, args, ops, cols, state0.clone())
    t_state = _call(TK.segment_agg_reference, args, ops, cols, state0.clone())
    err = compare_states(TK, k_state, t_state, ops)
    ms = _median_ms(lambda: _call(TK.segment_agg_cuda, args, ops, cols, k_state))
    plain = _median_ms(lambda: _call(TK.segment_agg_reference, args, ops, cols, t_state))
    # yardstick: one index_add_ of every f64 sum field, masks pre-applied
    n, cap = args["gid"].numel(), state0.shape[1]
    mask = torch.ones(n, dtype=torch.bool, device=state0.device)
    for m in (args["tail"], args["pred"], args["pvalid"]):
        if m is not None:
            mask &= m
    sums = []
    for op, c in zip(ops, cols):
        if op == TK.OP_ADD_F64:
            m = mask if args["valids"][c] is None else mask & args["valids"][c]
            sums.append(torch.where(m, args["values"][c], 0.0))
    library = None
    if sums:
        V = torch.stack(sums, dim=1)
        g = args["gid"].long()
        acc = torch.zeros(cap, V.shape[1], dtype=torch.float64, device=V.device)
        library = _median_ms(lambda: acc.index_add_(0, g, V))
    bytes_ms = _bytes_moved(args, state0) / HBM_BYTES_PER_S * 1e3
    ops_ms = n * len(ops) / F64_OPS_PER_S * 1e3
    return dict(
        rows=n, capacity=cap, fields=len(ops), columns=len(args["values"]),
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=library,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )


# -------------------------------------------------------------------- main
def _entry(name: str, head: dict, launches: int, err: float, **extra) -> dict:
    source, replaces = KERNELS[name]
    entry = dict(
        name=name, route="cuda", source=CUDA_DIR + source, replaces=replaces,
        launches=launches, max_abs_err=err, ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
    )
    entry.update(extra)
    return entry


def _checked_sort(TK, captured) -> dict:
    import torch

    (keys,), _ = captured
    if not torch.equal(TK.radix_argsort_cuda(keys), TK.radix_argsort_reference(keys)):
        raise AssertionError("radix_sort differs from the twin at a main-path shape")
    return _time_sort(TK, keys)


def _checked_scan(TK, captured) -> dict:
    (cols, n, *rest), kw = captured
    kw = dict(zip(("perm", "flag", "key", "aux", "reverse"), rest), **kw)
    err = _compare_words(TK, cols, TK.seg_scan_cuda(cols, n, **kw),
                         TK.seg_scan_reference(cols, n, **kw), "seg_scan main path")
    return _time_scan(TK, cols, n, kw, err)


def _checked_extremum(WK, captured) -> dict:
    import torch

    args, _ = captured
    if not torch.equal(WK.range_extremum_cuda(*args), WK.range_extremum_reference(*args)):
        raise AssertionError("range_extremum differs from the twin at a main-path shape")
    return _time_extremum(WK, args)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=10.0, help="TPC-H scale factor")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print the compiler's output (registers, spills)")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    print(f"card: {card_line()}")
    print(env_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    entries = run(opts, torch.device("cuda"))

    leaked = sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith("jax.")
        or m == "arrow_ballista_tpu" or m.startswith("arrow_ballista_tpu.")
    )
    if leaked:
        raise AssertionError(f"JAX-side modules loaded: {leaked[:5]}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


def run(opts, device) -> list:
    """Every phase on ``device``; returns the kernels' entries."""
    import arrow_ballista_tpu_torch as tbt
    from arrow_ballista_tpu_torch.ops import kernels as TK
    from arrow_ballista_tpu_torch.ops import window_kernel as WK
    from arrow_ballista_tpu_torch.ops.cuda import build
    from benchmarks.tpch.datagen import gen_lineitem, gen_table

    built: dict = {}

    def do_build():
        t0 = time.perf_counter()
        try:
            build.load(verbose=opts.verbose_build)
        except BaseException as e:  # re-raised on the main thread
            built["error"] = e
        built["s"] = time.perf_counter() - t0

    builder = threading.Thread(target=do_build)
    builder.start()
    t0 = time.perf_counter()
    lineitem = gen_lineitem(opts.sf)
    orders, customer = gen_table("orders", opts.sf), gen_table("customer", opts.sf)
    print(f"datagen: sf={opts.sf} rows={lineitem.num_rows} orders={orders.num_rows} "
          f"customer={customer.num_rows} s={time.perf_counter() - t0!r}")
    lineitem_rows = lineitem.num_rows
    t0 = time.perf_counter()
    parquet = tempfile.TemporaryDirectory(prefix="tpch-parquet-")
    write_parquet({"lineitem": lineitem, "orders": orders, "customer": customer},
                  parquet.name)
    print(f"parquet: {PARQUET_FILES} files per table s={time.perf_counter() - t0!r}")
    builder.join()
    if "error" in built:
        raise built["error"]
    print(f"build: s={built['s']!r}")

    t0 = time.perf_counter()
    kernel_err, kernel_times, sorted_times = kernel_phase(TK, device)
    sort_times = sort_phase(TK, device)
    scan_times, rx_times, epilogue_times = scan_phase(TK, WK, device)
    scan_err = max(t["max_abs_err"] for t in scan_times.values())
    pid_times = pid_phase(TK, device)
    print(f"kernel phase: ok s={time.perf_counter() - t0!r}")

    batches = lineitem_batches(lineitem)
    del lineitem
    queries = query_phase(tbt, TK, batches, device)
    q3 = q3_phase(tbt, TK, batches, orders, customer, device)
    del orders, customer
    window = window_phase(tbt, TK, WK, batches, device)
    del batches
    with parquet:
        dist = distributed_phase(tbt, TK, parquet.name, lineitem_rows, device)
    runs = [queries[1], queries[6], q3, window, dist[3], dist[1]]
    launches = {k: sum(r["launches"][k] for r in runs) for k in KERNELS}

    shapes = {f"q{q}": time_shape(TK, r["args"]) for q, r in queries.items()}
    sort_shapes = {"q3": _checked_sort(TK, q3["sort"]),
                   "window": _checked_sort(TK, window["sort"])}
    route = _time_sort_route(TK, q3["route"])
    scan_shapes = {"window": _checked_scan(TK, window["scan"]), "q3_sort_route": route}
    rx_shape = _checked_extremum(WK, window["rx"])
    pack_shape = _time_pack(WK, window["pack"])
    flags_shape = _time_flags(WK, window["flags"])
    (pid_bits, pid_nulls, pid_n), _ = dist[3]["pids"]
    pid_shape = _time_pids(TK, pid_bits, pid_nulls, pid_n)
    for name, t in [*shapes.items(), *(("radix_sort " + k, v) for k, v in sort_shapes.items()),
                    *(("seg_scan " + k, v) for k, v in scan_shapes.items()),
                    ("range_extremum window", rx_shape), ("window_pack window", pack_shape),
                    ("window_flags window", flags_shape),
                    ("partition_ids distributed q3", pid_shape)]:
        print(f"timing {name}: {json.dumps(t)}")

    entries = [
        _entry("segment_agg", shapes["q1"], launches["segment_agg"],
               max([kernel_err] + [s["max_abs_err"] for s in shapes.values()]),
               shapes=shapes, kernel_phase=kernel_times, sort_route=sorted_times),
        _entry("radix_sort", sort_shapes["q3"], launches["radix_sort"], 0.0,
               shapes=sort_shapes, kernel_phase=sort_times),
        _entry("seg_scan", scan_shapes["window"], launches["seg_scan"],
               max(scan_err, route["max_abs_err"], scan_shapes["window"]["max_abs_err"]),
               shapes=scan_shapes, kernel_phase=scan_times),
        _entry("range_extremum", rx_shape, launches["range_extremum"], 0.0,
               kernel_phase=rx_times),
        _entry("window_epilogue", pack_shape, launches["window_epilogue"], 0.0,
               shapes={"pack": pack_shape, "flags": flags_shape},
               kernel_phase=epilogue_times),
        _entry("partition_ids", pid_shape, launches["partition_ids"], 0.0,
               kernel_phase=pid_times),
    ]

    return entries


if __name__ == "__main__":
    sys.exit(main())
