#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``arrow_ballista_tpu_torch``) on one
NVIDIA card.  Run from the repository root:

    python3 chip_smoke.py [--sf 10]

Phases; any failure exits non-zero and prints no result line:

1. card   — the card's name and power limit (nvidia-smi);
2. build  — the CUDA kernels from this checkout's sources, built in a
            background thread while the TPC-H data is generated;
3. kernel — ``segment_agg`` against its plain PyTorch twin on the card over
            seeded inputs (n in {2^20, 2^23}, capacity in {1, 4, 64, 4096,
            2^20}) with nulls, NaN, ±0.0, all-filtered groups and int64 sums
            past 2^53: floats within rel 1e-9 (the two sum in different
            orders), everything else exact, and two kernel runs
            bit-identical; each case's time per launch (median of 20)
            beside its bound, so a capacity cliff shows;
4. query  — TPC-H q1 and q6 over ``--sf`` lineitem (``gen_lineitem``'s
            seed, streamed as ``ballista.batch.size`` = 2^23-row batches,
            ``ballista.shuffle.partitions`` = 1) through
            ``SessionContext(device="cuda")``, held against the same session
            with ``ballista.tpu.enable=false`` (the CPU operators).  Launch
            counts are set to 0 just before each query and read just after;
            the plan must hold a TorchStageExec, no fallback may fire and
            the kernel must have launched;
5. timing — the kernel, its twin and one ``index_add_`` of the sum fields,
            on the first batch the query phase gave the kernel (CUDA
            events, median of 20 launches), beside the least time the card
            could take (the bytes the call must move at 3.35 TB/s).

Then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F64_OPS_PER_S = 34e12  # H100 SXM f64 outside the tensor cores
REL = 1e-9
KERNEL_SOURCE = "arrow_ballista_tpu_torch/ops/cuda/segment_agg.cu"
REPLACES = "arrow_ballista_tpu/ops/kernels.py:1158"


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


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


def kernel_phase(TK, device) -> tuple[float, dict]:
    """Kernel vs twin over every (n, capacity) case; returns the largest
    sum error and each case's ms per launch with its bound."""
    import torch

    specs, ops, cols = _fields(TK)
    worst = 0.0
    times: dict = {}
    for n in (1 << 20, 1 << 23):
        for cap in (1, 4, 64, 4096, 1 << 20):
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
            del args, runs, twin, state
    return worst, times


# ------------------------------------------------------------- query phase
class FirstCall:
    """Wraps ``kernels.segment_agg`` to keep the first call's arguments
    (with the state as it was before the call) for the timing phase."""

    def __init__(self, TK):
        self.TK = TK
        self.inner = TK.segment_agg
        self.args = None

    def __enter__(self):
        def hook(gid, tail, pred, pvalid, values, valids, ops, cols, state):
            if self.args is None:
                self.args = (
                    dict(gid=gid, tail=tail, pred=pred, pvalid=pvalid,
                         values=list(values), valids=list(valids)),
                    list(ops), list(cols), state.clone(),
                )
            return self.inner(
                gid, tail, pred, pvalid, values, valids, ops, cols, state
            )

        self.TK.segment_agg = hook
        return self

    def __exit__(self, *exc):
        self.TK.segment_agg = self.inner


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


def query_phase(tbt, TK, lineitem, device) -> dict:
    import torch

    from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec
    from benchmarks.tpch.queries import QUERIES

    import pyarrow as pa

    # to_batches cuts at every chunk boundary of every column, so make one
    # chunk per column first; l_comment passes 2 GiB at SF10 and needs
    # 64-bit offsets for that
    i = lineitem.schema.get_field_index("l_comment")
    lineitem = lineitem.set_column(
        i, "l_comment", lineitem.column(i).cast(pa.large_string())
    ).combine_chunks()
    batches = lineitem.to_batches(max_chunksize=1 << 23)
    n_rows = lineitem.num_rows
    settings = {
        "ballista.batch.size": str(1 << 23),
        "ballista.shuffle.partitions": "1",
    }

    def session(enable: bool):
        cfg = dict(settings, **{"ballista.tpu.enable": str(enable).lower()})
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
        with FirstCall(TK) as first:
            TK.segment_agg_cuda.launches = 0
            t0 = time.perf_counter()
            got = ctx.execute(plan)
            torch.cuda.synchronize()
            dev_s = time.perf_counter() - t0
            launches = TK.segment_agg_cuda.launches
        if launches < 1:
            raise AssertionError(f"q{q}: the kernel never launched")
        metrics: dict = {}
        for s in stages:
            for k, v in s.metrics.to_dict().items():
                metrics[k] = metrics.get(k, 0) + v
        for k in ("tpu_fallback", "cpu_fallback", "highcard_fallback"):
            if metrics.get(k, 0):
                raise AssertionError(f"q{q}: {k}={metrics[k]}")
        _tables_equal(want, got, f"q{q}")
        breakdown = {
            k: metrics.get(k, 0)
            for k in ("tpu_stage_time_ns", "bridge_time_ns", "key_encode_time_ns",
                      "device_time_ns", "tpu_compile_ns", "tpu_execute_ns")
        }
        print(
            f"q{q}: rows={n_rows} launches={launches} "
            f"cuda_rows_per_s={n_rows / dev_s!r} cpu_rows_per_s={n_rows / cpu_s!r} "
            f"cuda_s={dev_s!r} cpu_s={cpu_s!r} breakdown={json.dumps(breakdown)}"
        )
        out[q] = dict(launches=launches, args=first.args)
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

    args, ops, cols, state0 = captured
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
    import arrow_ballista_tpu_torch as tbt
    from arrow_ballista_tpu_torch.ops import kernels as TK
    from arrow_ballista_tpu_torch.ops.cuda import build
    from benchmarks.tpch.datagen import gen_lineitem

    device = torch.device("cuda")
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

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
    print(f"datagen: sf={opts.sf} rows={lineitem.num_rows} "
          f"s={time.perf_counter() - t0!r}")
    builder.join()
    if "error" in built:
        raise built["error"]
    print(f"build: s={built['s']!r}")

    t0 = time.perf_counter()
    kernel_err, kernel_times = kernel_phase(TK, device)
    print(f"kernel phase: ok s={time.perf_counter() - t0!r}")

    queries = query_phase(tbt, TK, lineitem, device)
    del lineitem

    shapes = {f"q{q}": time_shape(TK, r["args"]) for q, r in queries.items()}
    for name, s in shapes.items():
        print(f"timing {name}: {json.dumps(s)}")
    main_shape = shapes["q1"]
    entry = dict(
        name="segment_agg",
        route="cuda",
        source=KERNEL_SOURCE,
        replaces=REPLACES,
        launches=sum(r["launches"] for r in queries.values()),
        max_abs_err=max([kernel_err] + [s["max_abs_err"] for s in shapes.values()]),
        ms=main_shape["ms"],
        plain_ms=main_shape["plain_ms"],
        bound_ms=main_shape["bound_ms"],
        bound_by=main_shape["bound_by"],
        library_ms=main_shape["library_ms"],
        shapes=shapes,
        kernel_phase=kernel_times,
    )

    leaked = sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith("jax.")
        or m == "arrow_ballista_tpu" or m.startswith("arrow_ballista_tpu.")
    )
    if leaked:
        raise AssertionError(f"JAX-side modules loaded: {leaked[:5]}")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
