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
              permutation equal to the twin's, two runs bit-identical, one
              call's ms beside ``burst_ms`` (20 calls back to back: the
              card's ms where one call's events measure the host) and
              ``torch.sort(stable=True)``'s, and the scratch a call
              allocates; then one key at rows around the one-CTA sort's
              bound (its last size and the tiled passes' first), checked
              and timed beside torch.sort; the main-path legs print K1's
              calls by path;
            * ``seg_scan``, ``range_extremum`` and ``window_epilogue`` at
              n in {2^20, 2^23}, and the whole window kernel against its
              twin;
            * ``partition_ids`` (B4) at n in {2^20, 2^23} x key columns in
              {1, 3} x partitions in {1, 7, 200, 2^16} over seeded keys
              (negative ints, nulls, NaN, ±0.0, float32, date32,
              timestamp): equal to its twin and to the host partitioner
              ``hash_partition_indices``;
            * ``segment_agg_entries`` (B13a) at E in {1, 8, 32} entries
              (2^22 rows each for E <= 8, 2^19 for 32, the last entry
              shorter; q1's own entries are timed in the query phase) x capacity in {1, 64, 4096, 2^16}: bit-identical to
              E ``segment_agg`` launches in entry order, equal to its twin;
            * B1 at q1's stand-in (``q1_stand_in``: 2^23 rows, q1's 16
              fields, 4 groups) and at distributed q1's 8,192-row batch,
              B13a at the cold q1 leg's stand-in (8 entries, 59,990,658
              rows): each beside its bound and ``index_add_`` of the sums,
              with ``burst_ms``, the host's ms and the card's by pass
              (``seg_agg_split``: torch.profiler);
            * ``expr_eval`` (B3) over a seeded grid of 2^20 rows, one
              expression for every opcode (nulls, NaN, ±0.0, ±inf,
              subnormals, int64 past 2^53, INT64_MIN, zero and -1
              divisors): two kernel runs, the twin and the closures the
              program was compiled from, all bit-identical; after the
              query phase the same at q1's and q6's own programs over
              their first batch's 2^20 and 2^23 rows, each with the
              closures' ms beside the kernel's;
            * ``join_build_table`` and ``join_probe`` (B5) in three forms
              (dense slot tables of 2^20 and 2^26 slots, sorted keys over a
              span past 2^26) at n in {2^20, 2^23} probe rows x {0, 1, 3}
              build columns (f64 with NaN and -0.0, int64, int32 with
              nulls), probe keys with nulls, misses, keys below kmin and
              negative keys: bit-identical to the twins;
            * ``mesh_reduce`` and ``mesh_route`` (B13b) on a mesh of 4
              shards of the one card: the reduce over q1's state (16
              fields) and a mixed one (NaN, -0.0, int64 past 2^53) at
              capacity in {64, 2^20}; the route over 4 shards of 2^23 rows
              of q3's lineitem columns (int64, f64, f64, each with its
              validity, and the int32 ``__part``) to 4 destinations, at
              the exact capacity and one below the exact need (n_dropped
              the surplus, the exchange at twice that capacity delivering
              every row); all bit-identical to the twins;
            * ``keyed_encode_entries`` and ``keyed_unfold`` (B7c) on four
              cases of H2O_ROWS rows in two entries (2^23 rows and the
              rest): h2o q6's keys (two int32 keys, folded), q9's (a host
              code and an int32 key, folded), q10's six (the fold
              declined: per-key columns) and an x32 case whose host codes
              wrap to negative words (folded): the encode folded and per
              key against its twin and against one ``key_encode`` an entry
              + ``torch.cat``, the unfold against its twin and against the
              key rows of the unfolded sort, all bit for bit, each with K1's
              pass count, and K1 + the gid kernel's ms, over ``[inv, comb]``
              and over ``[inv, *codes]``;
            * ``keyed_finish`` (B8) in both forms at FINISH_ROWS rows, a
              tenth masked, in 10,000 uniform ids, 4 ids (each group over
              hundreds of tiles) and Zipf 1.1 ids, with NaN, ±inf and
              ±0.0 in a few groups (``finish_case``): against the twin
              (f64 sums within rel 1e-9, x32 pair sums within rel 1e-6,
              every other word bit for bit), two launches bit-identical;
              timed with its device split (torch.profiler), beside the
              gather floor and one ``index_add_``; the main path's shapes
              the same in the timing phase;
4. query  — TPC-H q1 and q6 over ``--sf`` lineitem (``gen_lineitem``'s
            seed, streamed as ``ballista.batch.size`` = 2^23-row batches,
            ``ballista.shuffle.partitions`` = 1) through
            ``SessionContext(device="cuda")``, held against the same session
            with ``ballista.tpu.enable=false`` (the CPU operators), each
            three ways: ``ballista.tpu.cache_columns=false`` (one
            ``segment_agg`` launch per batch), cold with the column cache
            (one ``segment_agg_entries`` launch, ``cache_hits`` 0, equal bit
            for bit to the cache-off run) and warm on the same session (a
            cache hit: no scan, ``key_encode_time_ns`` and
            ``bridge_time_ns`` 0, equal bit for bit to the cold run), with
            the peak device memory and ``device_cache.stats()`` after each;
4b. x32   — the same batches under ``set_precision("x32")`` (restored
            after these legs), against the query phase's CPU answers at
            rel 1e-6 (integers exact): q1 and q6 three ways (cache off:
            ``df32_agg`` matmul form and ``x32_merge`` per batch; cold and
            warm per entry), q1 warm again forced to the scatter route
            (``df32_agg``'s scatter form) and the sort route (``seg_scan``'s
            df32 fold), a q1 min/max query against its own CPU run (f64
            extrema bit-exact, ``ord_extremum``) and q1 over 8 partitions as
            one ``MeshGangExec`` (``mesh_reduce``'s x32 form), and the
            variance family (``X32_VAR_SQL``: stddev and var_pop square
            their exact f32 pairs in ``expr_eval``'s ``sqpair_lo`` opcode,
            B12f, and the stage takes the sort route) against its own CPU
            run; then
            ``df32_agg`` (both forms), ``ord_extremum``, ``x32_merge``, the
            x32 ops of ``seg_scan``, ``mesh_reduce`` (4 shards) and
            ``expr_eval`` against their twins at the first main-path shape
            and a wide one (``df32_agg`` at capacity 8192, uniform and
            Zipf-skewed group ids, ``ord_extremum`` and ``x32_merge`` at
            2^20): ``df32_agg`` and the df32 fold within rel 1e-6 on
            hi + lo, everything else bit-identical, two launches
            bit-identical; ``df32_agg``'s two passes timed apart
            (torch.profiler) beside the bytes of its block partials; and
            ``df32_agg``
            (both forms) and the df32 fold on the cancellation mix
            (``df32_cancel_inputs``: group sums near 0 beside large
            values) within rel 1e-6 of the f64 sum on every group, a bar
            the hi word alone and numpy's f32 sum must each fail;
5. q3     — TPC-H q3 (BASELINE config #3) the same way; its join folds
            into the device stage, and the route must be the one the
            reference's capacity rule gives on this data, computed on the
            host (a bail to the unfolded shape when the probe keys outrun
            the group table); no CPU fallback either way, and the sort
            route must launch;
6. star   — ``bench_suite.py:bench_starjoin``'s star join (6e7 fact rows
            probing a 1e6-row dimension, ``default_rng(9)``, 2^23-row
            batches) the same way: the dense device join with no fallback,
            ``join_probe`` once per batch;
7. keyed  — the keyed route (B7-B10, B7c): TPC-H q3 again with
            ``ballista.tpu.highcard_mode=device`` and a
            ``tpu.keyed_buffer_mb`` of ``Q3_KEYED_BUFFER_MB`` (the fold kept,
            one probe per batch; the stream passes the buffer, so its
            pending batches drain into the per-batch prep, no single
            dispatch, and the buffer flushes into chunks merged on the
            host), and the h2o groupby questions q6 (median, stddev), q9
            (corr²) and q10 (sum, count by six keys, about one group a row,
            pinned keyed) over db-benchmark's G1_1e7_1e2 table
            (``benchmarks/h2o``'s ``gen_groupby``, seed 42), each a single
            dispatch (``fused_keyed_dispatches`` 1: one
            ``keyed_encode_entries`` launch over both batches, no
            ``key_encode``; q6's and q9's keys folded into one sort word and
            unfolded by ``keyed_unfold``, q10's six keys not), each against
            the CPU operators with its route asserted from the metrics;
            each again under ``set_precision("x32")`` against the same CPU
            answer at rel 1e-6 (legs ``x32 q3 keyed``, ``x32 h2o q6`` ...):
            int32 key codes, the x32 finish and chunk merge, q6's stddev
            through B12f beside the int32 median, q9's x32 corr (its r²
            to ``X32_CORR_ATOL`` absolute: the reference's f32 centring
            keeps r near 0 only to about 1e-8);
8. window — the per-supplier running revenue / moving average query over
            lineitem's first ``WINDOW_BATCHES`` batches: TorchWindowExec
            against the CPU WindowExec; the star join (phase 6) and the
            window each again under ``set_precision("x32")`` against the
            same CPU answer at rel 1e-6 (int32 probe and build keys and
            an f32 build column; (hi, lo) int32 order keys, f32 arguments,
            double-float sums, ``window_epilogue``'s int32 pack);
9. distributed — TPC-H q3 and q1 over the parquet files through
            ``BallistaContext.standalone(device="cuda", num_executors=1,
            concurrent_tasks=4)`` (the port's scheduler, executor, shuffle
            and Flight; 8 shuffle partitions, mesh off, the default
            ``ballista.batch.size``), held against the
            same cluster with ``ballista.tpu.enable=false``: equal results,
            no fallback, q3's map stage hashing its shuffle ids with
            ``partition_ids`` (equal to the host hash on every batch, the
            writers' ``device_pid_batches`` above 0), its join stage folded
            (``join_build_table`` and ``join_probe`` launched, no
            ``join_fallback``) and its aggregate on the sort route;
10. fusion — db-benchmark's h2o groupby q4 (mean v1:v3 by id4) over
            G1_1e7_1e2 written as parquet files, through the standalone
            cluster with ``ballista.tpu.whole_stage_fusion=true`` and
            2^16-row batches (20 a map task, under the 32-entry cap),
            against the same cluster with ``tpu.enable=false``: equal
            results, no fallback, ``fused_dispatches`` and
            ``fused_pid_in_kernel`` above 0, and every output batch's
            partition ids equal to the host partitioner's;
10b. mesh — distributed q1 and q3 again through a cluster of the same
            shape with the mesh on (the reference's default: no
            ``ballista.mesh.enable`` key): q1's partial aggregate is one
            ``MeshGangExec`` task (``mesh_devices`` the card count,
            ``mesh_rows_in`` every lineitem row, ``mesh_reduce`` launched),
            q3's repartition stages are ``MeshRepartitionExec`` tasks
            (``mesh_exchange_rows`` above 0, ``mesh_route`` launched; a
            writer's fallback past the row ceiling is printed); each equal
            to the CPU operators' answer of the mesh-off legs; then q3
            once more under ``set_precision("x32")`` (leg ``x32 dist. q3
            mesh``): its exchanges move 64-bit columns as (lo, hi) int32
            words (the ``i64pair`` layout), against the same answer at
            rel 1e-6; over all of lineitem both q3 legs' join stage bails
            (``join_fallback`` above 0) and their aggregate sorts each
            batch after it (more ``radix_sort`` launches than bails, on
            the one-CTA sort);
11. timing — every kernel at the first shape its main path gave it
            (``mesh_route`` at the largest, dist. q3's lineitem exchange;
            ``radix_sort`` at q3's, the window's, dist. q3's and dist. q3
            mesh's, each two runs bit for bit against the twin): the
            kernel, its twin and, where one PyTorch call computes the same
            function, that call (CUDA events, median of 20 launches),
            beside the least time the card could take (the bytes the call
            must move at 3.35 TB/s, or its f64 operations at 34 TFLOP/s);
            then the x32 forms at the x32 legs' first shapes: B12f in the
            variance leg's program (kernel, twin and closures bit for bit)
            and over ``sqpair_edge_grid`` (±0, NaN, ±inf, past 1.8e19,
            past the Veltkamp split, f32 extremes, subnormals) beside
            random pairs (bit for bit, NaN as NaN); the int32 forms of
            ``key_encode``, ``keyed_encode_entries``, ``keyed_unfold``,
            ``keyed_gids``, ``keyed_median``, ``join_probe`` and
            ``join_build_table``; the x32
            ``keyed_finish`` and ``keyed_corr`` (pairs within rel 1e-6);
            the window's x32 sort, scans, K3 and int32 pack; the i64pair
            exchange's ``mesh_route``: each entry's ``x32`` shapes.

Launch counts are set to 0 just before each main-path run (q1/q6 three ways
each, the x32 legs, q3, keyed q3, h2o q6/q9/q10, star join, window,
distributed q3 and q1, the fusion leg, the mesh legs, each x32 leg) and
read just after; a kernel of that path that never launched fails the run.  ``expr_eval`` launches on every leg whose stage
computes a filter or an argument (one a batch or entry); h2o q9 and q10,
whose programs pass bare columns through, and the window leg launch it
no time.  ``segment_agg_entries`` is timed at the cold q1
run's shape beside its twin and one ``segment_agg`` launch per entry.  Then
the whole run's seconds, one ``{"kernels": [...]}`` line and, last,
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
JOIN_ROWS = (1 << 20, 1 << 23)
JOIN_COLUMNS = (0, 1, 3)
JOIN_FORMS = ("dense 2^20", "dense 2^26", "sorted")
MESH_SHARDS = 4  # the kernel phase's mesh: 4 shards on the one card
MESH_REDUCE_CAPACITIES = (64, 1 << 20)  # q1's state, and a wide one
MESH_ROUTE_ROWS = 1 << 23  # rows per shard
MESH_ROUTE_DESTS = 4
STAR_ROWS, STAR_DIM = 60_000_000, 1_000_000  # bench_suite.py:bench_starjoin
WINDOW_BATCHES = 2  # the window leg reads lineitem's first 2 batches (2^24 rows)
H2O_ROWS, H2O_K = 10_000_000, 100  # db-benchmark's G1_1e7_1e2_0_0
H2O_BATCH_ROWS = 1 << 23  # the h2o legs' batches (two: 2^23 rows and the rest)
H2O_LEGS = (  # (question, session settings)
    ("q6", {}),
    ("q9", {}),
    ("q10", {"ballista.tpu.highcard_mode": "device",
             "ballista.tpu.max_capacity": str(1 << 24)}),
)
H2O_FOLDED = ("q6", "q9")  # their two keys fold into one sort word; q10's six do not
# the finish's shapes beside the main path's: 2^23 rows in 10,000 uniform
# ids, in 4 (each group spans ~1,800 tiles of 1,024 rows), in Zipf 1.1 ids
FINISH_ROWS = 1 << 23
FINISH_SHAPES = ("uniform", "skew", "zipf")
FINISH_KERNELS = ("kf_pack", "kf_tiles", "kf_cross", "kf_fill", "ss_reduce", "ss_carry",
                  "ss_apply", "keyed_unfold")
Q3_KEYED_BUFFER_MB = 400  # flushes q3's keyed buffer into chunks at SF10
PARQUET_FILES = 8  # per table (one file for the small ones)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F64_OPS_PER_S = 34e12  # H100 SXM f64 outside the tensor cores
REL = 1e-9
CUDA_DIR = "arrow_ballista_tpu_torch/ops/cuda/"
# name -> (source, the JAX function it replaces)
KERNELS = {
    "expr_eval": ("expr_eval.cu", "arrow_ballista_tpu/ops/kernels.py:122"),
    "segment_agg": ("segment_agg.cu", "arrow_ballista_tpu/ops/kernels.py:1158"),
    "segment_agg_entries": ("segment_agg_entries.cu",
                            "arrow_ballista_tpu/ops/stage_compiler.py:2573"),
    "radix_sort": ("radix_sort.cu", "arrow_ballista_tpu/ops/window_kernel.py:165"),
    "seg_scan": ("seg_scan.cu", "arrow_ballista_tpu/ops/kernels.py:1051"),
    "range_extremum": ("range_extremum.cu", "arrow_ballista_tpu/ops/window_kernel.py:128"),
    "window_epilogue": ("window_epilogue.cu", "arrow_ballista_tpu/ops/window_kernel.py:165"),
    "partition_ids": ("partition_id.cu", "arrow_ballista_tpu/ops/kernels.py:2438"),
    "join_build_table": ("join_probe.cu", "arrow_ballista_tpu/ops/stage_compiler.py:2436"),
    "join_probe": ("join_probe.cu", "arrow_ballista_tpu/ops/kernels.py:636"),
    "key_encode": ("keyed_gids.cu", "arrow_ballista_tpu/ops/kernels.py:1769"),
    "keyed_gids": ("keyed_gids.cu", "arrow_ballista_tpu/ops/kernels.py:1821"),
    "keyed_finish": ("keyed_finish.cu", "arrow_ballista_tpu/ops/kernels.py:1886"),
    "keyed_median": ("keyed_median.cu", "arrow_ballista_tpu/ops/kernels.py:1582"),
    "keyed_corr": ("keyed_corr.cu", "arrow_ballista_tpu/ops/kernels.py:1949"),
    "keyed_encode_entries": ("keyed_fold.cu",
                             "arrow_ballista_tpu/ops/stage_compiler.py:2252"),
    "keyed_unfold": ("keyed_fold.cu", "arrow_ballista_tpu/ops/stage_compiler.py:2252"),
    "mesh_reduce": ("mesh_reduce.cu", "arrow_ballista_tpu/parallel/mesh.py:33"),
    "mesh_route": ("mesh_route.cu", "arrow_ballista_tpu/parallel/mesh.py:113"),
    "df32_agg": ("df32_agg.cu", "arrow_ballista_tpu/ops/kernels.py:900"),
    "ord_extremum": ("ord_extremum.cu", "arrow_ballista_tpu/ops/kernels.py:2186"),
    "x32_merge": ("x32_merge.cu", "arrow_ballista_tpu/ops/kernels.py:2349"),
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


ENTRY_COUNTS = (1, 8, 32)
ENTRY_CAPACITIES = (1, 64, 4096, 1 << 16)
ENTRY_ROWS = {1: 1 << 22, 8: 1 << 22, 32: 1 << 19}  # rows per entry (the last shorter)


def _entries_bytes(rows, state) -> int:
    """Bytes one multi-entry call must move: every entry's gid, masks and
    columns read once, the state read and written once."""
    total = 2 * state.numel() * 8
    for gid, tail, pred, pvalid, values, valids in rows:
        n = gid.numel()
        total += 4 * n + sum(0 if m is None else n for m in (tail, pred, pvalid, *valids))
        total += sum(0 if v is None else 8 * n for v in values)
    return total


def _b1_loop(TK, rows, ops, cols, state):
    for r in rows:
        TK.segment_agg_cuda(*r, ops, cols, state)
    return state


def entries_check(TK, rows, ops, cols, state0, reps: int = 20, split: bool = False) -> dict:
    """The multi-entry kernel on ``rows`` against one B1 launch per entry
    (bit-identical, two runs bit-identical too) and against its twin (f64
    sums within REL, all else exact); its ms per call beside the twin's,
    the B1 loop's, the bound and ``index_add_`` of the sums over all the
    entries' rows (``_entries_library``: no single PyTorch call folds
    several batches into one state, this one adds one batch's sums); with
    ``split``, where the time goes (``seg_agg_split``)."""
    import torch

    runs = [TK.segment_agg_entries_cuda(rows, ops, cols, state0.clone()) for _ in range(2)]
    loop = _b1_loop(TK, rows, ops, cols, state0.clone())
    twin = TK.segment_agg_entries_reference(rows, ops, cols, state0.clone())
    torch.cuda.synchronize()
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError("segment_agg_entries: two runs differ")
    if not torch.equal(runs[0], loop):
        raise AssertionError("segment_agg_entries: differs from one B1 launch per entry")
    err = compare_states(TK, runs[0], twin, ops)
    k_state = runs[0]
    ms = _median_ms(lambda: TK.segment_agg_entries_cuda(rows, ops, cols, k_state), reps)
    loop_ms = _median_ms(lambda: _b1_loop(TK, rows, ops, cols, loop), reps)
    plain = _median_ms(lambda: TK.segment_agg_entries_reference(rows, ops, cols, twin),
                       min(reps, 5))
    n = sum(r[0].numel() for r in rows)
    out = dict(entries=len(rows), rows=n, capacity=state0.shape[1], fields=len(ops),
               max_abs_err=err, ms=ms, b1_loop_ms=loop_ms, plain_ms=plain,
               library_ms=_entries_library(TK, rows, ops, cols, state0.shape[1], min(reps, 5)))
    if split:
        out.update(seg_agg_split(lambda: TK.segment_agg_entries_cuda(rows, ops, cols, k_state)))
    out.update(_bound(_entries_bytes(rows, state0), f64_ops=n * len(ops)))
    return out


def _masked_sums(TK, args: dict, ops, cols):
    """The f64 sum fields' columns with the field masks applied (0.0 where
    a row is masked out): the operand of the index_add_ yardstick."""
    import torch

    n = args["gid"].numel()
    mask = torch.ones(n, dtype=torch.bool, device=args["gid"].device)
    for m in (args["tail"], args["pred"], args["pvalid"]):
        if m is not None:
            mask &= m
    sums = []
    for op, c in zip(ops, cols):
        if op == TK.OP_ADD_F64:
            m = mask if args["valids"][c] is None else mask & args["valids"][c]
            sums.append(torch.where(m, args["values"][c], 0.0))
    return torch.stack(sums, dim=1) if sums else None


def _entries_library(TK, rows, ops, cols, cap: int, reps: int):
    """ms of one index_add_ of the f64 sums over every entry's rows laid
    end to end (the concatenation made before the timed region), or None
    without a sum field."""
    import torch

    parts = [_masked_sums(TK, dict(gid=r[0], tail=r[1], pred=r[2], pvalid=r[3],
                                   values=list(r[4]), valids=list(r[5])), ops, cols)
             for r in rows]
    if parts[0] is None:
        return None
    V = torch.cat(parts)
    g = torch.cat([r[0] for r in rows]).long()
    del parts
    acc = torch.zeros(cap, V.shape[1], dtype=torch.float64, device=V.device)
    return _median_ms(lambda: acc.index_add_(0, g, V), reps)


def entries_phase(TK, device) -> tuple[float, dict]:
    """segment_agg_entries over E entries x capacity: bit-identical to E B1
    launches, equal to its twin; returns the largest sum error and each
    case's times."""
    specs, ops, cols = _fields(TK)
    worst, times = 0.0, {}
    for e in ENTRY_COUNTS:
        for cap in ENTRY_CAPACITIES:
            n = ENTRY_ROWS[e]
            sizes = [n] * (e - 1) + [n - n // 3 - 17]  # ragged: the last entry shorter
            rows = []
            for j, size in enumerate(sizes):
                d = _inputs(size, cap, seed=1000 * e + cap + j, device=device)
                rows.append((d["gid"], d["tail"], d["pred"], d["pvalid"],
                             d["values"], d["valids"]))
            t = entries_check(TK, rows, ops, cols, TK.init_states(specs, cap, device),
                              reps=5)
            worst = max(worst, t["max_abs_err"])
            times[f"entries={e},capacity={cap}"] = t
            print(f"segment_agg_entries entries={e} capacity={cap}: ok {json.dumps(t)}")
            del rows
    return worst, times


# q1's stage as the main path gives B1 its batches: sum and count of four
# columns, of three again for the averages, count(*) and the presence count
# (16 fields, 6 distinct folds); its 4 groups' shares of the rows at SF10
Q1_COLS = (0, 0, 1, 1, 2, 2, 3, 3, 0, 0, 1, 1, 4, 4, -1, -1)
Q1_GROUP_SHARES = (0.2466, 0.0066, 0.4937, 0.2531)  # A/F, N/F, N/O, R/F
Q1_BATCH_ROWS = 1 << 23  # the local legs' batches
Q1_ENTRY_ROWS = 59_990_658  # the cold q1 leg's 8 entries at SF10 (7 full batches, the rest)
DIST_BATCH_ROWS = 8192  # the distributed legs' parquet batches


def q1_ops(TK) -> list:
    return [TK.OP_ADD_F64, TK.OP_COUNT] * 7 + [TK.OP_COUNT] * 2


def q1_stand_in(n: int, seed: int, device) -> dict:
    """B1's arguments for ``n`` rows of q1 without the query: its 4 groups
    (``Q1_GROUP_SHARES``) at capacity 64, a filter that keeps 98.6% of the
    rows, five f64 columns without nulls (made on ``device`` from
    ``seed``)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    edges = torch.tensor(np.cumsum(Q1_GROUP_SHARES)[:-1], device=device)
    values = [torch.rand(n, generator=gen, device=device, dtype=torch.float64) * scale
              for scale in (50.0, 1e5, 1e5, 1e5, 0.1)]
    return dict(gid=torch.bucketize(u, edges).to(torch.int32), tail=None,
                pred=torch.rand(n, generator=gen, device=device) < 0.986, pvalid=None,
                values=values, valids=[None] * 5)


def b1_split_phase(TK, device) -> dict:
    """B1 at q1's stand-in (``q1_stand_in``, 2^23 rows) and at distributed
    q1's batch (8,192 rows), and B13a at the cold q1 leg's (8 entries,
    ``Q1_ENTRY_ROWS`` rows): each against its twin (B13a also bit for bit
    against its B1 loop), its ms beside the bound, ``index_add_`` of the
    sums and where the time goes (``seg_agg_split``)."""
    import torch

    ops, cols = q1_ops(TK), list(Q1_COLS)

    def zeros():
        return torch.zeros(len(ops), 64, dtype=torch.int64, device=device)

    out = {}
    for name, n in (("q1 stand-in", Q1_BATCH_ROWS), ("dist. q1 stand-in", DIST_BATCH_ROWS)):
        a = q1_stand_in(n, n, device)
        call = (a["gid"], a["tail"], a["pred"], a["pvalid"], a["values"], a["valids"], ops,
                cols, zeros())
        out[name] = time_shape(TK, (call, {}))
    sizes = [Q1_BATCH_ROWS] * 7 + [Q1_ENTRY_ROWS - 7 * Q1_BATCH_ROWS]
    rows = []
    for j, n in enumerate(sizes):
        a = q1_stand_in(n, 100 + j, device)
        rows.append((a["gid"], a["tail"], a["pred"], a["pvalid"], a["values"], a["valids"]))
    out["q1 cold stand-in"] = entries_check(TK, rows, ops, cols, zeros(), split=True)
    del rows
    for name, t in out.items():
        print(f"segment_agg {name}: ok {json.dumps(t)}")
    return out


# ------------------------------------------------------------ mesh (B13b)
def _q1_specs(TK) -> list:
    """q1's state layout: four sums, three avgs, count(*) (16 fields)."""
    return ([TK.KernelAggSpec("sum", True)] * 4 + [TK.KernelAggSpec("avg", True)] * 3
            + [TK.KernelAggSpec("count_star", False)])


def _mixed_specs(TK) -> list:
    return [TK.KernelAggSpec("min", True), TK.KernelAggSpec("max", True),
            TK.KernelAggSpec("sum", True, int_sum=True),
            TK.KernelAggSpec("min", True, int_minmax=True), TK.KernelAggSpec("sum", True)]


def _shard_states(TK, specs, cap: int, n_shards: int, seed: int, device) -> list:
    """Seeded shard states in the port's layout: f64 fields normal (NaN and
    -0.0 sprinkled in), int fields counts or int64 past 2^53."""
    import torch

    rng = np.random.default_rng(seed)
    flags = TK._field_flags(specs)
    states = []
    for _ in range(n_shards):
        rows = []
        for role, is_int in flags:
            if is_int:
                rows.append(rng.integers(0, 1 << 60, cap) if role != "add"
                            else rng.integers(0, 1 << 20, cap))
            else:
                v = rng.normal(size=cap) * 1e6
                v[::97] = np.nan
                v[5::89] = -0.0
                rows.append(v.view(np.int64))
        states.append(torch.from_numpy(np.stack(rows)).to(device))
    return states


def _time_reduce(TM, specs, states) -> dict:
    import torch

    want = TM.mesh_reduce_reference(specs, states)
    runs = [TM.mesh_reduce_cuda(specs, states) for _ in range(2)]
    torch.cuda.synchronize()
    if not (torch.equal(runs[0], runs[1]) and torch.equal(runs[0], want)):
        raise AssertionError("mesh_reduce differs from its twin")
    stacked = torch.stack(states)
    nf, cap = states[0].shape
    return dict(
        shards=len(states), fields=nf, capacity=cap,
        ms=_median_ms(lambda: TM.mesh_reduce_cuda(specs, states)),
        plain_ms=_median_ms(lambda: TM.mesh_reduce_reference(specs, states), reps=5),
        # nearest single call: a sum over the stacked states (no min/max roles)
        library_ms=_median_ms(lambda: torch.sum(stacked, 0)),
        max_abs_err=0.0,
        **_bound(_nbytes(*states) + _nbytes(want)),
    )


def _route_bytes(dest, valid, cols, n_dev: int, cap: int) -> int:
    row = sum(c.element_size() for c in cols)
    return _nbytes(dest, valid, *cols) + n_dev * cap * (row + 1)


def _route_library(dest, valid, cols, n_dev: int, cap: int):
    """torch.argsort(stable=True) of the destinations plus one index_put_
    per column: the sort and scatter half of the route as library calls."""
    import torch

    dm = torch.where(valid, dest, n_dev)
    order = torch.argsort(dm, stable=True)
    ds = dm[order]
    idx = torch.arange(ds.shape[0], device=ds.device) % cap  # no ranks: a yardstick
    ok = ds < n_dev
    at = (ds[ok], idx[ok])
    for c in cols:
        torch.zeros((n_dev, cap), dtype=c.dtype, device=c.device).index_put_(at, c[order][ok])


def _checked_route(TM, dest, valid, cols, n_dev: int, cap: int) -> int:
    """The kernel's staging bit-identical to the twin's; its n_dropped."""
    import torch

    got = TM.mesh_route_cuda(dest, valid, cols, n_dev, cap)
    want = TM.mesh_route_reference(dest, valid, cols, n_dev, cap)
    torch.cuda.synchronize()
    same = torch.equal(got[1], want[1]) and int(got[2]) == int(want[2]) and all(
        g.dtype == w.dtype and torch.equal(g.view(torch.uint8), w.view(torch.uint8))
        for g, w in zip(got[0], want[0]))
    if not same:
        raise AssertionError(f"mesh_route differs from its twin (n_dev={n_dev}, capacity={cap})")
    return int(got[2])


def _time_route(TM, dest, valid, cols, n_dev: int, cap: int) -> dict:
    n_dropped = _checked_route(TM, dest, valid, cols, n_dev, cap)
    return dict(
        rows=int(dest.shape[0]), destinations=n_dev, capacity=cap, columns=len(cols),
        ms=_median_ms(lambda: TM.mesh_route_cuda(dest, valid, cols, n_dev, cap)),
        plain_ms=_median_ms(lambda: TM.mesh_route_reference(dest, valid, cols, n_dev, cap),
                            reps=5),
        library_ms=_median_ms(lambda: _route_library(dest, valid, cols, n_dev, cap)),
        max_abs_err=0.0, n_dropped=n_dropped,
        **_bound(_route_bytes(dest, valid, cols, n_dev, cap)),
    )


def _q3_route_inputs(n: int, n_dev: int, seed: int, device):
    """One shard of distributed q3's lineitem exchange: l_orderkey (int64),
    l_extendedprice and l_discount (f64), each with its validity, and the
    int32 __part column, as BatchExchanger.to_columns lays them out."""
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    part = rng.integers(0, 8, n).astype(np.int32)
    cols = [t(rng.integers(1, 60_000_000, n)), t(np.ones(n, bool)),
            t(rng.uniform(900.0, 105_000.0, n)), t(np.ones(n, bool)),
            t(np.round(rng.uniform(0.0, 0.1, n), 2)), t(np.ones(n, bool)), t(part)]
    return t(part % n_dev), t(np.ones(n, bool)), cols


def mesh_phase(TK, device) -> dict:
    """Both mesh kernels on TorchMesh([cuda:0] * 4): the reduce over q1's
    state and a wide mixed one, the route over 4 shards of q3's lineitem
    columns, each shard once with its exact capacity and once one below it
    (n_dropped the surplus, the doubled retry delivering every row); all
    bit-identical to the twins."""
    import torch

    from arrow_ballista_tpu_torch.parallel import mesh as TM

    mesh = TM.TorchMesh([device] * MESH_SHARDS)
    out: dict = {}
    for cap in MESH_REDUCE_CAPACITIES:
        for name, specs in (("q1", _q1_specs(TK)), ("mixed", _mixed_specs(TK))):
            states = _shard_states(TK, specs, cap, mesh.size, seed=cap, device=device)
            t = _time_reduce(TM, specs, states)
            out[f"reduce {name} capacity={cap}"] = t
            print(f"mesh_reduce {name} shards={mesh.size} capacity={cap}: ok {json.dumps(t)}")
            del states
    shards = [_q3_route_inputs(MESH_ROUTE_ROWS, MESH_ROUTE_DESTS, seed=s, device=device)
              for s in range(mesh.size)]
    counts = [torch.bincount(dest, minlength=MESH_ROUTE_DESTS) for dest, _v, _c in shards]
    need = int(max(int(c.max()) for c in counts))
    exact = 1 << max(need - 1, 0).bit_length()  # MeshRepartitionExec's capacity
    for s, (dest, valid, cols) in enumerate(shards):
        if s == 0:
            t = out["route exact"] = _time_route(TM, dest, valid, cols, MESH_ROUTE_DESTS, exact)
            print(f"mesh_route shard 0 rows={MESH_ROUTE_ROWS} capacity={exact}: ok {json.dumps(t)}")
            n_dropped = t["n_dropped"]
        else:
            n_dropped = _checked_route(TM, dest, valid, cols, MESH_ROUTE_DESTS, exact)
        if n_dropped:
            raise AssertionError(f"mesh_route shard {s}: {n_dropped} dropped at the exact capacity")
    # one below the exact need: the surplus is counted, the retry delivers
    tight = need - 1
    dropped = sum(_checked_route(TM, dest, valid, cols, MESH_ROUTE_DESTS, tight)
                  for dest, valid, cols in shards)
    surplus = sum(int(torch.clamp(c - tight, min=0).sum()) for c in counts)
    if dropped != surplus or surplus < 1:
        raise AssertionError(f"mesh_route: n_dropped {dropped} vs surplus {surplus}")
    exchange = TM.ici_batch_exchange(mesh, len(shards[0][2]), 2 * tight)
    recv_cols, recv_valid, n_dropped = exchange([[d, v, *c] for d, v, c in shards])
    delivered = sum(int(r.sum()) for r in recv_valid)
    if n_dropped or delivered != mesh.size * MESH_ROUTE_ROWS:
        raise AssertionError(f"mesh_route retry: dropped {n_dropped}, delivered {delivered}")
    print(f"mesh_route capacity={tight}: n_dropped={dropped} = surplus; retry at "
          f"{2 * tight} delivered {delivered} rows over {mesh.size} shards")
    out["route tight"] = dict(capacity=tight, n_dropped=dropped, retry_delivered=delivered)
    return out


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


# q1 warm's device work: its expression launches, the multi-entry launch
# and the fetch
WARM_SPLIT = ("expr_eval_cuda", "segment_agg_entries", "fetch_states")


class EventSplit:
    """CUDA events recorded before and after every call of ``module.name``
    for each of ``names`` inside the ``with`` block: :meth:`split` gives
    each name's calls and ms (from its first event to its last, the card's
    clock, so a call's host time shows where the card waited for it)."""

    def __init__(self, module, names):
        self.module, self.names = module, tuple(names)
        self.events: list = []
        self.inner: dict = {}

    def __enter__(self):
        import torch

        for name in self.names:
            inner = self.inner[name] = getattr(self.module, name)

            def hook(*args, _name=name, _inner=inner, **kwargs):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = _inner(*args, **kwargs)
                b.record()
                self.events.append((_name, a, b))
                return out

            setattr(self.module, name, hook)
        return self

    def __exit__(self, *exc):
        for name, inner in self.inner.items():
            setattr(self.module, name, inner)

    def split(self) -> dict:
        import torch

        torch.cuda.synchronize()
        ms: dict = {name: [] for name in self.names}
        for name, a, b in self.events:
            ms[name].append(a.elapsed_time(b))
        return {name: dict(calls=len(v), sum_ms=sum(v), ms=v) for name, v in ms.items()}


class HostSplit:
    """The host's clock (``time.perf_counter``) around every call of each
    ``owner.name`` of ``parts`` (``(label, owner, name)``: a module, a
    class or the extension) inside the ``with`` block, and the time in
    Python's garbage collector: :meth:`split` gives each label's calls
    and ms."""

    def __init__(self, parts):
        self.parts = list(parts)
        self.ms: dict = {label: [] for label, _, _ in self.parts}
        self.gc_ms: list = []
        self.saved: list = []
        self._gc_t0 = 0.0

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.gc_ms.append((time.perf_counter() - self._gc_t0) * 1e3)

    def __enter__(self):
        import gc

        for label, owner, name in self.parts:
            inner = getattr(owner, name)

            def hook(*args, _inner=inner, _ms=self.ms[label], **kwargs):
                t0 = time.perf_counter()
                try:
                    return _inner(*args, **kwargs)
                finally:
                    _ms.append((time.perf_counter() - t0) * 1e3)

            self.saved.append((owner, name, inner))
            setattr(owner, name, hook)
        if self.parts:
            gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        import gc

        for owner, name, inner in reversed(self.saved):
            setattr(owner, name, inner)
        if self._gc in gc.callbacks:
            gc.callbacks.remove(self._gc)

    def split(self) -> dict:
        out = {label: dict(calls=len(v), sum_ms=sum(v)) for label, v in self.ms.items()}
        out["gc"] = dict(collections=len(self.gc_ms), sum_ms=sum(self.gc_ms))
        return out


def expr_host_parts(TK) -> list:
    """``expr_eval_cuda``'s host work by step, for :class:`HostSplit`: the
    whole call, then the argument checks, the batch's skip and validity
    words, the output tensors' allocation, the staged inputs (and their
    alignment), the program's device tables and the binding (which plans
    and launches)."""
    from arrow_ballista_tpu_torch.ops.cuda import build

    return [("expr_eval_cuda", TK, "expr_eval_cuda"), ("checks", TK, "_check_expr_args"),
            ("batch words", TK, "_expr_batch_words"), ("outputs", TK, "_expr_outputs"),
            ("staging", TK, "_expr_staged"), ("device tables", TK.ExprProgram, "device_tables"),
            ("binding", build.load(), "expr_eval")]


class CaptureLargest(Capture):
    """A Capture that keeps the call over the most rows (its first
    argument's length) instead of the first call."""

    def __enter__(self):
        inner = self.inner = getattr(self.module, self.name)

        def hook(*args, **kwargs):
            if self.args is None or len(args[0]) > len(self.args[0][0]):
                self.args = (self.keep(args) if self.keep else args, kwargs)
            return inner(*args, **kwargs)

        setattr(self.module, self.name, hook)
        return self


class SortPaths:
    """K1's calls by path from ``_reset_counts`` to ``_launches`` (a leg):
    the one-CTA sort (``RADIX_SMALL_ROWS`` rows or fewer) or the tiled
    passes, and the fewest rows of a call.  A wrapper on
    ``radix_argsort_cuda`` for that span; not a launch count."""

    def __init__(self):
        self.inner, self.counts = None, {}

    def start(self, TK) -> None:
        self.counts = {"radix_sort one-CTA": 0, "radix_sort tiled": 0,
                       "radix_sort fewest rows": None}
        if self.inner is not None:
            return
        inner = self.inner = TK.radix_argsort_cuda

        def hook(keys):
            n, c = keys[0].numel(), self.counts
            c["radix_sort one-CTA" if n <= TK.RADIX_SMALL_ROWS else "radix_sort tiled"] += 1
            fewest = c["radix_sort fewest rows"]
            c["radix_sort fewest rows"] = n if fewest is None else min(fewest, n)
            return inner(keys)

        TK.radix_argsort_cuda = hook

    def stop(self, TK) -> dict:
        if self.inner is not None:
            TK.radix_argsort_cuda, self.inner = self.inner, None
        return self.counts


SORT_PATHS = SortPaths()


def _reset_counts(TK) -> None:
    for k in TK.LAUNCHES:
        TK.LAUNCHES[k] = 0
    SORT_PATHS.start(TK)


def _launches(TK) -> dict:
    """The launch counts since ``_reset_counts``, with K1's calls by path."""
    return dict(TK.LAUNCHES, **SORT_PATHS.stop(TK))


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


def _scratch_bytes(fn) -> int:
    """Peak device bytes one call of ``fn`` allocates (its outputs too)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _time_sort(TK, keys) -> dict:
    """K1 at ``keys``: one call's events (``ms``, the host's time where it
    exceeds the card's) and ``burst_ms`` (20 calls back to back: the
    card's), beside torch.sort(stable=True) on one key."""
    import torch

    sort = lambda: TK.radix_argsort_cuda(keys)  # noqa: E731
    one = len(keys) == 1
    lib = lambda: torch.sort(keys[0], stable=True)  # noqa: E731
    out = dict(rows=keys[0].numel(), keys=len(keys), ms=_median_ms(sort),
               burst_ms=_burst_ms(sort), passes=TK.radix_sort_pass_count(keys),
               path="one-CTA" if keys[0].numel() <= TK.RADIX_SMALL_ROWS else "tiled",
               plain_ms=_median_ms(lambda: TK.radix_argsort_reference(keys), 5),
               library_ms=_median_ms(lib) if one else None,
               library_burst_ms=_burst_ms(lib) if one else None,
               scratch_bytes=_scratch_bytes(sort), max_abs_err=0.0)
    out.update(_bound(_sort_bytes(keys)))
    return out


def _sort_bound_rows(TK) -> tuple:
    """One key's rows around the one-CTA sort's bound: its last size
    beside the tiled passes' first, and smaller and larger sorts."""
    return (2048, 8192, TK.RADIX_SMALL_ROWS, TK.RADIX_SMALL_ROWS + 1, 32768)


def _checked_same(TK, keys, what: str) -> None:
    import torch

    twin = TK.radix_argsort_reference(keys)
    runs = [TK.radix_argsort_cuda(keys) for _ in range(2)]
    torch.cuda.synchronize()
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError(f"radix_sort {what}: two runs differ")
    if not torch.equal(runs[0], twin):
        raise AssertionError(f"radix_sort {what}: perm differs from the twin")


def sort_phase(TK, device) -> dict:
    """radix_sort vs its twin: B6's one key and the window key set; then
    one key around the one-CTA sort's bound."""
    import torch

    times: dict = {}
    for n in SORT_ROWS:
        cases = [(f"one key capacity={cap}", lambda cap=cap: [_gid_key(n, cap, n + cap)])
                 for cap in SORT_CAPACITIES]
        cases.append(("window keys", lambda: _window_keys(n, n)))
        for name, make in cases:
            keys = [torch.from_numpy(k).to(device) for k in make()]
            _checked_same(TK, keys, f"n={n} {name}")
            t = _time_sort(TK, keys)
            times[f"n={n},{name}"] = t
            print(f"radix_sort n={n} {name}: ok, passes={t['passes']} ms={t['ms']!r} "
                  f"burst_ms={t['burst_ms']!r} library_ms={t['library_ms']!r} "
                  f"library_burst_ms={t['library_burst_ms']!r} bound_ms={t['bound_ms']!r}")
            del keys
    for n in _sort_bound_rows(TK):
        keys = [torch.from_numpy(_gid_key(n, 16384, n)).to(device)]
        _checked_same(TK, keys, f"n={n} bound")
        t = dict(path="one-CTA" if n <= TK.RADIX_SMALL_ROWS else "tiled",
                 burst_ms=_burst_ms(lambda: TK.radix_argsort_cuda(keys)),
                 library_burst_ms=_burst_ms(lambda: torch.sort(keys[0], stable=True)))
        times[f"n={n},small-sort bound"] = t
        print(f"radix_sort n={n} small-sort bound (burst ms): {json.dumps(t)}")
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
        elif c.op == TK.OP_DF32:  # x32: hi + lo within X32_REL
            gf = sum(x.double() for x in TK._df32_split(g)).cpu().numpy()
            wf = sum(x.double() for x in TK._df32_split(w)).cpu().numpy()
            diff = np.abs(gf - wf)
            if diff.size:
                worst = max(worst, float(diff.max()))
            if np.any(diff > X32_REL * np.abs(wf)):
                raise AssertionError(f"{what} column {k}: df32 sum off by {diff.max()}")
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
    rows, perm, sf, sl, pf, pl = args[:6]
    n = perm.numel()
    read = _nbytes(perm, sf, sl, pf, pl)
    read += sum(_nbytes(r.x, r.values, r.valid) for r in rows)
    out = dict(rows=n, packed_rows=len(rows), out_dtype=str(got.dtype),
               ms=_median_ms(lambda: WK.window_pack_cuda(*args)),
               plain_ms=_median_ms(lambda: WK.window_pack_reference(*args), 5),
               library_ms=None, max_abs_err=0.0)
    out.update(_bound(read + got.element_size() * n * len(rows)))
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


# ------------------------------------------------------- device join (B5)
def _join_build_keys(form: str, seed: int) -> np.ndarray:
    """Unique sorted build keys: the star join's dimension keys (span 2^20
    slots), q3-like order keys (about 1.45M of 60M, 2^26 slots), or keys
    over a span past the dense cap (the sorted probe)."""
    if form == "dense 2^20":
        return np.arange(1, STAR_DIM + 1, dtype=np.int64)
    rng = np.random.default_rng(seed)
    lo, span, m = (1, 60_000_000, 1_450_000) if form == "dense 2^26" else (
        -(1 << 40), 1 << 41, 1_000_000)
    ends = np.array([lo, lo + span - 1], dtype=np.int64)
    return np.unique(np.concatenate([ends, rng.integers(lo, lo + span, m)]))


def _join_probe_keys(bkeys: np.ndarray, n: int, seed: int):
    """Probe keys: 70% hits, then misses inside the key range, keys below
    kmin, negative keys far below it and keys above kmax; 5% null."""
    rng = np.random.default_rng(seed)
    kmin, kmax = int(bkeys[0]), int(bkeys[-1])
    pkey = rng.choice(bkeys, n)
    pick = rng.random(n)
    for lo, make in ((0.7, lambda k: rng.integers(kmin, kmax + 1, k)),
                     (0.8, lambda k: kmin - rng.integers(1, 1000, k)),
                     (0.85, lambda k: -rng.integers(1, 1 << 50, k)),
                     (0.9, lambda k: kmax + rng.integers(1, 1 << 20, k))):
        sel = pick >= lo
        pkey[sel] = make(int(sel.sum()))
    return pkey, rng.random(n) >= 0.05


def _join_build_cols(m: int, seed: int, device):
    """Build columns f64 (NaN, -0.0), int64 and int32, the last two with
    nulls, as the stage ships them (every integer widened to int64);
    (values, validities)."""
    import torch

    rng = np.random.default_rng(seed)
    f = rng.uniform(-1e6, 1e6, m)
    f[rng.random(m) < 0.01] = np.nan
    f[:8:2] = -0.0
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    vals = [t(f), t(rng.integers(-(2**62), 2**62, m)),
            t(rng.integers(-(2**31), 2**31, m).astype(np.int32).astype(np.int64))]
    return vals, [None, t(rng.random(m) >= 0.1), t(rng.random(m) >= 0.05)]


def _same_probe(a, b) -> bool:
    import torch

    words = {torch.float64: torch.int64, torch.float32: torch.int32}
    for x, y in zip(a[0] + a[1] + [a[2]], b[0] + b[1] + [b[2]]):
        if x.dtype in words:
            x, y = x.view(words[x.dtype]), y.view(words[y.dtype])
        if not torch.equal(x, y):
            return False
    return True


def _probe_bytes(args, form: dict) -> int:
    """The least bytes one probe moves: the keys and masks read once, each
    output written once, and of the table, the sorted keys and the build
    columns at most one entry per probe row."""
    pkey, pkey_valid, valid, bvals, bvalids = args
    n = pkey.numel()
    total = pkey.element_size() * n + _nbytes(pkey_valid, valid) + n
    keys = form.get("table", form.get("bkeys"))
    total += min(n, keys.numel()) * keys.element_size()
    for v, bv in zip(bvals, bvalids):
        rows = min(n, v.numel())
        total += rows * v.element_size() + (0 if bv is None else rows)
        total += n * v.element_size() + n
    return total


def _time_probe(TK, args, form: dict) -> dict:
    """The probe kernel, its twin and the nearest PyTorch yardstick (the
    sorted form's ``torch.searchsorted``, or the table lookup, then one
    index per build column)."""
    import torch

    pkey, pkey_valid, valid, bvals, bvalids = args
    if "bkeys" in form:
        bk = form["bkeys"]

        def library():
            idx = torch.searchsorted(bk, pkey).clamp_(0, bk.numel() - 1)
            return [v[idx] for v in bvals], bk[idx] == pkey
    else:
        tbl, kmin = form["table"], form["kmin"]

        def library():
            slot = tbl[(pkey - kmin).clamp_(0, tbl.numel() - 1)]
            idx = (slot.long() - 1).clamp_(min=0)
            return [v[idx] for v in bvals], slot > 0

    out = dict(rows=pkey.numel(), columns=len(bvals),
               form="sorted" if "bkeys" in form else f"dense {form['table'].numel()} slots",
               key_dtype=str(pkey.dtype), column_dtypes=[str(v.dtype) for v in bvals],
               ms=_median_ms(lambda: TK.join_probe_cuda(*args, **form)),
               plain_ms=_median_ms(lambda: TK.join_probe_twin(*args, **form), 5),
               library_ms=_median_ms(library), max_abs_err=0.0)
    out.update(_bound(_probe_bytes(args, form)))
    return out


def _time_build(TK, bkeys, kmin: int, span: int) -> dict:
    """The slot-table kernel, its twin and one ``index_put_`` into a zeroed
    table (slots and row numbers precomputed)."""
    import torch

    m = bkeys.numel()
    slots = bkeys.long() - kmin
    rows = torch.arange(1, m + 1, dtype=torch.int32, device=bkeys.device)
    out = dict(keys=m, slots=span, key_dtype=str(bkeys.dtype),
               ms=_median_ms(lambda: TK.join_build_table_cuda(bkeys, kmin, span)),
               plain_ms=_median_ms(lambda: TK.join_build_table_twin(bkeys, kmin, span), 5),
               library_ms=_median_ms(lambda: torch.zeros(
                   span, dtype=torch.int32, device=bkeys.device).index_put_((slots,), rows)),
               max_abs_err=0.0)
    out.update(_bound(bkeys.element_size() * m + 4 * span))
    return out


def _checked_build(TK, bkeys, kmin: int, span: int) -> dict:
    import torch

    runs = [TK.join_build_table_cuda(bkeys, kmin, span) for _ in range(2)]
    twin = TK.join_build_table_twin(bkeys, kmin, span)
    torch.cuda.synchronize()
    if not (torch.equal(runs[0], runs[1]) and torch.equal(runs[0], twin)):
        raise AssertionError(f"join_build_table m={bkeys.numel()} span={span}: differs")
    return _time_build(TK, bkeys, kmin, span)


def _checked_probe(TK, captured) -> dict:
    """A probe the main path made, held against the twin and timed."""
    args, kw = captured
    a = dict(zip(("pkey", "pkey_valid", "valid", "bvals", "bvalids", "table", "kmin",
                  "bkeys"), args), **kw)
    args = (a["pkey"], a["pkey_valid"], a["valid"], list(a["bvals"]), list(a["bvalids"]))
    form = (dict(bkeys=a["bkeys"]) if a.get("table") is None
            else dict(table=a["table"], kmin=a["kmin"]))
    if not _same_probe(TK.join_probe_cuda(*args, **form), TK.join_probe_twin(*args, **form)):
        raise AssertionError("join_probe differs from the twin at a main-path shape")
    return _time_probe(TK, args, form)


def join_phase(TK, device) -> tuple[dict, dict]:
    """join_build_table and join_probe vs their twins in every form."""
    import torch

    probes, builds = {}, {}
    for fi, form_name in enumerate(JOIN_FORMS):
        bk = _join_build_keys(form_name, seed=fi)
        bkeys = torch.from_numpy(bk).to(device)
        bvals, bvalids = _join_build_cols(len(bk), seed=fi + 10, device=device)
        if form_name == "sorted":
            if int(bk[-1]) - int(bk[0]) + 1 <= 1 << 26:
                raise AssertionError("the sorted case's span fits the dense cap")
            form = dict(bkeys=bkeys)
        else:
            kmin = int(bk[0])
            span = max(16, 1 << (int(bk[-1]) - kmin).bit_length())
            builds[form_name] = t = _checked_build(TK, bkeys, kmin, span)
            print(f"join_build_table {form_name} keys={len(bk)}: ok (= twin), "
                  f"ms={t['ms']!r} bound_ms={t['bound_ms']!r} library_ms={t['library_ms']!r}")
            form = dict(table=TK.join_build_table_cuda(bkeys, kmin, span), kmin=kmin)
        for n in JOIN_ROWS:
            pk, pv = _join_probe_keys(bk, n, seed=n + fi)
            pkey, pkey_valid = torch.from_numpy(pk).to(device), torch.from_numpy(pv).to(device)
            for n_cols in JOIN_COLUMNS:
                args = (pkey, pkey_valid, None, bvals[:n_cols], bvalids[:n_cols])
                runs = [TK.join_probe_cuda(*args, **form) for _ in range(2)]
                twin = TK.join_probe_twin(*args, **form)
                torch.cuda.synchronize()
                if not (_same_probe(runs[0], runs[1]) and _same_probe(runs[0], twin)):
                    raise AssertionError(
                        f"join_probe {form_name} n={n} columns={n_cols}: differs")
                matched = int(runs[0][2].sum())
                del runs, twin
                t = _time_probe(TK, args, form)
                probes[f"{form_name},n={n},columns={n_cols}"] = t
                print(f"join_probe {form_name} n={n} columns={n_cols}: ok (= twin, "
                      f"{matched} matched), ms={t['ms']!r} bound_ms={t['bound_ms']!r} "
                      f"plain_ms={t['plain_ms']!r} library_ms={t['library_ms']!r}")
            del pkey, pkey_valid
        del bkeys, bvals, bvalids, form
    return probes, builds


# ------------------------------------------------------------- query phase
def _tables_equal(a, b, what: str, rel: float = REL) -> None:
    """Row by row: floats within ``rel`` (0: bit-exact), all else exact."""
    if a.schema.names != b.schema.names or a.num_rows != b.num_rows:
        raise AssertionError(f"{what}: shape {a.shape} vs {b.shape}")
    for name in a.schema.names:
        for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
            if isinstance(x, float) and y is not None:
                if not abs(x - y) <= rel * abs(x):
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


# the three runs of each cache leg: (name, session settings)
CACHE_RUNS = (
    ("cache_off", {"ballista.tpu.cache_columns": "false"}),
    ("cold", {}),
    ("warm", {}),
)


def _keep_entries(args):
    """A multi-entry call's arguments, its state (changed in place) copied."""
    return args[:-1] + (args[-1].clone(),)


def query_phase(tbt, TK, batches, device, wants: dict) -> dict:
    """q1 and q6 three ways each against the CPU operators: the column cache
    off (one B1 launch per batch), cold with it on (the batches retained,
    then one multi-entry launch) and warm (a cache hit: no scan, no host
    encode, no bridge).  Warm is bit-identical to cold, and cold to the
    cache-off run (the same fold order at the same capacity).  The CPU
    operators' answers go into ``wants`` (the x32 legs reuse them)."""
    import torch

    from arrow_ballista_tpu_torch.exec.operators import ScanExec
    from arrow_ballista_tpu_torch.ops import device_cache
    from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec
    from benchmarks.tpch.queries import QUERIES

    n_rows = sum(b.num_rows for b in batches)

    def session(enable: bool, extra: dict):
        cfg = dict(SETTINGS, **extra, **{"ballista.tpu.enable": str(enable).lower()})
        ctx = tbt.SessionContext(tbt.BallistaConfig(cfg), device=device)
        ctx.register_record_batches("lineitem", [batches])
        return ctx

    out = {}
    for q in (1, 6):
        cpu_ctx = session(False, {})
        plan = cpu_ctx.sql(QUERIES[q]).physical_plan()
        t0 = time.perf_counter()
        want = cpu_ctx.execute(plan)
        cpu_s = time.perf_counter() - t0
        del cpu_ctx, plan
        print(f"q{q}: cpu_rows_per_s={n_rows / cpu_s!r} cpu_s={cpu_s!r}")

        results, runs = {}, {}
        ctx = None
        for name, extra in CACHE_RUNS:
            if name != "warm":  # warm reuses the cold run's session and table
                ctx = session(True, extra)
            plan = ctx.sql(QUERIES[q]).physical_plan()
            stages = _stage_nodes(plan, TorchStageExec)
            scans = _stage_nodes(plan, ScanExec)
            if not stages:
                raise AssertionError(f"q{q} {name}: no TorchStageExec in the plan")
            _reset_counts(TK)
            torch.cuda.reset_peak_memory_stats()
            warm1 = (q, name) == (1, "warm")
            split = EventSplit(TK, WARM_SPLIT if warm1 else ())
            host = HostSplit(expr_host_parts(TK) if warm1 else ())
            mallocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
            with Capture(TK, "segment_agg", keep=_keep_state) as b1, \
                    Capture(TK, "segment_agg_entries", keep=_keep_entries) as multi, \
                    Capture(TK, "expr_eval_cuda", keep=_keep_expr_call) as expr, host, split:
                t0 = time.perf_counter()
                got = ctx.execute(plan)
                torch.cuda.synchronize()
                dev_s = time.perf_counter() - t0
            launches = _launches(TK)
            if warm1:  # device_allocs: the caching allocator's cudaMalloc calls in the run
                print(f"q1 warm split: card={card_line()} tpu_execute_ns="
                      f"{_stage_metrics(stages).get('tpu_execute_ns', 0)} "
                      f"{json.dumps(split.split())} host={json.dumps(host.split())} device_allocs="
                      f"{torch.cuda.memory_stats().get('num_device_alloc', 0) - mallocs}")
            peak = torch.cuda.max_memory_allocated()
            metrics = _stage_metrics(stages)
            for k in ("tpu_fallback", "cpu_fallback", "highcard_fallback"):
                if metrics.get(k, 0):
                    raise AssertionError(f"q{q} {name}: {k}={metrics[k]}")
            _tables_equal(want, got, f"q{q} {name}")
            _check_expr_launches(launches, f"q{q} {name}")
            if name == "cache_off":
                if launches["segment_agg"] < 1 or launches["segment_agg_entries"]:
                    raise AssertionError(f"q{q} cache off: launches {json.dumps(launches)}")
                if launches["expr_eval"] != launches["segment_agg"]:
                    raise AssertionError(f"q{q} cache off: one expr_eval a batch: "
                                         f"{json.dumps(launches)}")
            else:
                if launches["segment_agg_entries"] != 1 or launches["segment_agg"]:
                    raise AssertionError(f"q{q} {name}: launches {json.dumps(launches)}")
                hits = metrics.get("cache_hits", 0)
                if (name == "cold") != (hits == 0) or metrics.get("fused_dispatches", 0) != 1:
                    raise AssertionError(f"q{q} {name}: {json.dumps(metrics)}")
            if name == "warm":
                scanned = sum(s.metrics.to_dict().get("output_rows", 0) for s in scans)
                for k in ("key_encode_time_ns", "bridge_time_ns"):
                    if metrics.get(k, 0):
                        raise AssertionError(f"q{q} warm: {k}={metrics[k]}")
                if scanned:
                    raise AssertionError(f"q{q} warm: the scan read {scanned} rows")
                if not got.equals(results["cold"]):
                    raise AssertionError(f"q{q}: warm differs from cold")
            if name == "cold" and not got.equals(results["cache_off"]):
                raise AssertionError(f"q{q}: cold differs from the cache-off run")
            results[name] = got
            breakdown = {k: metrics.get(k, 0) for k in BREAKDOWN + ("cache_hits", "fused_dispatches")}
            print(
                f"q{q} {name}: rows={n_rows} launches={json.dumps(launches)} "
                f"cuda_rows_per_s={n_rows / dev_s!r} cuda_s={dev_s!r} cpu_s={cpu_s!r} "
                f"peak_device_bytes={peak} breakdown={json.dumps(breakdown)} "
                f"device_cache={json.dumps(device_cache.stats())}"
            )
            runs[name] = dict(launches=launches, args=b1.args, entries=multi.args,
                              expr=expr.args)
            del plan, stages, scans
        wants[q] = want
        del ctx, results, want
        out[q] = runs
    return out


def q3_expected_route(batches, max_capacity: int) -> dict:
    """The route the reference's rule gives local q3's join-fused stage on
    these batches, computed on the host.  The stage keys its group table
    on the distinct probe keys (``l_orderkey`` of the rows that pass
    ``l_shipdate > 1995-03-15``, batch by batch, before the join filters):
    it bails to the unfolded shape on the first batch when that batch
    alone outruns ``max_capacity`` or, groups ~ rows, fills half of it,
    and on a later batch when the running count outruns the table."""
    import datetime

    import pyarrow as pa
    import pyarrow.compute as pc

    from arrow_ballista_tpu_torch.ops.stage_compiler import _highcard_detect

    cut = pa.scalar(datetime.date(1995, 3, 15))
    seen = np.empty(0, dtype=np.int64)
    probed, first = 0, None
    for b in batches:
        keys = b.column("l_orderkey").filter(pc.greater(b.column("l_shipdate"), cut))
        if len(keys) == 0:
            continue  # the stage skips empty batches
        distinct = np.unique(keys.to_numpy())
        if first is None:
            first = len(distinct)
            if first > max_capacity or (
                _highcard_detect(first, len(keys)) and first > max_capacity // 2
            ):
                return dict(bail=True, probed=0, first_keys=first, keys=first)
        seen = np.union1d(seen, distinct)
        if len(seen) > max_capacity:
            return dict(bail=True, probed=probed, first_keys=first, keys=len(seen))
        probed += 1
    return dict(bail=False, probed=probed, first_keys=first, keys=len(seen))


def q3_phase(tbt, TK, batches, orders, customer, device) -> dict:
    """TPC-H q3: the join folds into the device stage and routes as the
    reference's rule says on this data (``q3_expected_route``), against the
    CPU operators; no CPU fallback, and the sort route must launch."""
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
    if [s.fused.join is not None for s in stages] != [True]:
        raise AssertionError(f"q3: the join did not fold ({[str(s) for s in stages]})")
    t0 = time.perf_counter()
    expect = q3_expected_route(batches, stages[0].max_capacity)
    print(f"q3: expected route {json.dumps(expect)} (host, s={time.perf_counter() - t0!r})")
    _reset_counts(TK)
    with Capture(TK, "radix_argsort_cuda") as sort, \
            Capture(TK, "sorted_segment_agg_cuda", keep=_keep_state) as route, \
            Capture(TK, "join_build_table_cuda") as build:
        t0 = time.perf_counter()
        got = ctx.execute(plan)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
    launches = _launches(TK)
    metrics = _stage_metrics(stages)
    bail = int(expect["bail"])
    for k, want_k in (("join_fallback", bail), ("tpu_fallback", bail), ("dense_join", 1),
                      ("cpu_fallback", 0), ("highcard_fallback", 0)):
        if metrics.get(k, 0) != want_k:
            raise AssertionError(f"q3: {k}={metrics.get(k, 0)}, the reference's rule "
                                 f"gives {want_k} ({json.dumps(metrics)})")
    if launches["join_probe"] != expect["probed"] or launches["join_build_table"] != 1:
        raise AssertionError(f"q3: launches {json.dumps(launches)} against {json.dumps(expect)}")
    if not bail and launches["join_probe"] < 1:
        raise AssertionError("q3: join_probe never launched")
    _check_expr_launches(launches, "q3")
    for k in ("radix_sort", "seg_scan"):
        if launches[k] < 1:
            raise AssertionError(f"q3: the sort route's {k} never launched")
    _tables_equal(want, got, "q3")
    breakdown = {k: metrics.get(k, 0) for k in BREAKDOWN + (
        "join_build_time_ns", "capacity_growths", "input_rows", "output_rows")}
    print(
        f"q3: lineitem_rows={n_rows} launches={json.dumps(launches)} "
        f"cuda_rows_per_s={n_rows / dev_s!r} cpu_rows_per_s={n_rows / cpu_s!r} "
        f"cuda_s={dev_s!r} cpu_s={cpu_s!r} join_fallback={metrics.get('join_fallback', 0)} "
        f"breakdown={json.dumps(breakdown)}"
    )
    return dict(launches=launches, sort=sort.args, route=route.args, build=build.args,
                want=want)


# ------------------------------------------------------------- keyed route
KEYED_CAPTURES = ("key_encode_cuda", "keyed_encode_entries_cuda", "keyed_sort",
                  "keyed_finish_cuda", "keyed_unfold_cuda", "keyed_median_cuda",
                  "keyed_corr_cuda")
# x32's keyed wrappers: the same encodes, sort, unfold and median (their
# int32 forms), the x32 finish and corr
KEYED_CAPTURES_X32 = ("key_encode_cuda", "keyed_encode_entries_cuda", "keyed_sort",
                      "keyed_finish_x32_cuda", "keyed_unfold_cuda", "keyed_median_cuda",
                      "keyed_corr_x32_cuda")
KEYED_KERNELS = ("radix_sort", "keyed_gids", "keyed_finish")


def keyed_kernels(fused: bool, folded: bool) -> tuple:
    """The kernels a keyed leg must launch: the single dispatch's
    entry-wise encode or (drained) the per-batch one, K1, the gid kernel,
    the finish and (folded) the unfold beside it."""
    return (("keyed_encode_entries" if fused else "key_encode",) + KEYED_KERNELS
            + (("keyed_unfold",) if folded else ()))


def _keyed_run(TK, ctx, plan, stages, what: str, captures=KEYED_CAPTURES,
               kernels=keyed_kernels(False, False)):
    """One main-path run of a keyed stage: counts zeroed just before, the
    keyed wrappers' first calls captured, the counts and metrics read
    just after; each of ``kernels`` must have launched."""
    import contextlib

    import torch

    _reset_counts(TK)
    with contextlib.ExitStack() as stack:
        caps = {name: stack.enter_context(Capture(TK, name)) for name in captures}
        t0 = time.perf_counter()
        got = ctx.execute(plan)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
    launches = _launches(TK)
    metrics = _stage_metrics(stages)
    for k in kernels:
        if launches[k] < 1:
            raise AssertionError(f"{what}: {k} never launched ({json.dumps(launches)})")
    # K2 runs on a keyed leg only in corr's two scans (one a corr launch)
    if launches["seg_scan"] != launches["keyed_corr"]:
        raise AssertionError(f"{what}: seg_scan launched outside corr ({json.dumps(launches)})")
    return got, dev_s, launches, metrics, {k: c.args for k, c in caps.items()}


def _sorted(t):
    """``t`` sorted by every non-float column."""
    import pyarrow as pa

    return t.sort_by([(c, "ascending") for c in t.column_names
                      if not pa.types.is_floating(t.schema.field(c).type)])


def _sorted_close(a, b, what: str, rel: float = REL, atol: dict = None) -> None:
    """_tables_close after sorting both by every non-float column."""
    _tables_close(_sorted(a), _sorted(b), what, rel, atol)


def q3_keyed_phase(tbt, TK, batches, orders, customer, want, device, x32=False) -> dict:
    """TPC-H q3 on the keyed route (``highcard_mode=device``): the identity
    group key encodes on the device, so the reference's rule routes the
    stage keyed at its first batch and keeps the fold; the probe runs once
    per batch inside the keyed prep, and ``Q3_KEYED_BUFFER_MB`` flushes the
    buffer into chunks that merge on the host.  Against the CPU leg of the
    q3 phase.  ``x32``: the same under ``set_precision("x32")`` (int32 key
    codes and probe keys, the x32 finish, x32 chunk merges), at rel 1e-6;
    the x32 buffer is about half as large, so its chunk count is printed,
    not held to 2."""
    if x32:
        TK.set_precision("x32")
        try:
            return q3_keyed_phase(tbt, TK, batches, orders, customer, want, device)
        finally:
            TK.set_precision(None)
    from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec
    from benchmarks.tpch.queries import QUERIES

    x32 = TK.precision_mode() == "x32"
    what = "x32 q3 keyed" if x32 else "q3 keyed"

    n_rows = sum(b.num_rows for b in batches)
    cfg = dict(SETTINGS, **{"ballista.tpu.highcard_mode": "device",
                            "ballista.tpu.keyed_buffer_mb": str(Q3_KEYED_BUFFER_MB)})
    ctx = tbt.SessionContext(tbt.BallistaConfig(cfg), device=device)
    ctx.register_record_batches("lineitem", [batches])
    ctx.register_arrow_table("orders", orders)
    ctx.register_arrow_table("customer", customer)
    plan = ctx.sql(QUERIES[3]).physical_plan()
    stages = _stage_nodes(plan, TorchStageExec)
    if [s.fused.join is not None for s in stages] != [True]:
        raise AssertionError(f"{what}: the join did not fold ({[str(s) for s in stages]})")
    expect = dict(keyed_path=1, dense_join=1, join_fallback=0, tpu_fallback=0,
                  cpu_fallback=0, highcard_fallback=0,
                  probed=sum(1 for b in batches if b.num_rows))
    got, dev_s, launches, metrics, caps = _keyed_run(
        TK, ctx, plan, stages, what, KEYED_CAPTURES_X32 if x32 else KEYED_CAPTURES,
        keyed_kernels(fused=False, folded=False))
    # the stream's host bytes pass the budget: the pending batches drain
    # into the per-batch prep, no single dispatch
    if (metrics.get("fused_keyed_dispatches", 0) != 0
            or launches["keyed_encode_entries"] != 0):
        raise AssertionError(f"{what}: the stream did not drain ({json.dumps(metrics)}, "
                             f"{json.dumps(launches)})")
    for k, want_k in expect.items():
        if k != "probed" and metrics.get(k, 0) != want_k:
            raise AssertionError(f"{what}: {k}={metrics.get(k, 0)}, the reference's rule "
                                 f"gives {want_k} ({json.dumps(metrics)})")
    if launches["join_probe"] != expect["probed"] or launches["join_build_table"] != 1:
        raise AssertionError(f"{what}: launches {json.dumps(launches)} against "
                             f"{json.dumps(expect)}")
    _check_expr_launches(launches, what)
    if not x32 and (metrics.get("keyed_chunks", 0) < 2
                    or metrics.get("keyed_merge_time_ns", 0) <= 0):
        raise AssertionError(f"{what}: the buffer never flushed ({json.dumps(metrics)})")
    _tables_equal(want, got, what, rel=X32_REL if x32 else REL)
    breakdown = {k: metrics.get(k, 0) for k in BREAKDOWN + (
        "join_build_time_ns", "keyed_chunks", "keyed_merge_time_ns",
        "device_encode_batches", "fused_keyed_dispatches", "input_rows", "output_rows")}
    print(
        f"{what}: lineitem_rows={n_rows} expected={json.dumps(expect)} "
        f"launches={json.dumps(launches)} cuda_rows_per_s={n_rows / dev_s!r} "
        f"cuda_s={dev_s!r} breakdown={json.dumps(breakdown)}"
    )
    return dict(launches=launches, caps=caps)


def h2o_batches() -> list:
    """db-benchmark's G1_1e7_1e2 table in 2^23-row batches."""
    from benchmarks.h2o.__main__ import gen_groupby

    t0 = time.perf_counter()
    x = gen_groupby(H2O_ROWS, H2O_K, seed=42)
    batches = x.combine_chunks().to_batches(max_chunksize=H2O_BATCH_ROWS)
    print(f"h2o: G1_1e7_1e2 rows={x.num_rows} batches={len(batches)} "
          f"s={time.perf_counter() - t0!r}")
    return batches


def h2o_phase(tbt, TK, batches, device) -> dict:
    """db-benchmark's groupby questions q6, q9 and q10 over G1_1e7_1e2 on
    the keyed route, each against the CPU operators: q6 and q9 take it for
    their median and corr at any cardinality, q10 because
    ``highcard_mode=device`` pins it.  Every leg must report
    ``keyed_path`` 1, no fallback and device-encoded batches; q6's int32
    keys encode on the device only (``key_encode_time_ns`` 0), q9's string
    key is host-coded.  Each question then runs again under
    ``set_precision("x32")`` against the same CPU answer at rel 1e-6
    (legs ``x32 q6`` ...): int32 key codes, the x32 finish, q6's stddev
    squaring its exact f32 pair in B3 (B12f) beside the int32 median, q9's
    x32 corr."""
    from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec
    from benchmarks.h2o.__main__ import QUESTIONS

    sqls = {q: sql for q, _name, sql in QUESTIONS}
    out = {}
    for q, extra in H2O_LEGS:
        def session(enable: bool):
            cfg = dict(SETTINGS, **extra, **{"ballista.tpu.enable": str(enable).lower()})
            ctx = tbt.SessionContext(tbt.BallistaConfig(cfg), device=device)
            ctx.register_record_batches("x", [batches])
            return ctx

        cpu_ctx = session(False)
        plan = cpu_ctx.sql(sqls[q]).physical_plan()
        t0 = time.perf_counter()
        want = cpu_ctx.execute(plan)
        cpu_s = time.perf_counter() - t0
        del cpu_ctx, plan
        want = _sorted(want)  # once for both modes (q10: 1e7 rows, six keys)
        for x32 in (False, True):
            if x32:
                TK.set_precision("x32")
            try:
                out[f"x32 {q}" if x32 else q] = _h2o_leg(
                    TK, TorchStageExec, session, sqls[q], q, want, cpu_s, x32)
            finally:
                TK.set_precision(None)
        del want
    return out


def _h2o_leg(TK, TorchStageExec, session, sql, q, want, cpu_s, x32) -> dict:
    what = f"x32 h2o {q}" if x32 else f"h2o {q}"
    ctx = session(True)
    plan = ctx.sql(sql).physical_plan()
    stages = _stage_nodes(plan, TorchStageExec)
    if len(stages) != 1:
        raise AssertionError(f"{what}: {len(stages)} device stages")
    # two batches within the budget: one single dispatch; q6's and q9's
    # two keys fold into one sort word, q10's six do not
    folded = q in H2O_FOLDED
    got, dev_s, launches, metrics, caps = _keyed_run(
        TK, ctx, plan, stages, what, KEYED_CAPTURES_X32 if x32 else KEYED_CAPTURES,
        keyed_kernels(fused=True, folded=folded))
    fold = caps["keyed_encode_entries_cuda"][0][2]
    if (metrics.get("fused_keyed_dispatches", 0) != 1
            or launches["keyed_encode_entries"] != 1 or launches["key_encode"] != 0
            or launches["keyed_unfold"] != int(folded) or (fold is not None) != folded):
        raise AssertionError(f"{what}: single dispatch, fold {folded} expected: fold={fold} "
                             f"{json.dumps(metrics)} {json.dumps(launches)}")
    for k, want_k in (("keyed_path", 1), ("tpu_fallback", 0), ("cpu_fallback", 0),
                      ("highcard_fallback", 0)):
        if metrics.get(k, 0) != want_k:
            raise AssertionError(f"{what}: {k}={metrics.get(k, 0)} ({json.dumps(metrics)})")
    if metrics.get("device_encode_batches", 0) < 1:
        raise AssertionError(f"{what}: no batch encoded its keys on the device")
    if q == "q6" and metrics.get("key_encode_time_ns", 0) != 0:
        raise AssertionError(f"{what}: host key encode {metrics['key_encode_time_ns']} ns")
    need = {"q6": "keyed_median", "q9": "keyed_corr"}.get(q)
    if need and launches[need] < 1:
        raise AssertionError(f"{what}: {need} never launched")
    # q6's stddev squares v3 (x32: its square pair); q9 (corr) and q10
    # (sums of bare columns) pass env tensors through
    _check_expr_launches(launches, what, computes=q == "q6")
    t0 = time.perf_counter()
    # x32's corr is the reference's arithmetic: f32 centring and f32
    # products, so r² of q9's weakly correlated groups (|r| down to 1e-5)
    # carries an absolute error near 1e-9 that no relative bar holds
    atol = X32_CORR_ATOL if x32 and q == "q9" else None
    _tables_close(want, _sorted(got), what, X32_REL if x32 else REL, atol)
    cmp_s = time.perf_counter() - t0
    if atol:
        key = [(c, "ascending") for c in ("id2", "id4")]
        w = want.sort_by(key).column("r2").to_numpy(zero_copy_only=False)
        g = got.sort_by(key).column("r2").to_numpy(zero_copy_only=False)
        ok = ~(np.isnan(w) | np.isnan(g))
        diff = np.abs(w[ok] - g[ok])
        print(f"{what}: r2 max_abs_err={float(diff.max(initial=0.0))!r} "
              f"groups_past_rel_1e-6={int((diff > X32_REL * np.abs(w[ok])).sum())} "
              f"of {int(ok.sum())}")
    breakdown = {k: metrics.get(k, 0) for k in BREAKDOWN + (
        "device_encode_batches", "fused_keyed_dispatches", "input_rows", "output_rows")}
    print(
        f"{what}: rows={H2O_ROWS} groups={got.num_rows} fold={json.dumps(fold)} "
        f"launches={json.dumps(launches)} "
        f"cuda_rows_per_s={H2O_ROWS / dev_s!r} cpu_rows_per_s={H2O_ROWS / cpu_s!r} "
        f"cuda_s={dev_s!r} cpu_s={cpu_s!r} compare_s={cmp_s!r} "
        f"breakdown={json.dumps(breakdown)}"
    )
    return dict(launches=launches, caps=caps)


def star_tables():
    """``bench_suite.py:bench_starjoin``'s tables: STAR_ROWS fact rows whose
    keys probe a STAR_DIM-row dimension on a unique int64 key (a fifth of
    them miss), 8 groups."""
    import pyarrow as pa

    rng = np.random.default_rng(9)
    m, n = STAR_DIM, STAR_ROWS
    dim = pa.table({
        "dk": pa.array(np.arange(1, m + 1), pa.int64()),
        "dv": pa.array(rng.uniform(0.5, 1.5, m)),
        "dtag": pa.array(rng.integers(0, 25, m), pa.int32()),
    })
    fact = pa.table({
        "fk": pa.array(rng.integers(1, int(m * 1.2), n), pa.int64()),
        "g": pa.array(rng.integers(0, 8, n), pa.int32()),
        "v": pa.array(rng.uniform(0, 100, n)),
    })
    return dim, fact


STAR_SQL = ("select g, sum(v * dv) as s, count(*) as c "
            "from dim, fact where dk = fk group by g order by g")


def star_phase(tbt, TK, device) -> dict:
    """The star join through ``SessionContext`` on the card (the dense
    device join, no fallback, ``join_probe`` once per batch) against the
    CPU operators; then again under ``set_precision("x32")`` against the
    same answer at rel 1e-6 (leg ``x32 star``: int32 probe and build keys,
    the build column as f32, x32's aggregate)."""
    from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec

    t0 = time.perf_counter()
    dim, fact = star_tables()
    batches = fact.combine_chunks().to_batches(max_chunksize=1 << 23)
    print(f"star: data s={time.perf_counter() - t0!r} batches={len(batches)}")
    n_rows = fact.num_rows
    del fact

    def session(enable: bool):
        cfg = dict(SETTINGS, **{"ballista.tpu.enable": str(enable).lower()})
        ctx = tbt.SessionContext(tbt.BallistaConfig(cfg), device=device)
        ctx.register_arrow_table("dim", dim)
        ctx.register_record_batches("fact", [batches])
        return ctx

    cpu_ctx = session(False)
    plan = cpu_ctx.sql(STAR_SQL).physical_plan()
    t0 = time.perf_counter()
    want = cpu_ctx.execute(plan)
    cpu_s = time.perf_counter() - t0
    del cpu_ctx, plan
    out = _star_leg(TK, TorchStageExec, session, want, cpu_s, len(batches), n_rows,
                    dim.num_rows, False)
    TK.set_precision("x32")
    try:
        out["x32"] = _star_leg(TK, TorchStageExec, session, want, cpu_s, len(batches),
                               n_rows, dim.num_rows, True)
    finally:
        TK.set_precision(None)
    return out


def _star_leg(TK, TorchStageExec, session, want, cpu_s, n_batches, n_rows, dim_rows,
              x32) -> dict:
    import torch

    what = "x32 star" if x32 else "star"
    ctx = session(True)
    plan = ctx.sql(STAR_SQL).physical_plan()
    stages = _stage_nodes(plan, TorchStageExec)
    if [s.fused.join is not None for s in stages] != [True]:
        raise AssertionError(f"{what}: the join did not fold ({[str(s) for s in stages]})")
    _reset_counts(TK)
    with Capture(TK, "join_probe_cuda") as probe, Capture(TK, "join_build_table_cuda") as build:
        t0 = time.perf_counter()
        got = ctx.execute(plan)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
    launches = _launches(TK)
    metrics = _stage_metrics(stages)
    for k, want_k in (("dense_join", 1), ("join_fallback", 0), ("tpu_fallback", 0),
                      ("cpu_fallback", 0), ("highcard_fallback", 0)):
        if metrics.get(k, 0) != want_k:
            raise AssertionError(f"{what}: {k}={metrics.get(k, 0)} ({json.dumps(metrics)})")
    if launches["join_probe"] != n_batches or launches["join_build_table"] != 1:
        raise AssertionError(f"{what}: launches {json.dumps(launches)}, {n_batches} batches")
    if x32:
        _check_x32_launches(launches, "matmul", what)
        if probe.args[0][0].dtype != torch.int32:
            raise AssertionError(f"{what}: the probe keys are {probe.args[0][0].dtype}")
    elif launches["segment_agg"] + launches["seg_scan"] < 1:
        raise AssertionError(f"{what}: the aggregate's kernel never launched")
    _check_expr_launches(launches, what)
    if launches["expr_eval"] != n_batches:
        raise AssertionError(f"{what}: expr_eval {launches['expr_eval']}, {n_batches} batches")
    _tables_equal(want, got, what, rel=X32_REL if x32 else REL)
    breakdown = {k: metrics.get(k, 0) for k in BREAKDOWN + (
        "join_build_time_ns", "input_rows", "output_rows")}
    print(
        f"{what}: fact_rows={n_rows} dim_rows={dim_rows} launches={json.dumps(launches)} "
        f"cuda_rows_per_s={n_rows / dev_s!r} cpu_rows_per_s={n_rows / cpu_s!r} "
        f"cuda_s={dev_s!r} cpu_s={cpu_s!r} breakdown={json.dumps(breakdown)}"
    )
    return dict(launches=launches, probe=probe.args, build=build.args)


WINDOW_SQL = """select l_orderkey, l_linenumber,
 row_number() over (partition by l_suppkey order by l_shipdate, l_orderkey, l_linenumber) rn,
 rank() over (partition by l_suppkey order by l_shipdate) rk,
 sum(l_extendedprice) over (partition by l_suppkey order by l_shipdate) rs,
 avg(l_quantity) over (partition by l_suppkey order by l_shipdate, l_orderkey, l_linenumber rows between 6 preceding and current row) ma,
 max(l_discount) over (partition by l_suppkey order by l_shipdate, l_orderkey, l_linenumber rows between 6 preceding and current row) mx,
 lag(l_extendedprice, 1) over (partition by l_suppkey order by l_shipdate, l_orderkey, l_linenumber) lg
from lineitem"""


def _tables_close(a, b, what: str, rel: float = REL, atol: dict = None) -> None:
    """Vectorised _tables_equal for large results, row by row in the
    order both legs produce (a window keeps its input order): floats
    within ``rel`` (or, for a column in ``atol``, within that absolute
    bound) with NaN matching NaN, all else exact."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if a.schema.names != b.schema.names or a.num_rows != b.num_rows:
        raise AssertionError(f"{what}: shape {a.shape} vs {b.shape}")
    for name in a.schema.names:
        x, y = a.column(name), b.column(name)
        if not (pa.types.is_integer(x.type) or pa.types.is_floating(x.type)
                or pa.types.is_boolean(x.type) or pa.types.is_temporal(x.type)):
            if not x.equals(y):  # strings: exact
                raise AssertionError(f"{what}.{name}: values differ")
            continue
        xv = np.asarray(pc.is_valid(x))
        if not np.array_equal(xv, np.asarray(pc.is_valid(y))):
            raise AssertionError(f"{what}.{name}: null positions differ")
        xn = x.fill_null(0).to_numpy()[xv]
        yn = y.fill_null(0).to_numpy()[xv]
        if xn.dtype.kind == "f":
            if not np.array_equal(np.isnan(xn), np.isnan(yn)):
                raise AssertionError(f"{what}.{name}: NaN positions differ")
            ok = ~np.isnan(xn)
            diff = np.abs(xn[ok] - yn[ok])
            bad = ~(diff <= rel * np.abs(xn[ok]))
            if atol and name in atol:
                bad &= diff > atol[name]
            if bad.any():
                i = int(np.argmax(bad))
                raise AssertionError(f"{what}.{name}: {xn[ok][i]!r} vs {yn[ok][i]!r}")
        elif not np.array_equal(xn, yn):
            raise AssertionError(f"{what}.{name}: values differ")


def window_phase(tbt, TK, WK, batches, device) -> dict:
    """The window query: TorchWindowExec against the CPU WindowExec; then
    again under ``set_precision("x32")`` against the same answer at rel
    1e-6 (leg ``x32``: (hi, lo) int32 order keys, f32 arguments,
    double-float sums, K4's int32 pack)."""
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
    del cpu_ctx, plan
    out = _window_leg(TK, WK, session, want, cpu_s, n_rows, False)
    TK.set_precision("x32")
    try:
        out["x32"] = _window_leg(TK, WK, session, want, cpu_s, n_rows, True)
    finally:
        TK.set_precision(None)
    return out


def _window_leg(TK, WK, session, want, cpu_s, n_rows, x32) -> dict:
    import torch

    from arrow_ballista_tpu_torch.ops.window_compiler import TorchWindowExec

    what = "x32 window" if x32 else "window"
    ctx = session(True)
    plan = ctx.sql(WINDOW_SQL).physical_plan()
    nodes = _stage_nodes(plan, TorchWindowExec)
    if not nodes:
        raise AssertionError(f"{what}: no TorchWindowExec in the plan")
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
    launches = _launches(TK)
    metrics = _stage_metrics(nodes)
    print(
        f"{what}: rows={n_rows} launches={json.dumps(launches)} "
        f"cuda_rows_per_s={n_rows / dev_s!r} cpu_rows_per_s={n_rows / cpu_s!r} "
        f"cuda_s={dev_s!r} cpu_s={cpu_s!r} "
        f"window_time_ns={metrics.get('window_time_ns', 0)}"
    )
    if metrics.get("tpu_window", 0) < 1 or metrics.get("tpu_fallback", 0):
        raise AssertionError(f"{what}: metrics {json.dumps(metrics)}")
    for k in ("radix_sort", "seg_scan", "range_extremum", "window_epilogue"):
        if launches[k] < 1:
            raise AssertionError(f"{what}: {k} never launched")
    if x32 and (pack.args[0][-1] != torch.int32 or sort.args[0][0][-1].dtype != torch.int32):
        raise AssertionError(f"{what}: the pack or the order keys are not x32's int32")
    _check_expr_launches(launches, what, computes=False)  # no aggregate prologue
    t0 = time.perf_counter()
    _tables_close(want, got, what, X32_REL if x32 else REL)
    print(f"{what}: equal to the CPU WindowExec, compared in s={time.perf_counter() - t0!r}")
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
            with Capture(TK, "partition_ids_cuda") as first, PidCheck(TK) as pids, \
                    Capture(TK, "join_probe_cuda") as probe, \
                    Capture(TK, "join_build_table_cuda") as build, \
                    Capture(TK, "radix_argsort_cuda") as sort, \
                    Capture(TK, "expr_eval_cuda", keep=_keep_expr_call) as expr, \
                    CaptureLargest(TK, "segment_agg", keep=_keep_state) as b1:
                got, dev_s, metrics = _run_job(ctx, QUERIES[q])
            launches = _launches(TK)
            stage = metrics.get("TorchStageExec", {})
            writer = metrics.get("ShuffleWriterExec", {})
            if stage.get("input_rows", 0) < 1:
                raise AssertionError(f"distributed q{q}: no device stage ran ({json.dumps(metrics)})")
            for k in ("tpu_fallback", "cpu_fallback", "highcard_fallback"):
                if stage.get(k, 0):
                    raise AssertionError(f"distributed q{q}: {k}={stage[k]}")
            _tables_equal(want, got, f"distributed q{q}")
            hashed = pids.check()
            need = ("partition_ids", "radix_sort", "seg_scan", "join_probe",
                    "join_build_table") if q == 3 else ("segment_agg",)
            for k in need:
                if launches[k] < 1:
                    raise AssertionError(f"distributed q{q}: {k} never launched")
            _check_expr_launches(launches, f"distributed q{q}")
            if q == 3 and (stage.get("join_fallback", 0) or stage.get("dense_join", 0) < 1):
                raise AssertionError(f"distributed q3: the join stage did not fold on the "
                                     f"dense route ({json.dumps(stage)})")
            if q == 3 and writer.get("device_pid_batches", 0) < 1:
                raise AssertionError("distributed q3: the writers hashed no batch on the card")
            breakdown = {k: stage.get(k, 0) for k in BREAKDOWN + (
                "join_build_time_ns", "dense_join", "join_fallback", "input_rows", "output_rows",
                "cache_hits", "fused_dispatches")}
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
            out[q] = dict(launches=launches, pids=first.args, probe=probe.args,
                          build=build.args, sort=sort.args, b1=b1.args, expr=expr.args,
                          want=want, cpu_s=cpu_s)
    finally:
        ctx.close()
    return out


# the reference's default cluster: no ballista.mesh.enable key, so the mesh
# is on; the same shape as DIST_SETTINGS otherwise
MESH_DIST_SETTINGS = {"ballista.shuffle.partitions": "8"}


def mesh_dist_phase(tbt, TK, root: str, lineitem_rows: int, dist: dict, device) -> dict:
    """Distributed q1 and q3 with the mesh on, through a standalone cluster
    of the same shape: q1's partial aggregate runs as one MeshGangExec task
    (each shard's stage kernels, then ``mesh_reduce``), q3's repartition
    stages as MeshRepartitionExec (``mesh_route`` and the block
    all-to-all); each held against the CPU operators' answer the mesh-off
    legs computed."""
    import torch

    from arrow_ballista_tpu_torch.parallel import mesh as TM
    from benchmarks.tpch.queries import QUERIES

    ctx = tbt.BallistaContext.standalone(
        tbt.BallistaConfig(dict(MESH_DIST_SETTINGS)), num_executors=1,
        concurrent_tasks=4, device=device,
    )
    out: dict = {}
    try:
        for name in DIST_TABLES:
            ctx.register_parquet(name, os.path.join(root, name))
        for q in (1, 3):
            _reset_counts(TK)
            with Capture(TM, "mesh_reduce_cuda") as red, \
                    CaptureLargest(TM, "mesh_route_cuda") as route, \
                    Capture(TK, "radix_argsort_cuda") as sort:
                got, dev_s, metrics = _run_job(ctx, QUERIES[q])
            launches = _launches(TK)
            _tables_equal(dist[q]["want"], got, f"dist. q{q} mesh")
            gang = metrics.get("MeshGangExec", {})
            rep = metrics.get("MeshRepartitionExec", {})
            writer = metrics.get("ShuffleWriterExec", {})
            stage = metrics.get("TorchStageExec", {})
            for k in ("cpu_fallback", "highcard_fallback"):
                if stage.get(k, 0):
                    raise AssertionError(f"dist. q{q} mesh: {k}={stage[k]}")
            # an exchanged partition reaches q3's join stage as one batch
            # of about 4M probe rows, whose keys fill over half the group
            # table: the reference's capacity rule bails to the unfolded
            # shape (join on the CPU, aggregate on the card), as local q3
            # does; any other device fallback fails the leg
            if stage.get("tpu_fallback", 0) != stage.get("join_fallback", 0):
                raise AssertionError(f"dist. q{q} mesh: a fallback other than the join "
                                     f"bail ({json.dumps(stage)})")
            if q == 1:
                if gang.get("mesh_fallback", 0):
                    raise AssertionError(f"dist. q1 gang: mesh_fallback ({json.dumps(gang)})")
                if gang.get("mesh_devices") != torch.cuda.device_count() or (
                        gang.get("mesh_rows_in") != lineitem_rows):
                    raise AssertionError(f"dist. q1 gang: {json.dumps(gang)}")
                need = ("mesh_reduce", "segment_agg", "expr_eval")
                body = gang
            else:
                if rep.get("mesh_exchange_rows", 0) < 1:
                    raise AssertionError(f"dist. q3 mesh: no exchange ran ({json.dumps(rep)})")
                if writer.get("mesh_exchange_fallback", 0):
                    # the row or capacity ceiling sent a stage back to the
                    # hash-split writer: print why, the leg still counts
                    print(f"dist. q3 mesh: mesh_exchange_fallback="
                          f"{writer['mesh_exchange_fallback']} (a stage passed "
                          f"mesh.exchange_max_rows or the capacity ceiling)")
                need = ("mesh_route", "join_build_table", "expr_eval", "radix_sort",
                        "seg_scan")
                body = rep
                _check_join_bail(stage, launches, f"dist. q{q} mesh")
            for k in need:
                if launches[k] < 1:
                    raise AssertionError(f"dist. q{q} mesh: {k} never launched "
                                         f"({json.dumps(launches)})")
            breakdown = {k: body.get(k, 0) for k in (
                "mesh_stage_time_ns", "key_encode_time_ns", "bridge_time_ns",
                "device_time_ns", "repart_time_ns", "mesh_rows_in", "mesh_exchange_rows",
                "mesh_devices", "mesh_fallback", "capacity_growths")}
            print(
                f"dist. q{q} mesh: lineitem_rows={lineitem_rows} "
                f"launches={json.dumps(launches)} cuda_s={dev_s!r} "
                f"cpu_s={dist[q]['cpu_s']!r} "
                f"cuda_rows_per_s={lineitem_rows / dev_s!r} "
                f"mesh={json.dumps(breakdown)} stage={json.dumps(stage)} "
                f"mesh_exchange_fallback={writer.get('mesh_exchange_fallback', 0)} "
                f"write_time_ns={writer.get('write_time_ns', 0)}"
            )
            out[q] = dict(launches=launches, reduce=red.args, route=route.args, sort=sort.args)
        out["x32 q3"] = _x32_dist_q3(TK, TM, ctx, lineitem_rows, dist)
    finally:
        ctx.close()
    return out


def _check_join_bail(stage: dict, launches: dict, what: str) -> None:
    """Over all of lineitem the mesh q3 legs' join stage bails and their
    aggregate runs on the sort route, a sort for each batch after the bail
    (so more sorts than bailed tasks): the only legs that drive K1 and K2
    after a MeshRepartitionExec."""
    bails = stage.get("join_fallback", 0)
    if bails < 1 or launches["radix_sort"] <= bails:
        raise AssertionError(f"{what}: the join stage did not bail to the sort route "
                             f"({json.dumps(stage)}, {json.dumps(launches)})")


def _x32_dist_q3(TK, TM, ctx, lineitem_rows: int, dist: dict) -> dict:
    """Distributed q3 with the mesh on under ``set_precision("x32")``: its
    ``MeshRepartitionExec`` stages move their int64, date and f64 columns
    as exact (lo, hi) int32 words (the ``i64pair`` layout), the join folds
    with int32 keys; against the mesh-off legs' CPU answer at rel 1e-6."""
    from benchmarks.tpch.queries import QUERIES

    layouts: list = []
    plain = TM.BatchExchanger

    class Recording(plain):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            layouts.append([kind for kind, _ in self.layout])

    TM.BatchExchanger = Recording
    TK.set_precision("x32")
    _reset_counts(TK)
    try:
        with CaptureLargest(TM, "mesh_route_cuda") as route:
            got, dev_s, metrics = _run_job(ctx, QUERIES[3])
    finally:
        TK.set_precision(None)
        TM.BatchExchanger = plain
    launches = _launches(TK)
    what = "x32 dist. q3 mesh"
    _tables_equal(dist[3]["want"], got, what, rel=X32_REL)
    rep = metrics.get("MeshRepartitionExec", {})
    writer = metrics.get("ShuffleWriterExec", {})
    stage = metrics.get("TorchStageExec", {})
    for k in ("cpu_fallback", "highcard_fallback"):
        if stage.get(k, 0):
            raise AssertionError(f"{what}: {k}={stage[k]}")
    if stage.get("tpu_fallback", 0) != stage.get("join_fallback", 0):
        raise AssertionError(f"{what}: a fallback other than the join bail "
                             f"({json.dumps(stage)})")
    if rep.get("mesh_exchange_rows", 0) < 1:
        raise AssertionError(f"{what}: no exchange ran ({json.dumps(rep)})")
    if not any("i64pair" in lay for lay in layouts):
        raise AssertionError(f"{what}: no exchange took the i64pair layout ({layouts})")
    for k in ("mesh_route", "join_build_table", "expr_eval", "radix_sort", "seg_scan"):
        if launches[k] < 1:
            raise AssertionError(f"{what}: {k} never launched ({json.dumps(launches)})")
    _check_join_bail(stage, launches, what)
    pairs = sum(lay.count("i64pair") for lay in layouts)
    print(
        f"{what}: lineitem_rows={lineitem_rows} launches={json.dumps(launches)} "
        f"cuda_s={dev_s!r} cpu_s={dist[3]['cpu_s']!r} "
        f"cuda_rows_per_s={lineitem_rows / dev_s!r} exchangers={len(layouts)} "
        f"i64pair_fields={pairs} mesh_exchange_rows={rep.get('mesh_exchange_rows', 0)} "
        f"mesh_exchange_fallback={writer.get('mesh_exchange_fallback', 0)} "
        f"stage={json.dumps(stage)}"
    )
    return dict(launches=launches, route=route.args)


FUSION_SETTINGS = {  # the fusion leg's cluster
    "ballista.shuffle.partitions": "8",
    "ballista.mesh.enable": "false",
    "ballista.tpu.whole_stage_fusion": "true",
    # each map task reads one parquet file of 1.25M rows: 20 batches of
    # 2^16 rows, under the fused runner's 32-entry cap, so no task streams
    "ballista.batch.size": str(1 << 16),
}


class FusedPidCheck:
    """Wraps ``TorchStageExec._materialize`` to keep every output batch that
    carries the shuffle pid column, with its stage's hint and whether the
    ids came from the fused run; ``check`` holds each against the host
    partitioner."""

    def __enter__(self):
        from arrow_ballista_tpu_torch.exec.operators import SHUFFLE_PID_COLUMN
        from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec

        self.cls, self.seen = TorchStageExec, []
        inner = self.inner = TorchStageExec._materialize
        seen = self.seen

        def hook(stage, *args, **kwargs):
            for b in inner(stage, *args, **kwargs):
                if SHUFFLE_PID_COLUMN in b.schema.names:
                    seen.append((b, stage._shuffle_hint,
                                 kwargs.get("fused_pids") is not None))
                yield b

        TorchStageExec._materialize = hook
        return self

    def __exit__(self, *exc):
        self.cls._materialize = self.inner

    def check(self) -> tuple[int, int]:
        """(rows checked, batches whose ids came from the fused run)."""
        import pyarrow as pa

        from arrow_ballista_tpu_torch.exec.operators import hash_partition_indices

        rows = fused = 0
        for b, (exprs, n), was_fused in self.seen:
            keys = pa.RecordBatch.from_arrays(
                b.columns[:-1], schema=pa.schema(list(b.schema)[:-1]))
            want = hash_partition_indices(keys, exprs, n)
            if not np.array_equal(np.asarray(b.column(b.num_columns - 1)), want):
                raise AssertionError("fused partition ids differ from the host hash")
            rows += b.num_rows
            fused += int(was_fused)
        return rows, fused


def fusion_phase(tbt, TK, h2o_batches, root: str, device) -> dict:
    """h2o groupby q4 (mean v1:v3 by id4) over G1_1e7_1e2 in PARQUET_FILES
    parquet files through the port's standalone cluster with
    ``whole_stage_fusion`` on, against the same cluster with
    ``tpu.enable=false``: equal results, no fallback, every map task one
    multi-entry launch with its partition ids in the same fetch, each id
    equal to the host partitioner's."""
    import pyarrow as pa

    from benchmarks.h2o.__main__ import QUESTIONS

    sql = {q: text for q, _name, text in QUESTIONS}["q4"]
    x = pa.Table.from_batches(h2o_batches)
    t0 = time.perf_counter()
    write_parquet({"x": x}, root)
    print(f"fusion: G1_1e7_1e2 rows={x.num_rows} as {PARQUET_FILES} parquet files "
          f"s={time.perf_counter() - t0!r}")
    n_rows = x.num_rows
    del x
    ctx = tbt.BallistaContext.standalone(
        tbt.BallistaConfig(dict(FUSION_SETTINGS)), num_executors=1,
        concurrent_tasks=4, device=device,
    )
    try:
        ctx.register_parquet("x", os.path.join(root, "x"))
        ctx.sql("SET ballista.tpu.enable = false")
        want, cpu_s, _ = _run_job(ctx, sql)
        ctx.sql("SET ballista.tpu.enable = true")
        _reset_counts(TK)
        with FusedPidCheck() as pids:
            got, dev_s, metrics = _run_job(ctx, sql)
        launches = _launches(TK)
        stage = metrics.get("TorchStageExec", {})
        if stage.get("input_rows", 0) != n_rows:
            raise AssertionError(f"fusion q4: the device stages read {stage.get('input_rows', 0)} "
                                 f"of {n_rows} rows ({json.dumps(metrics)})")
        for k in ("tpu_fallback", "cpu_fallback", "highcard_fallback", "fused_streamed"):
            if stage.get(k, 0):
                raise AssertionError(f"fusion q4: {k}={stage[k]}")
        for k in ("fused_dispatches", "fused_pid_in_kernel"):
            if stage.get(k, 0) < 1:
                raise AssertionError(f"fusion q4: {k}={stage.get(k, 0)} ({json.dumps(stage)})")
        for k in ("segment_agg_entries", "partition_ids"):
            if launches[k] < 1:
                raise AssertionError(f"fusion q4: {k} never launched")
        _check_expr_launches(launches, "fusion q4")  # v1, v2 widen from int32
        _sorted_close(want, got, "fusion q4")
        hashed, fused_batches = pids.check()
        if fused_batches < 1:
            raise AssertionError("fusion q4: no output batch took its ids from the fused run")
        breakdown = {k: stage.get(k, 0) for k in BREAKDOWN + (
            "fused_segments", "fused_ops_per_dispatch", "fused_dispatches",
            "fused_pid_in_kernel", "cache_hits", "input_rows", "output_rows")}
        print(
            f"fusion q4: rows={n_rows} groups={got.num_rows} launches={json.dumps(launches)} "
            f"cuda_rows_per_s={n_rows / dev_s!r} cpu_rows_per_s={n_rows / cpu_s!r} "
            f"cuda_s={dev_s!r} cpu_s={cpu_s!r} pid_rows_checked={hashed} "
            f"fused_pid_batches={fused_batches} breakdown={json.dumps(breakdown)}"
        )
    finally:
        ctx.close()
    return dict(launches=launches)


# --------------------------------------------------- expression program (B3)
EXPR_GRID_ROWS = 1 << 20  # the opcode grid's rows
EXPR_QUERY_ROWS = (1 << 20, 1 << 23)  # q1's and q6's own programs
EXPR_SEED = 17
I64_MIN, I64_MAX = -(2**63), 2**63 - 1


def expr_grid_batch(n: int, seed: int = EXPR_SEED, mode: str = "x64"):
    """A seeded batch for the expression grid: int64 ``i`` (past 2^53,
    INT64_MIN and INT64_MAX), int64 divisors ``j`` (0, ±1, INT64_MIN),
    float64 ``x`` and ``y`` (NaN, ±0.0, ±inf, subnormals, halves, the
    int64 range's edges), bool ``b``, date32 ``d`` and int32 ``k`` (never
    null); a tenth of every other column is null.  ``mode`` "x32" keeps
    ``i`` and ``j`` inside int32 (past 2^24, INT32_MIN and INT32_MAX), as
    x32's bridge takes them."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    inf, nan = float("inf"), float("nan")

    def pick(pool, rand):
        take = rng.random(n) < 0.4
        out = np.array(rand)
        out[take] = rng.choice(np.asarray(pool, out.dtype), int(take.sum()))
        return out

    def nulls():
        return rng.random(n) < 0.1

    ints = [0, 1, -1, 7, -7, 2**53 + 1, -(2**53) - 1, I64_MIN, I64_MAX, I64_MIN + 1]
    divisors = [0, 0, -1, -1, 1, 2, -2, 3, I64_MIN, I64_MAX]
    if mode == "x32":
        lo, hi = -(2**31), 2**31 - 1
        ints = [0, 1, -1, 7, -7, 2**24 + 1, -(2**24) - 1, lo, hi, lo + 1]
        divisors = [0, 0, -1, -1, 1, 2, -2, 3, lo, hi]
    floats = [0.0, -0.0, nan, inf, -inf, 5e-324, -2.2250738585072014e-308, 0.5, 1.5,
              2.5, -0.5, -2.5, 1e300, -1e300, 2.0**63, -(2.0**63), 9.3e18, -9.3e18,
              2.0**53 + 2, 1.0, -1.0]
    small = [0.0, -0.0, nan, inf, -1.0, 2.0, 0.5, -3.0, 1e-310, 3.0]
    days = [0, -5, 9000, 10471, 10472]
    return pa.RecordBatch.from_pydict({
        "i": pa.array(pick(ints, rng.integers(-10**6, 10**6, n)), pa.int64(), mask=nulls()),
        "j": pa.array(pick(divisors, rng.integers(-50, 50, n)), pa.int64(), mask=nulls()),
        "x": pa.array(pick(floats, rng.normal(0, 100, n)), pa.float64(), mask=nulls()),
        "y": pa.array(pick(small, rng.normal(0, 10, n)), pa.float64(), mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, pa.bool_(), mask=nulls()),
        "d": pa.array(pick(days, rng.integers(8000, 11000, n)).astype(np.int32),
                      pa.date32(), mask=nulls()),
        "k": pa.array(rng.integers(-5, 6, n).astype(np.int32), pa.int32()),
    })


def expr_grid_cases() -> dict:
    """name -> ``build(pe, col)``: an expression for every lowering branch
    and opcode over :func:`expr_grid_batch`'s columns (``col(name)`` is the
    column), built from either package's expression module."""
    import datetime

    import pyarrow as pa

    day, epoch = datetime.date(1998, 9, 2), datetime.date(1970, 1, 1)

    def term(pe, col, t):
        if isinstance(t, str):
            return col(t)
        return t(pe, col) if callable(t) else pe.Lit(t)

    def binary(op, l, r):
        return lambda pe, col: pe.Binary(term(pe, col, l), op, term(pe, col, r))

    def fn(name, *args):
        return lambda pe, col: pe.ScalarFn(name, tuple(term(pe, col, a) for a in args))

    def unary(kind, arg, *rest):
        return lambda pe, col: getattr(pe, kind)(term(pe, col, arg), *rest)

    def case(whens, other, out):
        return lambda pe, col: pe.Case(
            tuple((term(pe, col, w), term(pe, col, t)) for w, t in whens),
            None if other is None else term(pe, col, other), out)

    cases = {
        "lit_only": binary("+", 3, 4),
        "and": binary("AND", binary(">", "i", 0), binary("<", "x", 1.0)),
        "or": binary("OR", binary("=", "j", 0), binary(">=", "y", 2.0)),
        "and_bool_leaf": binary("AND", "b", binary("<", "i", "j")),
        "not": unary("Not", binary(">", "x", 0.0)),
        "not_bool_leaf": unary("Not", "b"),
        "eq_int": binary("=", "i", "j"),
        "ne_float": binary("<>", "x", "y"),
        "lt_int_float": binary("<", "i", "x"),
        "le_bool_int": binary("<=", "b", "k"),
        "gt_lit": binary(">", "x", 1.5),
        "ge_date": binary(">=", "d", day),
        "eq_bool": binary("=", "b", binary(">", "x", 0.0)),
        "add_int_overflow": binary("+", "i", "j"),
        "sub_int": binary("-", "i", "j"),
        "mul_int_overflow": binary("*", "i", "j"),
        "add_float": binary("+", "x", "y"),
        "sub_float": binary("-", "x", "y"),
        "mul_float": binary("*", "x", "y"),
        "add_int_float": binary("+", "i", "x"),
        "mul_int32": binary("*", "k", "i"),
        "add_bool_bool": binary("+", "b", binary("<", "x", "y")),
        "mul_bool_bool": binary("*", "b", binary(">", "i", 0)),
        "add_bool_int": binary("+", "b", "j"),
        "date_plus_int": binary("+", "d", 1),
        "div_int": binary("/", "i", "j"),
        "div_float": binary("/", "x", "y"),
        "div_int_float": binary("/", "i", "y"),
        "div_bool_int": binary("/", "b", "j"),
        "mod_int": binary("%", "i", "j"),
        "mod_float": binary("%", "x", "y"),
        "mod_int_float": binary("%", "j", "y"),
        "neg_int": unary("Negative", "i"),
        "neg_float": unary("Negative", "x"),
        "neg_int32": unary("Negative", "k"),
        "is_null": unary("IsNull", "x"),
        "is_not_null": unary("IsNull", "i", True),
        "is_null_never_null": unary("IsNull", "k"),
        "is_null_lit": unary("IsNull", 1),
        "in_int": unary("InList", "i", (2**53 + 1, 7, -7, I64_MIN, 0)),
        "in_float": unary("InList", "x", (0.5, -0.0, 2.5, 1e300)),
        "not_in_int_items_float_column": unary("InList", "x", (1, -1, 0), True),
        "in_date": unary("InList", "d", (day, epoch)),
        "not_in_bool": unary("InList", "b", (1,), True),
        "case_else": case([(binary(">", "i", 0), "x"), (binary("=", "j", 0), 1.0)],
                          "y", pa.float64()),
        "case_no_else": case([(binary(">", "j", 1), "i")], None, pa.int64()),
        "case_int_then_float_out": case([("b", "i")], "x", pa.float64()),
        "case_bool": case([(binary(">", "x", 0.0), "b")], binary("<", "i", 0), pa.bool_()),
        "case_int_condition": case([("j", 1.0)], 0.0, pa.float64()),
        "case_nested": case([(unary("IsNull", "i"),
                              case([(binary(">", "x", 0.0), 1)], 2, pa.int64()))],
                            "j", pa.int64()),
        "cast_float_int": unary("Cast", "x", pa.int64()),
        "cast_int_float": unary("Cast", "i", pa.float64()),
        "cast_int_bool": unary("Cast", "j", pa.bool_()),
        "cast_float_bool": unary("Cast", "x", pa.bool_()),
        "cast_bool_int": unary("Cast", "b", pa.int64()),
        "cast_date_float": unary("Cast", "d", pa.float64()),
        "power": fn("power", "x", "y"),
        "power_int_lit": fn("power", "i", 2),
        "round": fn("round", "x"),
        "abs_int": fn("abs", "i"),
        "signum_small": fn("signum", "y"),
        "q1_charge": binary("*", binary("*", "x", binary("-", 1, "y")), binary("+", 1, "y")),
        # past 64 registers: the kernel keeps validity bytes in shared memory
        "wide_program": _wide_sum,
    }
    for name in ("abs", "sqrt", "exp", "ln", "log10", "log2", "ceil", "floor",
                 "sin", "cos", "tan", "signum"):
        cases[f"fn_{name}"] = fn(name, "x")
    return cases


def _wide_sum(pe, col):
    """x + y*1 + y*2 + ... + y*39: 119 registers."""
    e = col("x")
    for k in range(1, 40):
        e = pe.Binary(e, "+", pe.Binary(col("y"), "*", pe.Lit(float(k))))
    return e


def expr_case(TK, tpe, schema, build):
    """``(program, leaves)`` of one grid case over ``schema``: its value
    and validity as the one kernel column of a program with no filter."""
    comp = TK.TorchExprCompiler(schema)
    closure = comp._lower_or_leaf(
        build(tpe, lambda name: tpe.Col(schema.get_field_index(name), name)))
    program = TK.ExprProgram(None, [closure], [(0, closure.node.dtype)], mode=comp.mode)
    return program, comp.leaves


def expr_env(TK, batch, leaves, device, mode: str = "x64") -> dict:
    """The leaves' tensors on ``device`` as a stage ships them: a validity
    with no null is None."""
    import torch

    trivial: set = set()
    host = TK.build_env(batch, leaves, batch.num_rows, trivial_valid=trivial, mode=mode)
    return {k: None if k in trivial else torch.from_numpy(np.array(v)).to(device)
            for k, v in host.items()}


def expr_diff(a, b):
    """None when two ``(pred, pvalid, values, valids)`` results are
    bit-identical (None where None, dtypes, every bit), else what differs
    (the rows, and the distance in units in the last place for f64)."""
    import torch

    def flat(out):
        pred, pvalid, values, valids = out
        return [pred, pvalid, *values, *valids]

    for k, (x, y) in enumerate(zip(flat(a), flat(b))):
        if (x is None) != (y is None):
            return f"output {k}: {type(x).__name__} against {type(y).__name__}"
        if x is None:
            continue
        if x.dtype != y.dtype or x.shape != y.shape:
            return f"output {k}: {x.dtype}{tuple(x.shape)} against {y.dtype}{tuple(y.shape)}"
        words = {torch.float64: torch.int64, torch.float32: torch.int32}
        xw = (x.view(words[x.dtype]) if x.dtype in words else x).cpu().numpy()
        yw = (y.view(words[y.dtype]) if y.dtype in words else y).cpu().numpy()
        bad = np.nonzero(xw != yw)[0]
        if bad.size:
            msg = (f"output {k} ({x.dtype}): {bad.size} rows differ, rows "
                   f"{bad[:4].tolist()}: {xw[bad[:4]].tolist()} against {yw[bad[:4]].tolist()}")
            if x.dtype == torch.float64:
                ulps = np.abs(xw[bad].astype(np.float64) - yw[bad].astype(np.float64))
                msg += f", up to {ulps.max()!r} ulp"
            return msg
    return None


def _expr_bytes(TK, program, env: dict, n: int) -> int:
    """Bytes the program must move: each input read once, each output it
    computes written once (8 bytes a value, 1 a bool or validity)."""
    inputs = [env[name] for name in program.inputs]
    present = program.presence(inputs)
    read = {s for op, _, _, a, b, *_ in program.code[: program.n_regs].tolist()
            if TK.EXPR_OPS[op] == "leaf" for s in (a, b) if s >= 0}
    total = sum(n * inputs[s].element_size() for s in read if inputs[s] is not None)
    for kind, reg, dt in program.stores:
        if kind == "value":
            total += n * {TK.DT_BOOL: 1, TK.DT_I32: 4, TK.DT_F32: 4}.get(dt, 8)
        elif present[reg]:
            total += n
    return total


def expr_check(TK, program, env: dict, n: int, device, what: str) -> dict:
    """One program: two kernel runs, the twin and the closures it was
    compiled from, all bit-identical; the launch's plan, as the C side
    gives it, equal to ops/kernels.py's mirror (``launch``: the plan and
    the kernel's registers, local bytes and CTAs an SM); then the ms of
    each (median of 20) beside the byte bound, and the kernel's card ms a
    call (``burst_ms``) and the host's ms to issue one (``host_ms``)."""
    runs = [TK.expr_eval_cuda(program, env, n, device) for _ in range(2)]
    twin = TK.expr_program_reference(program, env, n, device)
    closures = TK.closures_layout(program, env, n, device)
    for other, label in ((runs[1], "a second kernel run"), (twin, "the twin"),
                         (closures, "the closures")):
        diff = expr_diff(runs[0], other)
        if diff is not None:
            raise AssertionError(f"expr_eval {what}: kernel against {label}: {diff}")
    def call():
        return TK.expr_eval_cuda(program, env, n, device)

    widths = {s: env[program.inputs[s]].element_size() for s in program._staged
              if env[program.inputs[s]] is not None}
    launch = TK.expr_launch_describe(program, n, widths)
    mirror = TK.expr_program_plan(program, n, widths)
    if tuple(launch[k] for k in ("threads", "rows", "stages", "smem")) != tuple(mirror):
        raise AssertionError(f"expr_eval {what}: the launch's plan {launch} is not "
                             f"ops/kernels.py's {mirror}")
    ms = _median_ms(call)
    plain = _median_ms(lambda: TK.expr_program_reference(program, env, n, device))
    closures_ms = _median_ms(lambda: TK.closures_layout(program, env, n, device))
    moved = _expr_bytes(TK, program, env, n)
    return dict(rows=n, instructions=len(program.code), registers=program.n_regs,
                bytes=moved, max_abs_err=0.0, ms=ms, burst_ms=_burst_ms(call),
                host_ms=_host_ms(call), plain_ms=plain, closures_ms=closures_ms,
                library_ms=None, launch=launch, **_bound(moved))


def expr_grid_phase(TK, device) -> dict:
    """Every grid case at ``EXPR_GRID_ROWS`` rows: kernel, twin and closures
    bit-identical (:func:`expr_check`)."""
    from arrow_ballista_tpu_torch.exec import expressions as tpe

    batch = expr_grid_batch(EXPR_GRID_ROWS)
    out = {}
    for name, build in expr_grid_cases().items():
        program, leaves = expr_case(TK, tpe, batch.schema, build)
        if not program.stores:
            raise AssertionError(f"expr_eval grid {name}: the program computes nothing")
        out[name] = expr_check(TK, program, expr_env(TK, batch, leaves, device),
                               batch.num_rows, device, f"grid {name}")
    return out


def expr_query_check(TK, captured: dict, device) -> dict:
    """q1's and q6's own programs, at the first batch their cache-off run
    gave them, over its first 2^20 rows and all 2^23."""
    out = {}
    for q, ((program, env, n, _dev), _) in captured.items():
        for rows in sorted({min(r, n) for r in EXPR_QUERY_ROWS}):
            cut = {k: None if v is None else v[:rows] for k, v in env.items()}
            out[f"q{q} {rows}"] = expr_check(TK, program, cut, rows, device,
                                             f"q{q} at {rows} rows")
    return out


def _keep_expr_call(args):
    """An expression call's (program, env, n, device), the env copied."""
    program, env, n, device = args
    return (program, dict(env), n, device)


def _check_expr_launches(launches: dict, what: str, computes: bool = True) -> None:
    """``expr_eval`` launched on a leg whose stage programs compute an
    output, and not at all on one whose every output is an env tensor."""
    n = launches.get("expr_eval", 0)
    if computes and n < 1:
        raise AssertionError(f"{what}: expr_eval never launched: {json.dumps(launches)}")
    if not computes and n:
        raise AssertionError(f"{what}: expr_eval launched {n} times on pass-through programs")


# --------------------------------------------------------------- x32 phase
X32_REL = 1e-6  # the reference's x32 bar (double-float sums)
# h2o q9's r² under x32 (f32 centring and products, as the reference's
# x32 corr_fn): an f32 product rounds at 6e-8 of its size, so a group of
# 1,000 rows whose r is near 0 keeps r² only to about 1e-8 absolute; the
# leg prints how far it lands
X32_CORR_ATOL = {"r2": 1e-7}
X32_MINMAX_SQL = (
    "select l_returnflag, l_linestatus, min(l_extendedprice) as min_price, "
    "max(l_extendedprice) as max_price, max(l_quantity) as max_qty, "
    "min(l_shipdate) as min_ship, count(*) as count_order from lineitem "
    "where l_shipdate <= date '1998-09-02' group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus"
)
# the variance family's x32 leg (B12f): its own CPU run, the sort route
X32_VAR_SQL = (
    "select l_returnflag, l_linestatus, stddev(l_extendedprice) as sd_price, "
    "var_pop(l_quantity) as vp_qty, avg(l_discount) as avg_disc from lineitem "
    "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"
)
X32_GANG_PARTITIONS = 8
X32_WIDE_ROWS = 1 << 23
X32_WIDE_D_CAPACITY = 8192  # D's matmul form at its largest capacity
X32_WIDE_E_CAPACITY = 1 << 20
X32_MERGE_CAPACITY = 1 << 20
X32_SCAN_ROWS = 1 << 23
X32_CANCEL_ROWS = 1 << 20  # the cancellation mix: 16 cycles of 2^14-row runs
X32_CANCEL_CAPACITY = 64
X32_ZIPF_S = 1.1  # the skewed wide shape of D: group k of 8192 drawn with weight 1/k^1.1
# the x32 kernels each leg must launch (beside expr_eval)
X32_ROUTE_KERNELS = {
    "matmul": ("df32_agg", "x32_merge"),
    "scatter": ("df32_agg", "x32_merge"),
    "sort": ("radix_sort", "seg_scan"),
}


def _keep_merge(args):
    """An x32 merge's (state, ops, rows), the state (merged in place) copied."""
    state, ops, rows = args
    return (state.clone(), ops, rows)


def _check_x32_launches(launches: dict, route: str, what: str) -> None:
    for k in X32_ROUTE_KERNELS[route]:
        if launches.get(k, 0) < 1:
            raise AssertionError(f"{what}: {k} never launched: {json.dumps(launches)}")
    for k in ("segment_agg", "segment_agg_entries"):
        if launches.get(k, 0):
            raise AssertionError(f"{what}: the x64 kernel {k} launched")


def x32_phase(tbt, TK, batches, wants: dict, device) -> dict:
    """x32 mode (``set_precision("x32")`` around these legs only) over the
    lineitem batches the x64 legs used, against those legs' CPU-operator
    answers (rel 1e-6, integers exact): q1 and q6 three ways (cache off:
    D matmul and M per batch; cold: per entry; warm: a cache hit replayed
    through D), q1 warm again under the forced scatter (D's scatter form)
    and sort (K2's df32) routes, the min/max query against its own CPU run
    (f64 extrema bit-exact: E), and q1 over 8 partitions as one mesh gang
    (mesh_reduce's x32 form).  Returns each leg's launches and the main
    path's captured kernel arguments."""
    TK.set_precision("x32")
    try:
        return _x32_legs(tbt, TK, batches, wants, device)
    finally:
        TK.set_precision(None)
        TK.set_agg_algorithm(None)


def _x32_legs(tbt, TK, batches, wants: dict, device) -> dict:
    import torch

    from arrow_ballista_tpu_torch.parallel.mesh_stage import MeshGangExec
    from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec
    from arrow_ballista_tpu_torch.parallel import mesh as TM
    from benchmarks.tpch.queries import QUERIES

    t_start = time.perf_counter()
    n_rows = sum(b.num_rows for b in batches)

    def session(enable: bool, extra: dict, parts=None):
        cfg = dict(SETTINGS, **extra, **{"ballista.tpu.enable": str(enable).lower()})
        ctx = tbt.SessionContext(tbt.BallistaConfig(cfg), device=device)
        ctx.register_record_batches("lineitem", parts or [batches])
        return ctx

    def leg(ctx, sql, what, route, want, exact=False, captures=()):
        plan = ctx.sql(sql).physical_plan()
        stages = _stage_nodes(plan, TorchStageExec)
        if not stages:
            raise AssertionError(f"{what}: no TorchStageExec in the plan")
        _reset_counts(TK)
        caps = [Capture(TM if name.startswith("mesh_") else TK, name, keep=keep)
                for name, keep in captures]
        for c in caps:
            c.__enter__()
        try:
            t0 = time.perf_counter()
            got = ctx.execute(plan)
            torch.cuda.synchronize()
            dev_s = time.perf_counter() - t0
        finally:
            for c in caps:
                c.__exit__()
        launches = _launches(TK)
        metrics = _stage_metrics(stages + _stage_nodes(plan, MeshGangExec))
        for k in ("tpu_fallback", "cpu_fallback", "highcard_fallback", "mesh_fallback"):
            if metrics.get(k, 0):
                raise AssertionError(f"{what}: {k}={metrics[k]}")
        _tables_equal(want, got, what, rel=0.0 if exact else X32_REL)
        _check_expr_launches(launches, what)
        _check_x32_launches(launches, route, what)
        breakdown = {k: metrics.get(k, 0) for k in BREAKDOWN + ("cache_hits", "fused_dispatches")}
        print(f"x32 {what}: rows={n_rows} launches={json.dumps(launches)} "
              f"cuda_rows_per_s={n_rows / dev_s!r} cuda_s={dev_s!r} "
              f"breakdown={json.dumps(breakdown)}")
        return got, metrics, dict(launches=launches,
                                  captured={c.name: c.args for c in caps})

    out: dict = {}
    for q in (1, 6):
        results = {}
        ctx = None
        for name, extra in CACHE_RUNS:
            if name != "warm":
                ctx = session(True, extra)
            captures = []
            if name == "cache_off":
                captures = [("df32_agg_cuda", None), ("x32_merge_cuda", _keep_merge),
                            ("expr_eval_cuda", _keep_expr_call)]
            got, metrics, run_ = leg(ctx, QUERIES[q], f"q{q} {name}", "matmul", wants[q],
                                     captures=captures)
            launches = run_["launches"]
            if name == "cache_off":
                if launches["x32_merge"] != launches["expr_eval"]:
                    raise AssertionError(f"q{q} x32 cache off: one merge a batch: "
                                         f"{json.dumps(launches)}")
            else:
                hits = metrics.get("cache_hits", 0)
                if (name == "cold") != (hits == 0) or metrics.get("fused_dispatches", 0) != 1:
                    raise AssertionError(f"q{q} x32 {name}: {json.dumps(metrics)}")
            if name == "warm":
                for k in ("key_encode_time_ns", "bridge_time_ns"):
                    if metrics.get(k, 0):
                        raise AssertionError(f"q{q} x32 warm: {k}={metrics[k]}")
                if not got.equals(results["cold"]):
                    raise AssertionError(f"q{q} x32: warm differs from cold")
            results[name] = got
            out[f"q{q} {name}"] = run_
        if q == 1:
            # forced routes, replaying the cached entries of the warm session
            for algo in ("scatter", "sort"):
                TK.set_agg_algorithm(algo)
                captures = ([("sorted_segment_agg_x32_cuda", _keep_state)]
                            if algo == "sort" else [("df32_agg_cuda", None)])
                got, metrics, run_ = leg(ctx, QUERIES[1], f"q1 warm {algo}", algo, wants[1],
                                         captures=captures)
                if not metrics.get("cache_hits", 0):
                    raise AssertionError(f"x32 q1 warm {algo}: no cache hit")
                out[f"q1 warm {algo}"] = run_
            TK.set_agg_algorithm(None)
        del ctx, results

    # the min/max query: its own CPU run, the f64 extrema bit-exact
    cpu_ctx = session(False, {})
    t0 = time.perf_counter()
    want = cpu_ctx.sql(X32_MINMAX_SQL).collect()
    print(f"x32 min/max: cpu_s={time.perf_counter() - t0!r}")
    del cpu_ctx
    ctx = session(True, {})
    _, _, run_ = leg(ctx, X32_MINMAX_SQL, "q1 min/max", "matmul", want, exact=True,
                     captures=[("ord_extremum_cuda", None)])
    if run_["launches"]["ord_extremum"] < 1:
        raise AssertionError("x32 min/max: ord_extremum never launched")
    out["q1 min/max"] = run_
    del ctx

    # the variance family: stddev and var_pop square their exact f32 pairs
    # in B3 (B12f) and the stage takes the sort route; its own CPU run
    cpu_ctx = session(False, {})
    t0 = time.perf_counter()
    want = cpu_ctx.sql(X32_VAR_SQL).collect()
    print(f"x32 q1 variance: cpu_s={time.perf_counter() - t0!r}")
    del cpu_ctx
    ctx = session(True, {})
    _, _, run_ = leg(ctx, X32_VAR_SQL, "q1 variance", "sort", want,
                     captures=[("expr_eval_cuda", _keep_expr_call)])
    program = run_["captured"]["expr_eval_cuda"][0][0]
    if "sqpair_lo" not in [TK.EXPR_OPS[r[0]] for r in program.code]:
        raise AssertionError("x32 q1 variance: the program has no square pair")
    out["q1 variance"] = run_
    del ctx

    # q1 over 8 partitions: the partial aggregate as one mesh gang
    parts = [batches[i::X32_GANG_PARTITIONS] for i in range(X32_GANG_PARTITIONS)]
    ctx = session(True, {}, parts=[p for p in parts if p])
    plan = ctx.sql(QUERIES[1]).physical_plan()
    if not _stage_nodes(plan, MeshGangExec):
        raise AssertionError("x32 gang: no MeshGangExec in q1's plan over 8 partitions")
    _, _, run_ = leg(ctx, QUERIES[1], "q1 gang", "matmul", wants[1],
                     captures=[("mesh_reduce_cuda", None)])
    if run_["launches"]["mesh_reduce"] < 1:
        raise AssertionError("x32 gang: mesh_reduce never launched")
    out["q1 gang"] = run_
    del ctx
    print(f"x32 legs: s={time.perf_counter() - t_start!r}")
    return out


def _df32_bytes(args) -> int:
    gid, tail, pred, pvalid, values, valids, sums, counts, cap, _block = args
    n = gid.numel()
    read = {a for a, _ in sums} | {b for _, b in sums if b >= 0}
    total = 4 * n + _nbytes(tail, pred, pvalid)
    total += sum(_nbytes(values[c]) for c in read)
    total += sum(_nbytes(valids[c]) for c in read | {c for c in counts if c >= 0})
    return total + (2 * len(sums) + len(counts)) * cap * 4


DF32_RUN_ROWS = 1 << 14  # df32_agg.h: kDfRunRows, the most rows pass 1 sorts in one CTA


def _df32_partial_bytes(args) -> int:
    """The bytes of D's block partials, written by pass 1 and read back by
    pass 2: [blocks x runs a block, summed columns + counts, capacity]
    words (the reference's block structure makes them part of the work)."""
    gid, _t, _p, _v, _vals, _ok, sums, counts, cap, block = args
    n = gid.numel()
    runs = -(-n // block) * -(-block // DF32_RUN_ROWS)
    cols = len({a for a, _ in sums} | {b for _, b in sums if b >= 0}) + len(counts)
    return 2 * runs * cols * cap * 4


def _df32_pass_split(TK, args, reps: int = 10) -> dict:
    """Device ms per launch of D's two passes, from torch.profiler's kernel
    records: pass 1 (``df32_partial``: the block partials) and pass 2
    (``df32_combine``: the 2Sum tree over the blocks, the counts); None
    for both where the profiler records no kernel (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    TK.df32_agg_cuda(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            TK.df32_agg_cuda(*args)
        torch.cuda.synchronize()
    us = {"pass1_ms": 0.0, "pass2_ms": 0.0}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        if "df32_partial" in e.key:
            us["pass1_ms"] += t
        elif "df32_combine" in e.key:
            us["pass2_ms"] += t
    if not us["pass1_ms"] and args[0].numel():
        print("df32_agg pass split: the profiler recorded no df32_partial (not measured)")
        return {k: None for k in us}
    return {k: v / reps / 1e3 for k, v in us.items()}


def _df32_check(TK, args, what: str) -> dict:
    """D against its twin: hi + lo within X32_REL, counts exact, two launches
    bit-identical; ms beside the bound and the library calls (index_add_,
    and torch.bmm of the block one-hot with TF32 off where it fits)."""
    import torch

    gid, tail, pred, pvalid, values, valids, sums, counts, cap, block = args
    runs = [TK.df32_agg_cuda(*args) for _ in range(2)]
    twin = TK.df32_agg_reference(*args)
    if not all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])):
        raise AssertionError(f"df32_agg {what}: two launches differ")
    k = (runs[0][0].double() + runs[0][1].double()).cpu().numpy()
    t = (twin[0].double() + twin[1].double()).cpu().numpy()
    diff = np.abs(k - t)
    if np.any(diff > X32_REL * np.abs(t)):
        raise AssertionError(f"df32_agg {what}: off by {diff.max()!r}")
    if not torch.equal(runs[0][2], twin[2]):
        raise AssertionError(f"df32_agg {what}: counts differ")
    n = gid.numel()
    mask = torch.ones(n, dtype=torch.bool, device=gid.device)
    for m in (tail, pred, pvalid):
        if m is not None:
            mask &= m
    cols = [torch.where(mask if valids[a] is None else mask & valids[a], values[a], 0.0)
            for a, _ in sums]
    cols += [(mask if c < 0 or valids[c] is None else mask & valids[c]).float() for c in counts]
    V = torch.stack(cols, dim=1)
    acc = torch.zeros(cap, V.shape[1], dtype=torch.float32, device=V.device)
    g = gid.long()
    library = _median_ms(lambda: acc.index_add_(0, g, V))
    bmm_ms = None
    nb = TK._df32_blocks(n, TK.DF32_BLOCK)
    if nb * TK.DF32_BLOCK * cap * 4 <= (4 << 30):
        # the reference's einsum as one batched product, in full f32
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            pad = nb * TK.DF32_BLOCK - n
            gp = torch.nn.functional.pad(g, (0, pad)).view(nb, TK.DF32_BLOCK)
            Vp = torch.nn.functional.pad(V, (0, 0, 0, pad)).view(nb, TK.DF32_BLOCK, -1)
            onehot = torch.nn.functional.one_hot(gp, cap).float().transpose(1, 2)
            bmm_ms = _median_ms(lambda: torch.bmm(onehot, Vp))
            del onehot
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    partial_bytes = _df32_partial_bytes(args)
    return dict(rows=n, capacity=cap, block=block, sums=len(sums), counts=len(counts),
                max_abs_err=float(diff.max()) if diff.size else 0.0,
                ms=_median_ms(lambda: TK.df32_agg_cuda(*args)),
                plain_ms=_median_ms(lambda: TK.df32_agg_reference(*args), reps=3),
                library_ms=library, bmm_tf32_off_ms=bmm_ms, **_bound(_df32_bytes(args)),
                partial_bytes=partial_bytes,
                partial_ms=partial_bytes / HBM_BYTES_PER_S * 1e3,
                **_df32_pass_split(TK, args))


def _ord_check(TK, args, what: str) -> dict:
    """E bit-identical to its twin (two launches too); ms beside the bound and
    scatter_reduce over the operand's int64 order keys."""
    import torch

    gid, tail, pred, pvalid, valid, hi, lo, cap, is_min = args
    runs = [TK.ord_extremum_cuda(*args) for _ in range(2)]
    twin = TK.ord_extremum_reference(*args)
    if not (torch.equal(runs[0], runs[1]) and torch.equal(runs[0], twin)):
        raise AssertionError(f"ord_extremum {what}: differs from its twin")
    kind = TK.ORD_PAIR if lo is not None else (TK.ORD_F32 if hi.dtype == torch.float32
                                                else TK.ORD_I32)
    keys = TK._ord_keys(kind, hi, lo, is_min)
    out = torch.full((cap,), TK._ord_ident(kind, is_min), dtype=torch.int64, device=gid.device)
    g = gid.long()
    library = _median_ms(lambda: out.scatter_reduce(0, g, keys, "amin" if is_min else "amax"))
    moved = 4 * gid.numel() + _nbytes(tail, pred, pvalid, valid, hi, lo) + _nbytes(twin)
    return dict(rows=gid.numel(), capacity=cap, pair=lo is not None, max_abs_err=0.0,
                ms=_median_ms(lambda: TK.ord_extremum_cuda(*args)),
                plain_ms=_median_ms(lambda: TK.ord_extremum_reference(*args), reps=3),
                library_ms=library, **_bound(moved))


def _merge_check(TK, state0, ops, rows, what: str) -> dict:
    """M bit-identical to its twin and to itself; ms beside the bound (no
    single PyTorch call merges 2Sum pairs: library none)."""
    import torch

    runs = [TK.x32_merge_cuda(state0.clone(), ops, rows) for _ in range(2)]
    twin = TK.x32_merge_reference(state0.clone(), ops, [r.clone() for r in rows])
    if not (torch.equal(runs[0], runs[1]) and torch.equal(runs[0], twin)):
        raise AssertionError(f"x32_merge {what}: differs from its twin")
    s = state0.clone()
    return dict(fields=len(ops), capacity=state0.shape[1], max_abs_err=0.0,
                ms=_median_ms(lambda: TK.x32_merge_cuda(s, ops, rows)),
                plain_ms=_median_ms(lambda: TK.x32_merge_reference(s.clone(), ops, rows), reps=5),
                library_ms=None, **_bound(3 * _nbytes(state0)))


def _x32_wide_inputs(TK, n: int, cap: int, seed: int, device):
    """q1-like x32 inputs: five f32 columns (one with nulls), an int64 pair
    split into f32 halves, an order pair and an int32 column."""
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    gid = rng.integers(0, cap, n, dtype=np.int32)
    vals = [rng.uniform(1.0, 1e5, n).astype(np.float32) for _ in range(5)]
    big = rng.integers(1 << 33, 1 << 40, n)
    hi = big.astype(np.float32)
    lo = (big - hi.astype(np.float64)).astype(np.float32)
    from arrow_ballista_tpu_torch.ops.bridge import split_u64_i32, to_u64_order

    f64 = rng.uniform(-1e3, 1e3, n) * (1 + rng.integers(-4, 5, n) * 1e-13)
    ohi, olo = split_u64_i32(to_u64_order(f64))
    ints = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int64).astype(np.int32)
    valid = rng.random(n) >= 0.05
    return dict(
        gid=t(gid), tail=t(np.arange(n) < n - 1000), pred=t(rng.random(n) >= 0.2),
        values=[t(v) for v in vals] + [t(hi), t(lo), t(ohi), t(olo), t(ints)],
        valids=[t(valid)] + [None] * 4 + [t(valid), t(valid), t(valid), t(valid), None],
    )


def df32_cancel_inputs(n: int, cap: int, unit: int, seed: int) -> tuple:
    """The double-float cancellation mix as numpy ``(gid int32, pred bool,
    v float32)``: runs of ``unit`` rows in cycles of four — large values
    (k·2^8, k in 1..15), tiny ones of both signs (k·2^-12, |k| <= 7), the
    first run's rows again with the large values negated, tiny ones — so
    each group's large values cancel exactly and its sum is its tiny
    values', near 0 beside the magnitudes.  The scaled integers stay under
    2^24 in every ``unit``-row block (``unit`` a multiple of the block),
    so each block's per-group f32 partial is exact and a double-float sum
    over the blocks (or a df32 scan) lands on the f64 sum, where a plain
    f32 sum — the hi word of the 2Sum tree alone, or numpy's f32 pairwise
    sum — drops the tiny values next to the large partials."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, cap, n).astype(np.int32)
    pred = rng.random(n) >= 0.1
    run = (np.arange(n) // unit) % 4
    v = np.where(run % 2 == 0, rng.integers(1, 16, n) * 256.0,
                 rng.integers(-7, 8, n) * 2.0 ** -12)
    third = np.flatnonzero(run == 2)
    src = third - 2 * unit
    gid[third], pred[third], v[third] = gid[src], pred[src], -v[src]
    return gid, pred, v.astype(np.float32)


def cancel_sums(gid, pred, v, cap: int) -> tuple:
    """The mix's per-group f64 sum and numpy's f32 pairwise sum (the plain
    f32 control) of the same rows in row order."""
    want = np.zeros(cap)
    np.add.at(want, gid[pred], v[pred].astype(np.float64))
    naive = np.array([np.sum(v[pred & (gid == g)]) for g in range(cap)], np.float64)
    return want, naive


def cancel_miss(got, want) -> float:
    """The worst |got - want| past the bar X32_REL·|want| on any group (0.0:
    every group within it)."""
    diff = np.abs(np.asarray(got, np.float64) - want)
    return float(np.max(np.where(diff > X32_REL * np.abs(want), diff, 0.0)))


def _check_cancel(got, want, controls: dict, what: str) -> dict:
    """``got`` within the bar on every group, and each plain f32 control
    past it (else the input proves nothing)."""
    miss = cancel_miss(got, want)
    if miss:
        raise AssertionError(f"{what} on the cancellation mix: off by {miss!r}")
    out = dict(max_abs_err=float(np.max(np.abs(np.asarray(got, np.float64) - want))))
    for name, c in controls.items():
        out[f"{name}_err"] = cancel_miss(c, want)
        if not out[f"{name}_err"]:
            raise AssertionError(f"{what}: the control {name} meets the cancellation bar")
    return out


def _df32_cancel_check(TK, device) -> dict:
    """D on the cancellation mix, both forms: hi + lo of the kernel (two
    launches bit-identical) and of its twin against the f64 sum at rel
    X32_REL on each group, a bar the hi word alone (D's plain f32 pairwise
    tree over the blocks) and numpy's f32 sum each fail."""
    import torch

    n, cap = X32_CANCEL_ROWS, X32_CANCEL_CAPACITY
    gid, pred, v = df32_cancel_inputs(n, cap, TK.DF32_BLOCK, 47)
    want, naive = cancel_sums(gid, pred, v, cap)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    out = {}
    for form, block in (("matmul", TK.DF32_BLOCK),
                        ("scatter", TK.df32_scatter_block(n, cap, device))):
        if TK.DF32_BLOCK % block:
            raise AssertionError(f"cancellation mix: {form} block {block}")
        args = (t(gid), None, t(pred), None, [t(v)], [None], [(0, -1)], [], cap, block)
        runs = [TK.df32_agg_cuda(*args) for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])):
            raise AssertionError(f"df32_agg cancellation {form}: two launches differ")
        twin = TK.df32_agg_reference(*args)
        hi, lo = (x[0].double().cpu().numpy() for x in runs[0][:2])
        _check_cancel(twin[0][0].double().cpu().numpy() + twin[1][0].double().cpu().numpy(),
                      want, {}, f"df32_agg twin {form}")
        out[form] = dict(rows=n, capacity=cap, block=block, **_check_cancel(
            hi + lo, want, {"hi_alone": hi, "f32_pairwise": naive}, f"df32_agg {form}"))
    return out


def _scan_cancel_check(TK, device) -> dict:
    """K2's df32 fold on the cancellation mix sorted by group (each
    segment's rows in row order): each segment's total, of the kernel (two
    launches bit-identical) and of its twin, against the f64 sum at rel
    X32_REL, a bar numpy's f32 pairwise sum fails."""
    import torch

    n, cap = X32_CANCEL_ROWS, X32_CANCEL_CAPACITY
    gid, pred, v = df32_cancel_inputs(n, cap, TK.DF32_BLOCK, 53)
    want, naive = cancel_sums(gid, pred, v, cap)
    order = np.argsort(gid, kind="stable")
    key = torch.from_numpy(gid[order]).to(device)
    cols = [TK.ScanColumn(TK.SS_VALUES, TK.OP_DF32, values=torch.from_numpy(v[order]).to(device),
                          valid=torch.from_numpy(pred[order]).to(device))]
    last = torch.from_numpy(np.searchsorted(gid[order], np.arange(1, cap + 1)) - 1).to(device)
    runs = [TK.seg_scan_cuda(cols, n, key=key)[0] for _ in range(2)]
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError("seg_scan df32 cancellation: two launches differ")
    total = lambda s: sum(x.double() for x in TK._df32_split(s[last])).cpu().numpy()  # noqa: E731
    _check_cancel(total(TK.seg_scan_reference(cols, n, key=key)[0]), want, {},
                  "seg_scan df32 twin")
    return dict(rows=n, capacity=cap, **_check_cancel(
        total(runs[0]), want, {"f32_pairwise": naive}, "seg_scan df32"))


def _x32_scan_check(TK, device) -> dict:
    """K2's x32 ops (df32, unsigned pair min/max) against the twin over
    X32_SCAN_ROWS sorted rows: pair ops bit-identical, df32 within X32_REL
    on hi + lo, two launches bit-identical."""
    import torch

    d = _x32_wide_inputs(TK, X32_SCAN_ROWS, 1 << 16, 23, device)
    v, ok = d["values"], d["valids"]
    cols = [TK.ScanColumn(TK.SS_VALUES, TK.OP_DF32, values=v[0], valid=ok[0]),
            TK.ScanColumn(TK.SS_VALUES, TK.OP_DF32, values=v[5], valid=ok[5], values2=v[6]),
            TK.ScanColumn(TK.SS_VALUES, TK.OP_UMIN_U64, values=v[7], valid=ok[7], values2=v[8]),
            TK.ScanColumn(TK.SS_VALUES, TK.OP_UMAX_U64, values=v[7], valid=ok[7], values2=v[8])]
    key = torch.sort(d["gid"]).values
    kw = dict(key=key)
    runs = [TK.seg_scan_cuda(cols, X32_SCAN_ROWS, **kw) for _ in range(2)]
    twin = TK.seg_scan_reference(cols, X32_SCAN_ROWS, **kw)
    worst = 0.0
    for c, (a, b, w) in enumerate(zip(runs[0], runs[1], twin)):
        if not torch.equal(a, b):
            raise AssertionError(f"seg_scan x32 column {c}: two launches differ")
        if cols[c].op == TK.OP_DF32:
            ka = sum(x.double() for x in TK._df32_split(a)).cpu().numpy()
            tw = sum(x.double() for x in TK._df32_split(w)).cpu().numpy()
            diff = np.abs(ka - tw)
            worst = max(worst, float(diff.max()))
            if np.any(diff > X32_REL * np.abs(tw)):
                raise AssertionError(f"seg_scan x32 df32 column {c}: off by {diff.max()!r}")
        elif not torch.equal(a, w):
            raise AssertionError(f"seg_scan x32 pair column {c}: differs from the twin")
    moved = _scan_bytes(TK, cols, X32_SCAN_ROWS, **kw) + sum(_nbytes(c.values2) for c in cols)
    return dict(rows=X32_SCAN_ROWS, columns=len(cols), max_abs_err=worst,
                ms=_median_ms(lambda: TK.seg_scan_cuda(cols, X32_SCAN_ROWS, **kw)),
                plain_ms=_median_ms(lambda: TK.seg_scan_reference(cols, X32_SCAN_ROWS, **kw),
                                    reps=3),
                library_ms=None, **_bound(moved))


def _sorted_x32_check(TK, captured) -> dict:
    """x32's sort route (K1 + K2's x32 ops and epilogue) at the forced-sort
    leg's first entry against its twin: sums within X32_REL, counts and
    extrema exact."""
    import torch

    (gid, tail, pred, pvalid, values, valids, layout, state0), _ = captured
    k = TK.sorted_segment_agg_x32_cuda(gid, tail, pred, pvalid, values, valids, layout,
                                       state0.clone())
    t = TK.sorted_segment_agg_x32_reference(gid, tail, pred, pvalid, values, valids, layout,
                                            state0.clone())
    kk, tt = k.cpu().numpy(), t.cpu().numpy()
    worst = 0.0
    for f, op in enumerate(layout.ops):
        if op == TK.XM_SUM_HI:
            ks = kk[f].view(np.float32).astype(np.float64) + kk[f + 1].view(np.float32)
            ts = tt[f].view(np.float32).astype(np.float64) + tt[f + 1].view(np.float32)
            diff = np.abs(ks - ts)
            worst = max(worst, float(diff.max()))
            if np.any(diff > X32_REL * np.abs(ts)):
                raise AssertionError(f"x32 sort route field {f}: off by {diff.max()!r}")
        elif op != TK.XM_SUM_LO and not np.array_equal(kk[f], tt[f]):
            raise AssertionError(f"x32 sort route field {f}: differs from the twin")
    n = gid.numel()
    args = (gid, tail, pred, pvalid, values, valids, layout)
    moved = 4 * n + _nbytes(tail, pred, pvalid, *values, *valids) + 2 * _nbytes(state0)
    return dict(rows=n, capacity=state0.shape[1], max_abs_err=worst,
                ms=_median_ms(lambda: TK.sorted_segment_agg_x32_cuda(*args, state0.clone())),
                plain_ms=_median_ms(lambda: TK.sorted_segment_agg_x32_reference(
                    *args, state0.clone()), reps=3),
                library_ms=None, **_bound(moved))


def _shard_states_x32(TK, specs, cap: int, n_shards: int, seed: int, device) -> list:
    """Seeded x32 shard states: f32 rows normal (NaN and -0.0 sprinkled in),
    counts small, order-pair words any int32."""
    import torch

    rng = np.random.default_rng(seed)
    states = []
    for _ in range(n_shards):
        rows = []
        for role, is_int in TK._field_flags(specs, "x32"):
            if is_int:
                rows.append(rng.integers(0, 1 << 20, cap).astype(np.int32) if role == "add"
                            else rng.integers(-(1 << 31), (1 << 31) - 1, cap).astype(np.int32))
            else:
                v = (rng.normal(size=cap) * 1e6).astype(np.float32)
                v[::97] = np.nan
                v[5::89] = -0.0
                rows.append(v.view(np.int32))
        states.append(torch.from_numpy(np.stack(rows)).to(device))
    return states


def zipf_gid(n: int, cap: int, s: float, seed: int) -> np.ndarray:
    """Group ids drawn from a Zipf law of exponent ``s`` over ``cap``
    groups (group rank k drawn with weight 1/k^s), ranks shuffled over the
    ids."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, cap + 1, dtype=np.float64) ** s
    g = rng.choice(cap, size=n, p=w / w.sum())
    return rng.permutation(cap).astype(np.int32)[g]


def _df32_q1_like(TK, device) -> tuple:
    """Stand-ins for the two q1 captures when D runs without the legs:
    X32_WIDE_ROWS rows in q1's 4 groups at capacity 64, a tail mask, five
    f32 sums and the row count."""
    w = _x32_wide_inputs(TK, X32_WIDE_ROWS, 4, 29, device)
    base = (w["gid"], w["tail"], None, None, w["values"][:5], [None] * 5,
            [(c, -1) for c in range(5)], [-1], 64)
    return (base + (TK.DF32_BLOCK,),
            base + (TK.df32_scatter_block(X32_WIDE_ROWS, 64, device),))


def df32_phase(TK, device, q1=None, q1_scatter=None) -> dict:
    """D against its twin (``_df32_check``: rel X32_REL on hi + lo, counts
    exact, two launches bit-identical, ms and the two passes beside the
    bound, the partials and the library calls) at q1's main-path calls
    (``q1``, ``q1_scatter``: the legs' captured arguments, else
    ``_df32_q1_like``), at the wide shape in both forms, at the wide matmul
    form with Zipf-skewed group ids (exponent X32_ZIPF_S), and on the
    cancellation mix in both forms."""
    if q1 is None:
        q1, q1_scatter = _df32_q1_like(TK, device)
    out = {"q1 matmul form": _df32_check(TK, q1, "q1 matmul form"),
           "q1 scatter form": _df32_check(TK, q1_scatter, "q1 scatter form")}
    cap = X32_WIDE_D_CAPACITY
    w = _x32_wide_inputs(TK, X32_WIDE_ROWS, cap, 31, device)
    wide = (w["gid"], w["tail"], w["pred"], None, w["values"][:5], w["valids"][:5],
            [(c, -1) for c in range(5)], [-1, 0], cap, TK.DF32_BLOCK)
    out[f"wide cap {cap} matmul form"] = _df32_check(TK, wide, "wide matmul form")
    block = TK.df32_scatter_block(X32_WIDE_ROWS, cap, device)
    pair = (w["gid"], w["tail"], w["pred"], None, w["values"], w["valids"],
            [(5, 6)], [5], cap, block)
    out[f"wide cap {cap} scatter form, int64 pair"] = _df32_check(
        TK, pair, "wide scatter form")
    import torch

    zipf = (torch.from_numpy(zipf_gid(X32_WIDE_ROWS, cap, X32_ZIPF_S, 33)).to(device),) + wide[1:]
    out[f"wide cap {cap} matmul form, Zipf {X32_ZIPF_S}"] = _df32_check(
        TK, zipf, "wide matmul form, Zipf")
    del w, wide, pair, zipf
    for form, r in _df32_cancel_check(TK, device).items():
        out[f"cancellation {form} form"] = r
    return out


def x32_kernel_phase(TK, device, legs: dict) -> dict:
    """Every x32 kernel and op against its twin at the first main-path shape
    the legs captured and at a wide one, with its ms, bound and library
    yardstick (CUDA events, median of 20); D and K2's df32 fold also on the
    cancellation mix against the f64 sum, beside their plain f32 controls."""
    import torch

    from arrow_ballista_tpu_torch.parallel import mesh as TM

    t0 = time.perf_counter()
    out: dict = {"df32_agg": {}, "ord_extremum": {}, "x32_merge": {}, "seg_scan": {},
                 "mesh_reduce": {}, "expr_eval": {}}
    cap_ = legs["q1 cache_off"]["captured"]
    out["df32_agg"] = df32_phase(TK, device, cap_["df32_agg_cuda"][0],
                                 legs["q1 warm scatter"]["captured"]["df32_agg_cuda"][0])

    (e_args, _) = legs["q1 min/max"]["captured"]["ord_extremum_cuda"]
    out["ord_extremum"]["q1 min/max first call"] = _ord_check(TK, e_args, "q1 min/max")
    w = _x32_wide_inputs(TK, X32_WIDE_ROWS, X32_WIDE_E_CAPACITY, 37, device)
    v, ok = w["values"], w["valids"]
    for name, hi, lo, valid, is_min in (("pair min", v[7], v[8], ok[7], True),
                                        ("pair max", v[7], v[8], ok[7], False),
                                        ("f32 min", v[0], None, ok[0], True),
                                        ("i32 max", v[9], None, None, False)):
        args = (w["gid"], w["tail"], w["pred"], None, valid, hi, lo, X32_WIDE_E_CAPACITY, is_min)
        out["ord_extremum"][f"wide cap {X32_WIDE_E_CAPACITY} {name}"] = _ord_check(TK, args, name)
    del w

    (state0, ops, rows), _ = cap_["x32_merge_cuda"]
    out["x32_merge"]["q1 first batch"] = _merge_check(TK, state0, ops, rows, "q1")
    specs = _mixed_specs(TK) + [TK.KernelAggSpec("max", True, ord_pair=True)]
    s = _shard_states_x32(TK, specs, X32_MERGE_CAPACITY, 2, 41, device)
    out["x32_merge"][f"wide cap {X32_MERGE_CAPACITY}"] = _merge_check(
        TK, s[0], TK.x32_merge_ops(specs), list(s[1]), "wide")
    del s

    out["seg_scan"]["x32 ops"] = _x32_scan_check(TK, device)
    out["seg_scan"]["x32 df32 cancellation"] = _scan_cancel_check(TK, device)
    out["seg_scan"]["x32 sort route q1 entry"] = _sorted_x32_check(
        TK, legs["q1 warm sort"]["captured"]["sorted_segment_agg_x32_cuda"])

    (r_specs, r_states), _ = legs["q1 gang"]["captured"]["mesh_reduce_cuda"]
    out["mesh_reduce"]["x32 q1 gang"] = _time_reduce(TM, r_specs, r_states)
    for cap in MESH_REDUCE_CAPACITIES:
        st = _shard_states_x32(TK, specs, cap, MESH_SHARDS, 43, device)
        out["mesh_reduce"][f"x32 {MESH_SHARDS} shards cap {cap}"] = _time_reduce(TM, specs, st)
    del st

    (program, env, n, dev), _ = cap_["expr_eval_cuda"]
    out["expr_eval"]["x32 q1"] = expr_check(TK, program, env, n, dev, "x32 q1")
    for kind, shapes in out.items():
        for name, t in shapes.items():
            print(f"timing {kind} {name}: {json.dumps(t)}")
    print(f"x32 kernel phase: ok s={time.perf_counter() - t0!r}")
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
    V = _masked_sums(TK, args, ops, cols)
    library = None
    if V is not None:
        g = args["gid"].long()
        acc = torch.zeros(cap, V.shape[1], dtype=torch.float64, device=V.device)
        library = _median_ms(lambda: acc.index_add_(0, g, V))
    bytes_ms = _bytes_moved(args, state0) / HBM_BYTES_PER_S * 1e3
    ops_ms = n * len(ops) / F64_OPS_PER_S * 1e3
    out = dict(
        rows=n, capacity=cap, fields=len(ops), columns=len(args["values"]),
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=library,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )
    out.update(seg_agg_split(lambda: _call(TK.segment_agg_cuda, args, ops, cols, k_state)))
    return out


def _host_ms(fn, reps: int = 20) -> float:
    """The host's ms to issue one call of ``fn`` (wrapper, binding,
    launches) with the card idle: median of ``reps``."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


# B1's and B13a's kernels by pass (the names of segment_agg.cu and
# segment_agg_entries.cu)
SEG_AGG_PASSES = {"segment_agg_partial": "pass1_ms", "entries_partial": "pass1_ms",
                  "segment_agg_merge": "pass2_ms", "entries_merge": "pass2_ms"}


def seg_agg_split(fn, reps: int = 10) -> dict:
    """Where a B1 or B13a call's time goes: ``burst_ms`` (the card's ms a
    call), ``host_ms`` (the host's, ``_host_ms``) and, from torch.profiler's
    records, the card's ms a call in pass 1, in pass 2 and in PyTorch's own
    kernels and copies (``torch_ms``: fills, the entry table's copy); the
    three are None (not measured) where the records sum to less than half
    of ``burst_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = dict(burst_ms=_burst_ms(fn), host_ms=_host_ms(fn))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {"pass1_ms": 0.0, "pass2_ms": 0.0, "torch_ms": 0.0}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        if t:
            k = next((v for name, v in SEG_AGG_PASSES.items() if name in e.key), "torch_ms")
            split[k] += t / reps / 1e3
    if sum(split.values()) < 0.5 * out["burst_ms"]:
        print(f"segment_agg split: the profiler recorded {sum(split.values())!r} ms of "
              f"{out['burst_ms']!r} (not measured)")
        split = {k: None for k in split}
    out.update(split)
    return out


# ------------------------------------------------- keyed route timing
def _words_close(got, twin, f64_rows=()) -> float:
    """Raise unless two int64 word tensors agree: rows in ``f64_rows`` as
    f64 within REL (NaN matching NaN), every other row bit for bit.
    Returns the largest absolute difference of the f64 rows."""
    g, t = got.cpu().numpy(), twin.cpu().numpy()
    if g.shape != t.shape:
        raise AssertionError(f"shape {g.shape} vs {t.shape}")
    worst = 0.0
    for r in range(g.shape[0]):
        if r in f64_rows:
            gf, tf = g[r].view(np.float64), t[r].view(np.float64)
            if not np.array_equal(np.isnan(gf), np.isnan(tf)):
                raise AssertionError(f"row {r}: NaN positions differ")
            if not np.array_equal(gf[np.isinf(tf)], tf[np.isinf(tf)]):
                raise AssertionError(f"row {r}: infinities differ")
            ok = np.isfinite(tf)
            diff = np.abs(gf[ok] - tf[ok])
            if diff.size:
                worst = max(worst, float(diff.max()))
            if np.any(~(diff <= REL * np.abs(tf[ok]))):
                raise AssertionError(f"row {r}: off by {diff.max()}")
        elif not np.array_equal(g[r], t[r]):
            raise AssertionError(f"row {r}: words differ")
    return worst


def _time_key_encode(TK, captured) -> dict:
    (kinds, keys, masks, n, device, *code_dtype), _ = captured
    got, twin = TK.key_encode_cuda(*captured[0]), TK.key_encode_reference(*captured[0])
    import torch

    if not torch.equal(got[0], twin[0]) or not all(
            torch.equal(a, b) for a, b in zip(got[1], twin[1])):
        raise AssertionError("key_encode differs from the twin at a main-path shape")
    ms = _median_ms(lambda: TK.key_encode_cuda(*captured[0]))
    plain = _median_ms(lambda: TK.key_encode_reference(*captured[0]), 5)
    dev = [(k, o) for k, o in zip(kinds, keys) if k != "code"]
    read = _nbytes(*masks) + sum(_nbytes(*o) for _k, o in dev)
    width = got[1][0].element_size() if got[1] else 8
    out = dict(rows=n, keys=list(kinds), code_bytes=width, ms=ms, plain_ms=plain,
               library_ms=None,
               library="none: coding several key kinds and folding three masks is no "
                       "one PyTorch call", max_abs_err=0.0)
    out.update(_bound(read + 4 * n + width * n * len(dev)))
    return out


def _time_keyed_sort(TK, captured) -> dict:
    """K1 + the gid kernel (the reference's _keyed_sort_fn) against their
    twins; the yardstick is torch.unique(dim=0, return_inverse=True) over
    the stacked operands, the same group ids from one call."""
    import torch

    (inv, keys), _ = captured
    keys = list(keys)
    perm = TK.radix_argsort_cuda([inv] + keys)
    got = TK.keyed_gids_cuda(perm, inv, keys)
    twin_perm = TK.radix_argsort_reference([inv] + keys)
    twin = TK.keyed_gids_reference(twin_perm, inv, keys)
    ng = int(twin["counts"][0])
    if not (torch.equal(perm, twin_perm) and torch.equal(got["counts"], twin["counts"])
            and torch.equal(got["s2"], twin["s2"])
            and torch.equal(got["gid_in"], twin["gid_in"])
            and all(torch.equal(a, b) for a, b in zip(got["sk"], twin["sk"]))
            and torch.equal(got["starts"][:ng + 1], twin["starts"][:ng + 1])):
        raise AssertionError("keyed sort differs from the twin at a main-path shape")

    def kernel():
        p = TK.radix_argsort_cuda([inv] + keys)
        TK.keyed_gids_cuda(p, inv, keys)

    def plain():
        TK.keyed_gids_reference(TK.radix_argsort_reference([inv] + keys), inv, keys)

    n = inv.numel()
    stacked = torch.stack([inv.long()] + [k.long() for k in keys], dim=1)
    library = _median_ms(lambda: torch.unique(stacked, dim=0, return_inverse=True), 5)
    sort = lambda: TK.radix_argsort_cuda([inv] + keys)  # noqa: E731
    out = dict(rows=n, keys=len(keys), groups=ng, ms=_median_ms(kernel),
               burst_ms=_burst_ms(kernel), k1_ms=_median_ms(sort), k1_burst_ms=_burst_ms(sort),
               gids_burst_ms=_burst_ms(lambda: TK.keyed_gids_cuda(perm, inv, keys)),
               plain_ms=_median_ms(plain, 5), library_ms=library,
               radix_passes=TK.radix_sort_pass_count([inv] + keys), max_abs_err=0.0)
    out.update(_bound(_nbytes(inv, *keys) + 12 * n + _nbytes(*keys) + 4 * (ng + 1)))
    return out


def _finish_gathered(columns) -> list:
    """The arrays the finish gathers through perm: each column's values,
    validity and second half."""
    return [a for c in columns for a in (c.values, c.valid, c.values2) if a is not None]


def _burst_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """The card's ms a call of ``fn``: CUDA events around ``calls`` calls
    launched back to back (the host runs ahead, so the host's time a call
    hides behind the card's), per call, median of ``reps``."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def _finish_split(fn, burst_ms: float, reps: int = 10) -> dict:
    """Device ms a call of ``fn`` by kernel, from torch.profiler's records:
    the finish's kernels, K2's three passes and the unfold by name, every
    other kernel or copy (PyTorch's fills and copies) as "torch".  Not
    measured (None) where the records sum to less than half of
    ``burst_ms``: late in a long run the profiler has been seen to drop
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        if t:
            name = next((k for k in FINISH_KERNELS if k in e.key), "torch")
            out[name] = out.get(name, 0.0) + t / reps / 1e3
    if sum(out.values()) < 0.5 * burst_ms:
        print(f"keyed_finish split: the profiler recorded {sum(out.values())!r} ms of "
              f"{burst_ms!r} (not measured)")
        return {"device_ms": None}
    out["device_ms"] = sum(out.values())
    return out


def finish_timing(TK, args, x32: bool, what: str) -> dict:
    """The finish against its twin (f64 sums within REL, x32 pair sums
    within X32_REL, every other word bit for bit; two launches
    bit-identical), then timed: CUDA events (``ms``), the card's time a
    call with the host ahead (``burst_ms``) and its split by
    torch.profiler, one ``index_select`` through perm of every gathered
    array (``gather_ms``: the gather without packed records), and one
    ``index_add_`` of the sum columns by group id (``library_ms``)."""
    import torch

    specs, columns, field_col, ops, perm, gids, ng, cap = args[:8]
    cuda = TK.keyed_finish_x32_cuda if x32 else TK.keyed_finish_cuda
    twin_fn = TK.keyed_finish_x32_reference if x32 else TK.keyed_finish_reference
    runs = [cuda(*args) for _ in range(2)]
    twin = twin_fn(*args)
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError(f"{what}: two launches differ")
    if x32:
        err = _x32_rows_close(TK, runs[0], twin, ops, what)
    else:
        err = _words_close(runs[0], twin, {f for f, op in enumerate(ops)
                                           if op == TK.OP_ADD_F64})
    del runs
    n = perm.numel()
    arrays = _finish_gathered(columns)
    p = perm.long()
    gather_ms = _median_ms(lambda: [a.index_select(0, p) for a in arrays])
    sum_op = TK.OP_DF32 if x32 else TK.OP_ADD_F64
    sums = [c for c in columns if c.op == sum_op]
    library = None
    if sums:
        gid = gids["gid_in"].long()
        g = torch.where(gid < cap, gid, torch.full_like(gid, cap))
        dt = torch.float32 if x32 else torch.float64
        V = torch.stack([c.values.to(dt) if c.valid is None
                         else torch.where(c.valid, c.values.to(dt), 0.0) for c in sums], 1)
        acc = torch.zeros(cap + 1, V.shape[1], dtype=dt, device=V.device)
        library = _median_ms(lambda: acc.index_add_(0, g, V))
    word = 4 if x32 else 8
    n_keys = twin.shape[0] - len(ops)
    read = _nbytes(perm, gids["s2"]) + _nbytes(*arrays) + 4 * (ng + 1)
    read += word * n_keys * ng  # each group's key codes
    burst = _burst_ms(lambda: cuda(*args))
    out = dict(rows=n, capacity=cap, groups=ng, fields=len(ops), columns=len(columns),
               gathered=len(arrays), passes=len(TK._finish_passes(columns)),
               ms=_median_ms(lambda: cuda(*args)), burst_ms=burst,
               split=_finish_split(lambda: cuda(*args), burst),
               plain_ms=_median_ms(lambda: twin_fn(*args), 5),
               library_ms=library, gather_ms=gather_ms, max_abs_err=err)
    out.update(_bound(read + _nbytes(twin)))
    return out


def _time_keyed_finish(TK, captured) -> dict:
    """The finish at a main-path shape (:func:`finish_timing`)."""
    return finish_timing(TK, captured[0], False, "keyed_finish main path")


def finish_gids(name: str, n: int, rng) -> tuple:
    """``(inv, group key)`` numpy operands of a finish shape over n rows, a
    tenth masked: "uniform" 10,000 ids, "skew" 4, "zipf" Zipf 1.1 over
    10,000 (:func:`zipf_gid`), "one_row" every row its own group, "skew90"
    one id holding 90% of the rows, "full" 4,096 ids all present (the
    capacity), "sparse" 100 ids (at capacity 2^16), "masked" every row
    masked."""
    inv = (rng.random(n) < 0.1).astype(np.int32)
    if name == "uniform":
        key = rng.integers(0, 10_000, n)
    elif name == "skew":
        key = rng.integers(0, 4, n)
    elif name == "zipf":
        key = zipf_gid(n, 10_000, 1.1, int(rng.integers(1 << 30)))
    elif name == "one_row":
        key = rng.permutation(n)
    elif name == "skew90":
        key = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 1000, n))
    elif name == "full":
        key = rng.permutation(np.arange(n) % 4096)
        inv[:] = 0
    elif name == "sparse":
        key = rng.integers(0, 100, n) * 997
    elif name == "masked":
        key = rng.integers(0, 50, n)
        inv[:] = 1
    else:
        raise ValueError(f"finish shape {name}")
    return inv, key.astype(np.int32)


def finish_case(TK, name: str, n: int, x32: bool, device, seed: int = 0) -> tuple:
    """The finish's arguments at a :func:`finish_gids` shape: the keyed
    sort of its operands, then x64's sum, min and max of an f64 and an
    int64 column with their counts (9 scan columns: three passes), or
    x32's pair sum, order-pair min, f32 max and i32 max with their counts
    (7 columns: two passes).  The f64 values carry NaN, +-inf and +-0.0 in a few groups."""
    import torch

    from arrow_ballista_tpu_torch.ops.bridge import split_u64_i32, to_u64_order

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    inv, key = finish_gids(name, n, rng)
    if n:
        perm, gids, ng = TK.keyed_sort(t(inv), [t(key)])
    else:  # no rows: the twin's (empty) sort
        perm = t(np.zeros(0, np.int32))
        gids = TK.keyed_gids_reference(perm, t(inv), [t(key)])
        ng = 0
    cap = 1 << 16 if name == "sparse" else max(64, 1 << (max(ng, 1) - 1).bit_length())
    v = np.round(rng.normal(0, 50, n), 3)
    for special in (np.nan, np.inf, -np.inf, -0.0, 0.0):
        v[rng.integers(0, max(n, 1), max(3, n // 50_000) if n else 0)] = special
    vok = t(rng.random(n) > 0.1)
    wok = t(rng.random(n) > 0.05)
    KS = TK.KernelAggSpec
    if not x32:
        specs = [KS("count_star", False), KS("sum", True), KS("min", True), KS("max", True),
                 KS("sum", True, int_sum=True), KS("min", True, int_minmax=True),
                 KS("max", True, int_minmax=True)]
        ops = [TK.OP_COUNT, TK.OP_ADD_F64, TK.OP_COUNT, TK.OP_MIN_F64, TK.OP_COUNT,
               TK.OP_MAX_F64, TK.OP_COUNT, TK.OP_ADD_I64, TK.OP_COUNT, TK.OP_MIN_I64,
               TK.OP_COUNT, TK.OP_MAX_I64, TK.OP_COUNT, TK.OP_COUNT]
        cols = [-1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, -1]
        w = t(rng.integers(-(1 << 40), 1 << 40, n))
        columns, field_col = TK._build_scan_plan([t(v), w], [vok, wok], ops, cols)
        return (specs, columns, field_col, ops, perm, gids, ng, cap)
    hi = v.astype(np.float32)
    lo = np.zeros(n, np.float32)
    fin = np.isfinite(v)
    lo[fin] = v[fin] - hi[fin].astype(np.float64)
    ohi, olo = split_u64_i32(to_u64_order(v))
    wi = t(rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32))
    specs = [KS("count_star", False), KS("sum", True), KS("min", True, ord_pair=True),
             KS("max", True), KS("max", True, int_minmax=True)]
    SC = TK.ScanColumn
    columns = [SC(TK.SS_VALUES, TK.OP_DF32, values=t(hi), valid=vok, values2=t(lo)),
               SC(TK.SS_COUNT, TK.OP_ADD_I64),
               SC(TK.SS_COUNT, TK.OP_ADD_I64, valid=vok),
               SC(TK.SS_VALUES, TK.OP_UMIN_U64, values=t(ohi), valid=vok, values2=t(olo)),
               SC(TK.SS_VALUES, TK.OP_MAX_F64, values=t(hi), valid=vok),
               SC(TK.SS_VALUES, TK.OP_MAX_I64, values=wi, valid=wok),
               SC(TK.SS_COUNT, TK.OP_ADD_I64, valid=wok)]
    field_col = [1, 0, 0, 2, 3, 3, 2, 4, 2, 5, 6, 1]
    return (specs, columns, field_col, TK.x32_merge_ops(specs), perm, gids, ng, cap)


def finish_phase(TK, device) -> dict:
    """Both forms of the finish at FINISH_ROWS rows in the uniform, skew
    and Zipf shapes (:func:`finish_case`), against the twins and timed
    (:func:`finish_timing`); the skew shape's device time beside the
    uniform one's."""
    import torch

    t0 = time.perf_counter()
    out: dict = {}
    for x32 in (False, True):
        for i, name in enumerate(FINISH_SHAPES):
            what = ("x32 " if x32 else "") + name
            args = finish_case(TK, name, FINISH_ROWS, x32, device, seed=70 + i)
            out[what] = finish_timing(TK, args, x32, "keyed_finish " + what)
            print(f"keyed_finish {what}: {json.dumps(out[what])}")
            del args
            torch.cuda.empty_cache()
        pre = "x32 " if x32 else ""
        dev = {k: out[pre + k]["burst_ms"] for k in ("uniform", "skew")}
        print(f"keyed_finish {pre}skew against uniform: "
              f"{dev['skew'] / dev['uniform']!r} of the card's time")
    print(f"keyed_finish phase: ok s={time.perf_counter() - t0!r}")
    return out


def _time_keyed_median(TK, captured) -> dict:
    import torch

    args, _ = captured
    got, twin = TK.keyed_median_cuda(*args), TK.keyed_median_reference(*args)
    if not torch.equal(got, twin):
        raise AssertionError("keyed_median differs from the twin at a main-path shape")
    inv, keys, ohi, olo, ovalid, cap = args[:6]
    out = dict(rows=inv.numel(), keys=len(keys), capacity=cap, out_dtype=str(got.dtype),
               ms=_median_ms(lambda: TK.keyed_median_cuda(*args)),
               plain_ms=_median_ms(lambda: TK.keyed_median_reference(*args), 5),
               library_ms=None,
               library="none: torch.median has no segmented form; a per-group median "
                       "is this sort and gather",
               max_abs_err=0.0)
    out.update(_bound(_nbytes(inv, *keys, ohi, olo, ovalid) + _nbytes(got)))
    return out


def _time_keyed_corr(TK, captured) -> dict:
    args, _ = captured
    got, twin = TK.keyed_corr_cuda(*args), TK.keyed_corr_reference(*args)
    err = _words_close(got, twin, (0, 1, 2))
    s2, perm, gid_in, x, xv, y, yv, cap = args
    n = perm.numel()
    out = dict(rows=n, capacity=cap, ms=_median_ms(lambda: TK.keyed_corr_cuda(*args)),
               plain_ms=_median_ms(lambda: TK.keyed_corr_reference(*args), 5),
               library_ms=None,
               library="none: torch.corrcoef takes one dense matrix, not a "
                       "correlation per group of sorted rows",
               max_abs_err=err)
    out.update(_bound(_nbytes(s2, perm, gid_in, x, xv, y, yv) + _nbytes(got),
                      f64_ops=14 * n))
    return out


def _entries_io_bytes(kinds, entries, out_keys) -> int:
    """Bytes the entry-wise encode must move: every entry's masks, key
    values and validities read once, inv and the sort keys written once."""
    total = 0
    for keys, masks, _n in entries:
        total += _nbytes(*masks) + sum(_nbytes(*ops) for ops in keys)
    return total + _nbytes(*out_keys)


def _encode_library(TK, kinds, entries, code_dtype):
    """The nearest composition of existing calls, the unfused route's: one
    ``key_encode`` launch an entry, then ``torch.cat`` of the operands."""
    import torch

    parts = [TK.key_encode_cuda(kinds, keys, masks, n, keys[0][0].device, code_dtype)
             for keys, masks, n in entries]
    return (torch.cat([p[0] for p in parts]),
            [torch.cat([p[1][k] for p in parts]) for k in range(len(kinds))])


def check_encode_entries(TK, kinds, entries, fold, code_dtype, reps: int = 20) -> dict:
    """``keyed_encode_entries`` against its twin bit for bit (two kernel
    runs), timed beside its bound, its twin and the per-entry encode +
    ``torch.cat`` (``per_entry_ms``); K1's pass count over the operands it
    writes and over the unfolded ones."""
    import torch

    runs = [TK.keyed_encode_entries_cuda(kinds, entries, fold, code_dtype) for _ in range(2)]
    twin = TK.keyed_encode_entries_reference(kinds, entries, fold, code_dtype)
    for inv, keys in runs:
        if not torch.equal(inv, twin[0]) or len(keys) != len(twin[1]) or not all(
                a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(keys, twin[1])):
            raise AssertionError(f"keyed_encode_entries differs from the twin (fold {fold})")
    inv, keys = runs[0]
    lib_inv, lib_codes = _encode_library(TK, kinds, entries, code_dtype)
    if not torch.equal(lib_inv, inv):
        raise AssertionError("keyed_encode_entries: inv differs from per-entry key_encode")
    if fold is None and not all(torch.equal(a, b) for a, b in zip(lib_codes, keys)):
        raise AssertionError("keyed_encode_entries: codes differ from per-entry key_encode")
    out = dict(
        rows=int(inv.numel()), entries=len(entries), keys=list(kinds),
        fold=None if fold is None else [list(f) for f in fold],
        ms=_median_ms(lambda: TK.keyed_encode_entries_cuda(kinds, entries, fold, code_dtype),
                      reps),
        plain_ms=_median_ms(
            lambda: TK.keyed_encode_entries_reference(kinds, entries, fold, code_dtype), 5),
        library_ms=None,
        library="none: no PyTorch call codes several key kinds, folds row masks or folds "
                "keys; per_entry_ms is the nearest composition",
        per_entry_ms=_median_ms(lambda: _encode_library(TK, kinds, entries, code_dtype),
                                reps),
        k1_passes=TK.radix_sort_pass_count([inv] + keys),
        k1_passes_unfolded=TK.radix_sort_pass_count([lib_inv] + lib_codes),
        max_abs_err=0.0,
    )
    out.update(_bound(_entries_io_bytes(kinds, entries, [inv] + keys)))
    return out


def check_unfold(TK, sk, starts, ng: int, fold, out_like, want=None) -> dict:
    """``keyed_unfold`` against its twin (and, where given, the key rows
    of the unfolded sort), bit for bit, timed beside its bound and its
    twin."""
    import torch

    def run(fn):
        return fn(sk, starts, ng, fold, torch.empty_like(out_like))

    got = [run(TK.keyed_unfold_cuda) for _ in range(2)]
    twin = run(TK.keyed_unfold_reference)
    if not (torch.equal(got[0], got[1]) and torch.equal(got[0], twin)):
        raise AssertionError("keyed_unfold differs from the twin")
    if want is not None and not torch.equal(got[0], want):
        raise AssertionError("keyed_unfold differs from the unfolded sort's key rows")
    out = dict(groups=ng, capacity=int(out_like.shape[1]), keys=len(fold),
               ms=_median_ms(lambda: run(TK.keyed_unfold_cuda)),
               plain_ms=_median_ms(lambda: run(TK.keyed_unfold_reference), 5),
               library_ms=None,
               library="none: a gather and shifts a key; the unfolded route's key gather "
                       "is this repo's own kernel",
               max_abs_err=0.0)
    out.update(_bound(8 * ng + _nbytes(out_like)))  # starts and words read, rows written
    return out


def _time_encode_entries(TK, captured) -> dict:
    (kinds, entries, fold, code_dtype), _ = captured
    return check_encode_entries(TK, kinds, entries, fold, code_dtype)


def _time_unfold(TK, captured) -> dict:
    (sk, starts, ng, fold, out), _ = captured
    return check_unfold(TK, sk, starts, ng, fold, out)


FOLD_CASES = ("h2o q6 keys", "h2o q9 keys", "h2o q10 keys", "x32 wrapped words")


def _fold_case(TK, TSC, case: str, device):
    """(kinds, entries, fold, code dtype) of one kernel-phase case: H2O_ROWS
    rows in an H2O_BATCH_ROWS entry and the rest (the h2o legs' two
    batches), keys drawn like
    ``gen_groupby``'s (1..100 int32 keys, 100 and 1e5 int32 host codes), and the
    fold plan the stage computes from the entries' spans."""
    import torch

    rng = np.random.default_rng(FOLD_CASES.index(case) + 51)
    sizes = (H2O_BATCH_ROWS, H2O_ROWS - H2O_BATCH_ROWS)
    x32 = case.startswith("x32")
    dt = torch.int32 if x32 else torch.int64
    hi = H2O_ROWS // H2O_K

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def ident(n, top):
        return rng.integers(1, top + 1, n).astype(np.int32), None

    def code(n, card):
        # a string key's dictionary codes ship as int32, as on the h2o legs
        c = rng.integers(0, card, n).astype(np.int32)
        if x32:  # host codes near 2^32 ship as negative words
            c = ((c.astype(np.int64) + (1 << 32) - card) & 0xFFFFFFFF).astype(
                np.uint32).view(np.int32)
        return (c,)

    layout = {"h2o q6 keys": (("ident", H2O_K), ("ident", H2O_K)),
              "h2o q9 keys": (("code", H2O_K), ("ident", H2O_K)),
              "h2o q10 keys": (("code", H2O_K), ("code", H2O_K), ("code", hi),
                               ("ident", H2O_K), ("ident", H2O_K), ("ident", hi)),
              "x32 wrapped words": (("code", H2O_K), ("ident", H2O_K))}[case]
    kinds = tuple(k for k, _c in layout)
    ks: dict = {}
    entries = []
    for n in sizes:
        keys = []
        for slot, (kind, card) in enumerate(layout):
            ops = ident(n, card) if kind == "ident" else code(n, card)
            span = (TSC._zigzag_span(ops[0], None, x32) if kind == "ident"
                    else (int(ops[0].min()), int(ops[0].max())))
            TSC._note_range(ks, slot, span)
            keys.append(tuple(None if a is None else t(a) for a in ops))
        masks = (None, t(rng.random(n) > 0.1), None) if x32 else (None, None, None)
        entries.append((tuple(keys), masks, n))
    return kinds, entries, TSC._radix_combine_bits(ks, len(kinds)), dt


def keyed_fold_phase(TK, device) -> dict:
    """B7c's kernels against their twins on FOLD_CASES: the entry-wise
    encode folded (q6's and q9's keys, the x32 case) and per key (q10's
    six keys decline the fold; the folded cases run that form too), and,
    after K1 and the gid kernel over ``[inv, comb]`` (timed beside the same
    over ``[inv, *codes]``), the unfold against its twin and against the
    key rows of the unfolded sort."""
    import torch

    from arrow_ballista_tpu_torch.ops import stage_compiler as TSC

    t0 = time.perf_counter()
    out: dict = {}
    for case in FOLD_CASES:
        kinds, entries, fold, dt = _fold_case(TK, TSC, case, device)
        if (fold is not None) != (case != "h2o q10 keys"):
            raise AssertionError(f"{case}: fold plan {fold}")
        out[f"encode {case}"] = check_encode_entries(TK, kinds, entries, fold, dt)
        if fold is None:
            continue
        out[f"encode {case} unfolded"] = check_encode_entries(TK, kinds, entries, None, dt)
        inv, (comb,) = TK.keyed_encode_entries_cuda(kinds, entries, fold, dt)
        _inv, codes = TK.keyed_encode_entries_cuda(kinds, entries, None, dt)
        perm, gids, ng = TK.keyed_sort(inv, [comb])
        uperm, ugids, ung = TK.keyed_sort(inv, codes)
        if ng != ung or not torch.equal(perm, uperm):
            raise AssertionError(f"{case}: the folded sort's order differs")
        # K1 + the gid kernel over the folded word and over the codes
        out[f"encode {case}"].update(
            k1_gids_ms=_median_ms(lambda: TK.keyed_sort(inv, [comb])),
            k1_gids_unfolded_ms=_median_ms(lambda: TK.keyed_sort(inv, codes)))
        cap = max(64, 1 << (max(ng, 1) - 1).bit_length())
        rows = torch.empty((len(kinds), cap), dtype=dt, device=device)
        want = TK.keyed_keys_reference(ugids["sk"], ugids["starts"], ng,
                                       torch.empty_like(rows))
        out[f"unfold {case}"] = check_unfold(TK, gids["sk"][0], gids["starts"], ng, fold,
                                             rows, want)
        del inv, comb, codes, perm, gids, uperm, ugids
    for k, v in out.items():
        print(f"keyed fold {k}: {json.dumps(v)}")
    print(f"keyed fold phase: ok s={time.perf_counter() - t0!r}")
    return out


def keyed_timing(TK, legs: dict) -> dict:
    """B7-B10 at each keyed leg's first main-path call: checked against
    the twins, timed, beside their bounds."""
    out: dict = {}
    for leg, r in legs.items():
        caps = r["caps"]
        for name, fn, cap in (("key_encode", _time_key_encode, "key_encode_cuda"),
                              ("keyed_encode_entries", _time_encode_entries,
                               "keyed_encode_entries_cuda"),
                              ("keyed_unfold", _time_unfold, "keyed_unfold_cuda"),
                              ("keyed_gids", _time_keyed_sort, "keyed_sort"),
                              ("keyed_finish", _time_keyed_finish, "keyed_finish_cuda"),
                              ("keyed_median", _time_keyed_median, "keyed_median_cuda"),
                              ("keyed_corr", _time_keyed_corr, "keyed_corr_cuda")):
            if caps.get(cap) is not None:
                t = fn(TK, caps[cap])
                out.setdefault(name, {})[leg] = t
                print(f"timing {name} {leg}: {json.dumps(t)}")
    return out


# the x32 window kernel's specs and inputs (the CPU tests hold the twin to
# the reference with them, the card tests the kernel to the twin)
X32_WINDOW_SPECS = (
    ("row_number",), ("rank",), ("dense_rank",), ("ntile", 3),
    ("agg", "sum", 0), ("agg", "avg", 2), ("agg", "min", 1), ("agg", "max", 3),
    ("agg", "count", 0), ("agg", "count", None),
    ("aggf", "sum", 0, -3, 0), ("aggf", "avg", 2, -2, 1), ("aggf", "min", 1, -5, 0),
    ("aggf", "max", 3, None, 0), ("aggf", "count", None, -2, 0),
    ("val", "lag", 1, 2), ("val", "lead", 3, 1), ("val", "first_value", 0, 0),
    ("val", "last_value", 1, 0),
)


def x32_window_inputs(seed: int, n: int = 3000):
    """(partition keys, order keys, arguments) of an x32 window signature
    as the compiler builds them: (hi, lo) int32 key pairs behind the pad
    flag; f32, f32, an integer's exact (hi, lo) f32 pair, int32 args."""
    from arrow_ballista_tpu_torch.ops.bridge import split_u64_i32, to_u64_order

    rng = np.random.default_rng(seed)
    part = rng.integers(0, 20, n).astype(np.int64)
    order = rng.integers(0, 300, n).astype(np.int64)
    pkeys = [np.zeros(n, np.int32)] + list(split_u64_i32(to_u64_order(part)))
    okeys = [np.zeros(n, np.int32)] + list(split_u64_i32(to_u64_order(order)))
    x = rng.uniform(0.5, 50, n).astype(np.float32)
    f = rng.uniform(-3, 3, n).astype(np.float32)
    w = rng.integers(-(2**40), 2**40, n).astype(np.float64)
    wh = w.astype(np.float32)
    wl = (w - wh.astype(np.float64)).astype(np.float32)
    i = rng.integers(-1000, 1000, n).astype(np.int32)
    valid = [rng.random(n) > 0.1 for _ in range(4)]
    args = [(x, valid[0]), (f, valid[1]), ((wh, wl), valid[2]), (i, valid[3])]
    return pkeys, okeys, args


def x32_window_float_rows(specs, args) -> dict:
    """Packed row -> "pair" (the first of a sum's hi, lo words), "f32" (an
    f32 value) or "ext" (an int32 extremum, masked where its count is 0)."""
    out, r = {}, 0
    for s in specs:
        kind = s[0]
        if kind in ("row_number", "rank", "dense_rank", "ntile"):
            r += 1
        elif kind in ("agg", "aggf") and (s[2] is None or s[1] == "count"):
            r += 1
        elif kind == "agg" and s[1] in ("sum", "avg"):
            out[r] = "pair"
            r += 3
        elif kind == "aggf" and s[1] in ("sum", "avg"):
            out[r] = out[r + 2] = "pair"
            r += 5
        elif kind in ("agg", "aggf"):  # min / max
            out[r] = "f32" if np.asarray(args[s[2]][0]).dtype == np.float32 else "ext"
            r += 2
        else:  # val
            if np.asarray(args[s[2]][0]).dtype == np.float32:
                out[r] = "f32"
            r += 2
    return out


# ------------------------------------------------------------ x32 forms
SQPAIR_RANDOM_ROWS = 1 << 20  # beside the edge grid: random normal pairs


def sqpair_edge_grid():
    """(hi, lo) float32 pairs at B12f's edges: zeros, NaN, infinities, the
    overflow of hi² past about 1.8e19, the Veltkamp split's past about
    8.3e34, the f32 extremes, subnormals, each beside a lo of every
    kind."""
    his = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -3.0, 1.8e19, 1.84e19,
                    1.85e19, -1.9e19, 1e20, 8.2e34, 8.4e34, 1.7e38, 3.4028235e38,
                    -3.4028235e38, 1.17549435e-38, 1e-45, 1e-20, 16777217.0, 123456.789],
                   np.float32)
    los = np.array([0.0, -0.0, 1e-3, -2.5e-8, 1e-30, 1e-42, np.nan, np.inf], np.float32)
    return np.repeat(his, len(los)), np.tile(los, len(his))


def sqpair_program(TK):
    """B3's program of the square pair of one f64 column's exact f32 pair
    (p: ``square`` of hi, e: ``sqpair_lo`` of hi and lo), as a variance
    stage lowers it."""
    import pyarrow as pa

    from arrow_ballista_tpu_torch.exec import expressions as tpe

    comp = TK.TorchExprCompiler(pa.schema([("x", pa.float64())]), "x32")
    sq = TK.square_pair_closure(comp.pair_column(tpe.Col(0, "x")))
    return TK.ExprProgram(None, list(sq.halves), [(0, TK.F32), (1, TK.F32)], mode="x32")


def sqpair_diff(a, b):
    """None when two lists of float32 arrays agree bit for bit, NaN
    matching NaN (the card and the CPU give NaN other payloads), else what
    differs."""
    for k, (x, y) in enumerate(zip(a, b)):
        nan = np.isnan(x)
        if not np.array_equal(nan, np.isnan(y)):
            return f"output {k}: NaN positions differ"
        xs, ys = x[~nan], y[~nan]
        bad = np.nonzero(xs.view(np.int32) != ys.view(np.int32))[0]
        if bad.size:
            return f"output {k}: {bad.size} rows differ, e.g. {xs[bad[:3]]} vs {ys[bad[:3]]}"
    return None


def sqpair_edge_check(TK, device) -> dict:
    """B12f's opcode against its twin on the card over the edge grid and
    SQPAIR_RANDOM_ROWS random normal pairs: bit-identical, NaN as NaN."""
    import torch

    hi, lo = sqpair_edge_grid()
    rng = np.random.default_rng(31)
    x = rng.uniform(-1, 1, SQPAIR_RANDOM_ROWS) * 10.0 ** rng.uniform(-6, 9, SQPAIR_RANDOM_ROWS)
    rh = x.astype(np.float32)
    hi = np.concatenate([hi, rh])
    lo = np.concatenate([lo, (x - rh.astype(np.float64)).astype(np.float32)])
    n = len(hi)
    program = sqpair_program(TK)
    env = {"col_0__pair__hi": torch.from_numpy(hi).to(device),
           "col_0__pair__lo": torch.from_numpy(lo).to(device), "col_0__pair__valid": None}
    got = TK.expr_eval_cuda(program, env, n, device)[2]
    twin = TK.expr_program_reference(program, env, n, device)[2]
    diff = sqpair_diff([g.cpu().numpy() for g in got], [t.cpu().numpy() for t in twin])
    if diff is not None:
        raise AssertionError(f"B12f square pair against its twin on the edge grid: {diff}")
    moved = 4 * n * 4
    return dict(rows=n, edge_pairs=n - SQPAIR_RANDOM_ROWS, max_abs_err=0.0,
                ms=_median_ms(lambda: TK.expr_eval_cuda(program, env, n, device)),
                plain_ms=_median_ms(lambda: TK.expr_program_reference(program, env, n, device)),
                library_ms=None, **_bound(moved))


def _x32_rows_close(TK, got, twin, ops, what: str) -> float:
    """x32 state rows (then key rows): a double-float pair's hi + lo within
    X32_REL (NaN matching NaN), every other row bit for bit."""
    g, t = got.cpu().numpy(), twin.cpu().numpy()
    if g.shape != t.shape or g.dtype != t.dtype:
        raise AssertionError(f"{what}: {g.dtype}{g.shape} vs {t.dtype}{t.shape}")
    worst = 0.0
    for r in range(g.shape[0]):
        op = ops[r] if r < len(ops) else None
        if op == TK.XM_SUM_HI:
            gs = g[r].view(np.float32).astype(np.float64) + g[r + 1].view(np.float32)
            ts = t[r].view(np.float32).astype(np.float64) + t[r + 1].view(np.float32)
            if not np.array_equal(np.isnan(gs), np.isnan(ts)):
                raise AssertionError(f"{what} row {r}: NaN positions differ")
            if not np.array_equal(gs[np.isinf(ts)], ts[np.isinf(ts)]):
                raise AssertionError(f"{what} row {r}: infinities differ")
            ok = np.isfinite(ts)
            diff = np.abs(gs[ok] - ts[ok])
            if diff.size:
                worst = max(worst, float(diff.max()))
            if np.any(~(diff <= X32_REL * np.abs(ts[ok]))):
                raise AssertionError(f"{what} row {r}: off by {diff.max()!r}")
        elif op != TK.XM_SUM_LO and not np.array_equal(g[r], t[r]):
            raise AssertionError(f"{what} row {r}: words differ")
    return worst


def _time_keyed_finish_x32(TK, captured) -> dict:
    """x32's finish at a main-path shape (:func:`finish_timing`)."""
    return finish_timing(TK, captured[0], True, "keyed_finish x32 main path")


def _time_keyed_corr_x32(TK, captured) -> dict:
    args, _ = captured
    got, twin = TK.keyed_corr_x32_cuda(*args), TK.keyed_corr_x32_reference(*args)
    err = _x32_rows_close(TK, got, twin, [TK.XM_SUM_HI, TK.XM_SUM_LO] * 3 + [None],
                          "keyed_corr x32")
    s2, perm, gid_in, xh, xl, xv, yh, yl, yv, cap = args
    n = perm.numel()
    out = dict(rows=n, capacity=cap, ms=_median_ms(lambda: TK.keyed_corr_x32_cuda(*args)),
               plain_ms=_median_ms(lambda: TK.keyed_corr_x32_reference(*args), 5),
               library_ms=None,
               library="none: torch.corrcoef takes one dense matrix, not a "
                       "correlation per group of sorted rows",
               max_abs_err=err)
    out.update(_bound(_nbytes(s2, perm, gid_in, xh, xl, xv, yh, yl, yv) + _nbytes(got)))
    return out


def x32_forms_phase(TK, WK, legs: dict, device) -> dict:
    """The x32 forms of the keyed, join, window and exchange kernels, and
    B12f, at the first shape the x32 legs gave each, against their twins,
    timed beside their bounds: ``{kernel name: {shape: timing}}``."""
    from arrow_ballista_tpu_torch.parallel import mesh as TM

    t0 = time.perf_counter()
    out: dict = {}

    def put(name, shape, t):
        out.setdefault(name, {})[shape] = t
        print(f"timing {name} x32 {shape}: {json.dumps(t)}")

    (program, env, n, dev), _ = legs["q1 variance"]["captured"]["expr_eval_cuda"]
    put("expr_eval", "sqpair q1 variance", expr_check(TK, program, env, n, dev,
                                                      "x32 q1 variance"))
    put("expr_eval", "sqpair edge grid", sqpair_edge_check(TK, device))
    for leg in ("x32 h2o q6", "x32 h2o q9", "x32 h2o q10", "x32 q3 keyed"):
        caps = legs[leg]["caps"]
        for name, fn, cap in (("key_encode", _time_key_encode, "key_encode_cuda"),
                              ("keyed_encode_entries", _time_encode_entries,
                               "keyed_encode_entries_cuda"),
                              ("keyed_unfold", _time_unfold, "keyed_unfold_cuda"),
                              ("keyed_gids", _time_keyed_sort, "keyed_sort"),
                              ("keyed_finish", _time_keyed_finish_x32, "keyed_finish_x32_cuda"),
                              ("keyed_median", _time_keyed_median, "keyed_median_cuda"),
                              ("keyed_corr", _time_keyed_corr_x32, "keyed_corr_x32_cuda")):
            if caps.get(cap) is not None:
                put(name, leg[4:], fn(TK, caps[cap]))
    star = legs["x32 star"]
    put("join_probe", "star", _checked_probe(TK, star["probe"]))
    put("join_build_table", "star", _checked_build(TK, *star["build"][0]))
    win = legs["x32 window"]
    put("radix_sort", "window", _checked_sort(TK, win["sort"]))
    put("seg_scan", "window", _checked_scan(TK, win["scan"]))
    put("range_extremum", "window", _checked_extremum(WK, win["rx"]))
    put("window_epilogue", "window pack", _time_pack(WK, win["pack"]))
    put("window_epilogue", "window flags", _time_flags(WK, win["flags"]))
    put("mesh_route", "dist. q3 mesh (its largest call)",
        _time_route(TM, *legs["x32 dist. q3 mesh"]["route"][0]))
    print(f"x32 forms phase: ok s={time.perf_counter() - t0!r}")
    return out


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
    (keys,), _ = captured
    _checked_same(TK, keys, "main-path shape")
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
    t_start = time.perf_counter()

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
    print(f"smoke: total s={time.perf_counter() - t_start!r}")
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
    entries_err, entries_times = entries_phase(TK, device)
    b1_split = b1_split_phase(TK, device)
    sort_times = sort_phase(TK, device)
    scan_times, rx_times, epilogue_times = scan_phase(TK, WK, device)
    scan_err = max(t["max_abs_err"] for t in scan_times.values())
    pid_times = pid_phase(TK, device)
    probe_times, build_times = join_phase(TK, device)
    mesh_times = mesh_phase(TK, device)
    fold_times = keyed_fold_phase(TK, device)
    finish_times = finish_phase(TK, device)
    t1 = time.perf_counter()
    expr_grid = expr_grid_phase(TK, device)
    print(f"expr_eval grid: {len(expr_grid)} cases bit-identical to the twin and the "
          f"closures s={time.perf_counter() - t1!r}")
    print(f"kernel phase: ok s={time.perf_counter() - t0!r}")

    batches = lineitem_batches(lineitem)
    del lineitem
    wants: dict = {}
    queries = query_phase(tbt, TK, batches, device, wants)
    expr_shapes = expr_query_check(
        TK, {q: r["cache_off"].pop("expr") for q, r in queries.items()}, device)
    for r in queries.values():
        for run_ in r.values():
            run_.pop("expr", None)
    # the multi-entry kernel at the cold runs' shapes, timed now so that
    # the captured entries (every closure output of the query) go early
    entry_shapes = {}
    for q, r in queries.items():
        (rows, ops, cols, state0), _ = r["cold"].pop("entries")
        r["warm"].pop("entries")
        entry_shapes[f"q{q}"] = entries_check(TK, rows, ops, cols, state0, split=q == 1)
        print(f"timing segment_agg_entries q{q} cold: {json.dumps(entry_shapes[f'q{q}'])}")
        del rows, state0
    x32_legs = x32_phase(tbt, TK, batches, wants, device)
    x32_times = x32_kernel_phase(TK, device, x32_legs)
    for name, leg_ in x32_legs.items():
        if name != "q1 variance":  # its program is checked with the x32 forms
            leg_.pop("captured")
    del wants
    q3 = q3_phase(tbt, TK, batches, orders, customer, device)
    q3_want = q3.pop("want")
    q3k = q3_keyed_phase(tbt, TK, batches, orders, customer, q3_want, device)
    q3k32 = q3_keyed_phase(tbt, TK, batches, orders, customer, q3_want, device, x32=True)
    del orders, customer, q3_want
    g1 = h2o_batches()
    h2o = h2o_phase(tbt, TK, g1, device)
    star = star_phase(tbt, TK, device)
    window = window_phase(tbt, TK, WK, batches[:WINDOW_BATCHES], device)
    del batches
    with parquet:
        dist = distributed_phase(tbt, TK, parquet.name, lineitem_rows, device)
        mesh_dist = mesh_dist_phase(tbt, TK, parquet.name, lineitem_rows, dist, device)
    for q in (1, 3):
        dist[q].pop("want")
    with tempfile.TemporaryDirectory(prefix="g1-parquet-") as g1_root:
        fusion = fusion_phase(tbt, TK, g1, g1_root, device)
    del g1
    runs = [*queries[1].values(), *queries[6].values(), q3, q3k, q3k32, *h2o.values(), star,
            star["x32"], window, window["x32"], dist[3], dist[1], fusion, mesh_dist[1],
            mesh_dist[3], mesh_dist["x32 q3"], *x32_legs.values()]
    launches = {k: sum(r["launches"][k] for r in runs) for k in KERNELS}

    shapes = {f"q{q}": time_shape(TK, r["cache_off"]["args"]) for q, r in queries.items()}
    shapes["distributed q1"] = time_shape(TK, dist[1].pop("b1"))
    (d_program, d_env, d_n, d_dev), _ = dist[1].pop("expr")
    expr_shapes["distributed q1"] = expr_check(TK, d_program, d_env, d_n, d_dev,
                                               "distributed q1's first call")
    del d_env
    dist[3].pop("expr")
    sort_shapes = {"q3": _checked_sort(TK, q3["sort"]),
                   "window": _checked_sort(TK, window["sort"]),
                   "distributed q3": _checked_sort(TK, dist[3]["sort"]),
                   "dist. q3 mesh": _checked_sort(TK, mesh_dist[3]["sort"])}
    route = _time_sort_route(TK, q3["route"])
    scan_shapes = {"window": _checked_scan(TK, window["scan"]), "q3_sort_route": route}
    rx_shape = _checked_extremum(WK, window["rx"])
    pack_shape = _time_pack(WK, window["pack"])
    flags_shape = _time_flags(WK, window["flags"])
    (pid_bits, pid_nulls, pid_n), _ = dist[3]["pids"]
    pid_shape = _time_pids(TK, pid_bits, pid_nulls, pid_n)
    probe_shapes = {"star": _checked_probe(TK, star["probe"]),
                    "distributed q3": _checked_probe(TK, dist[3]["probe"])}
    build_shapes = {name: _checked_build(TK, *r["build"][0])
                    for name, r in (("star", star), ("q3", q3), ("distributed q3", dist[3]))}
    keyed = keyed_timing(TK, {"h2o q6": h2o["q6"], "h2o q9": h2o["q9"],
                              "h2o q10": h2o["q10"], "q3 keyed": q3k})
    from arrow_ballista_tpu_torch.parallel import mesh as TM

    (red_specs, red_states), _ = mesh_dist[1]["reduce"]
    reduce_shape = _time_reduce(TM, red_specs, red_states)
    route_shape = _time_route(TM, *mesh_dist[3]["route"][0])
    forms = x32_forms_phase(TK, WK, {
        "q1 variance": x32_legs["q1 variance"], "x32 h2o q6": h2o["x32 q6"],
        "x32 h2o q9": h2o["x32 q9"], "x32 h2o q10": h2o["x32 q10"], "x32 q3 keyed": q3k32,
        "x32 star": star["x32"], "x32 window": window["x32"],
        "x32 dist. q3 mesh": mesh_dist["x32 q3"]}, device)
    del red_states, mesh_dist
    for name, t in [*shapes.items(), *(("radix_sort " + k, v) for k, v in sort_shapes.items()),
                    *(("seg_scan " + k, v) for k, v in scan_shapes.items()),
                    ("range_extremum window", rx_shape), ("window_pack window", pack_shape),
                    ("window_flags window", flags_shape),
                    ("partition_ids distributed q3", pid_shape),
                    *(("join_probe " + k, v) for k, v in probe_shapes.items()),
                    *(("join_build_table " + k, v) for k, v in build_shapes.items()),
                    *(("expr_eval " + k, v) for k, v in expr_shapes.items()),
                    ("mesh_reduce dist. q1 gang", reduce_shape),
                    ("mesh_route dist. q3 mesh (its largest call)", route_shape)]:
        print(f"timing {name}: {json.dumps(t)}")

    for name, t in expr_grid.items():
        print(f"timing expr_eval grid {name}: {json.dumps(t)}")
    # q1's largest shape (2^23 rows; a smaller --sf has a shorter first batch)
    expr_head = max((t for k, t in expr_shapes.items() if k.startswith("q1 ")),
                    key=lambda t: t["rows"])
    entries = [
        _entry("expr_eval", expr_head, launches["expr_eval"], 0.0,
               closures_ms=expr_head["closures_ms"], shapes=expr_shapes,
               kernel_phase={k: {f: t[f] for f in ("ms", "plain_ms", "closures_ms", "bound_ms")}
                             for k, t in expr_grid.items()}),
        _entry("segment_agg", shapes["q1"], launches["segment_agg"],
               max([kernel_err] + [s["max_abs_err"] for s in shapes.values()]),
               shapes=shapes, kernel_phase=kernel_times, sort_route=sorted_times,
               stand_ins={k: v for k, v in b1_split.items() if k != "q1 cold stand-in"}),
        _entry("segment_agg_entries", entry_shapes["q1"], launches["segment_agg_entries"],
               max([entries_err] + [t["max_abs_err"] for t in entry_shapes.values()]),
               b1_loop_ms=entry_shapes["q1"]["b1_loop_ms"], shapes=entry_shapes,
               kernel_phase=entries_times,
               stand_ins={"q1 cold stand-in": b1_split["q1 cold stand-in"]}),
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
        _entry("join_build_table", build_shapes["star"], launches["join_build_table"], 0.0,
               shapes=build_shapes, kernel_phase=build_times),
        _entry("join_probe", probe_shapes["star"], launches["join_probe"], 0.0,
               shapes=probe_shapes, kernel_phase=probe_times),
    ]
    for name, head in (("key_encode", "q3 keyed"), ("keyed_gids", "h2o q10"),
                       ("keyed_finish", "h2o q10"), ("keyed_median", "h2o q6"),
                       ("keyed_corr", "h2o q9"), ("keyed_encode_entries", "h2o q6"),
                       ("keyed_unfold", "h2o q6")):
        shapes_k = keyed[name]
        extra = {}
        if name in ("keyed_encode_entries", "keyed_unfold"):
            pre = "encode " if name == "keyed_encode_entries" else "unfold "
            extra["kernel_phase"] = {k[len(pre):]: t for k, t in fold_times.items()
                                     if k.startswith(pre)}
        if name == "keyed_finish":
            extra["kernel_phase"] = finish_times
        entries.append(_entry(name, shapes_k[head], launches[name],
                              max(t["max_abs_err"] for t in shapes_k.values()),
                              shapes=shapes_k, **extra))
    entries.append(_entry("mesh_reduce", reduce_shape, launches["mesh_reduce"], 0.0,
                          kernel_phase={k: t for k, t in mesh_times.items()
                                        if k.startswith("reduce")}))
    entries.append(_entry("mesh_route", route_shape, launches["mesh_route"], 0.0,
                          kernel_phase={k: t for k, t in mesh_times.items()
                                        if k.startswith("route")}))
    for name, head in (("df32_agg", "q1 matmul form"), ("ord_extremum", "q1 min/max first call"),
                       ("x32_merge", "q1 first batch")):
        shapes_x = x32_times[name]
        entries.append(_entry(name, shapes_x[head], launches[name],
                              max(t["max_abs_err"] for t in shapes_x.values()),
                              shapes=shapes_x))
    # the x32 ops of B3, K2 and the mesh reduce, and every kernel's x32 form
    # (B12f's square pair in B3, the int32 keyed, join and window forms,
    # x32 corr and finish, the i64pair exchange) beside their x64 entries
    for e in entries:
        x32 = dict(x32_times[e["name"]]) if e["name"] in (
            "expr_eval", "seg_scan", "mesh_reduce") else {}
        x32.update(forms.get(e["name"], {}))
        if x32:
            e["x32"] = x32
    return entries


if __name__ == "__main__":
    sys.exit(main())
