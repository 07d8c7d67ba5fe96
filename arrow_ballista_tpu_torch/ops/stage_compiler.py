"""Device stage compiler: swap eligible subtrees for the CUDA aggregate.

Counterpart of ``arrow_ballista_tpu/ops/stage_compiler.py``: the basic
route with host group ids, on its scatter or sort reduction.
``maybe_accelerate`` walks a physical plan and replaces each eligible
``HashAggregateExec`` (plus its filter/projection chain) with a
:class:`TorchStageExec`: per batch the host assigns dense group ids, the
leaf arrays cross to the stage's device, the expression closures run as
torch ops and the segment-aggregate kernel (or, above the capacity bound
on cuda, the radix sort and segmented scan) merges the batch into the
running state; after the last batch ONE fetch brings the state back.
Under a shuffle writer's hint the output also carries each row's
partition id, computed by the partition-id kernel (B4).
Each eligible ``WindowExec`` becomes a ``TorchWindowExec``
(``ops/window_compiler.py``).  Everything else stays on the CPU operator
path, gated by the same session config (``ballista.tpu.enable``).

Not ported (the plan keeps the CPU operators, decided at plan time):
the device join, the keyed high-cardinality route, median,
count-distinct, corr, the variance family, the column cache and
whole-stage fusion.  A join below the aggregate runs on the CPU and the
aggregate above it on the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator, Optional

import numpy as np
import pyarrow as pa
import torch

from ..config import BallistaConfig
from ..errors import ExecutionError
from ..exec import expressions as pe
from ..exec.aggregates import PARTIAL, SINGLE, AggSpec, HashAggregateExec
from ..exec.operators import (
    ExecutionPlan,
    FilterExec,
    Partitioning,
    ProjectionExec,
    TaskContext,
)
from ..exec.planner import RenameSchemaExec
from . import kernels as K


class _CapacityExceeded(Exception):
    pass


class _SmallInput(Exception):
    """Control flow: the source peek found fewer rows than tpu.min_rows;
    carries the already-buffered batches so the CPU path needn't re-scan."""

    def __init__(self, batches: list):
        super().__init__(f"{sum(b.num_rows for b in batches)} rows")
        self.batches = batches


class _HighCardinality(Exception):
    """Control flow: the first batch showed groups ~ rows — the stage hands
    back to the CPU hash aggregate, replaying the consumed batch and
    chaining the still-live source iterator (no re-scan)."""

    def __init__(self, batches: list, tail):
        super().__init__("high-cardinality aggregate")
        self.batches = batches
        self.tail = tail


# groups~rows detector bounds (the reference's builtin routing defaults;
# no H100 routing grid exists yet)
HIGHCARD_MIN_GROUPS = 1 << 16
HIGHCARD_RATIO = 0.05


def _highcard_detect(n_groups: int, n_rows: int) -> bool:
    """Raw groups~rows detector (first data batch)."""
    return n_groups > HIGHCARD_MIN_GROUPS and n_groups > HIGHCARD_RATIO * n_rows


def _keep_bucket(n_groups: int) -> int:
    """Pow2 bucket of assigned-group slots the fetch moves."""
    return 1 << max(6, (max(n_groups, 1) - 1).bit_length())


class _ReadAhead:
    """Bounded background prefetch of source batches.

    Device stages alternate host-side work (scan/decode, key encode) with
    device dispatch; pulling the NEXT batch on a daemon thread overlaps
    the source's IO (pyarrow readers release the GIL in C++) with the
    current batch's device work.  The iterator is transparent: batches
    arrive in order, source exceptions re-raise at the consumer, and
    fallback replay (``_HighCardinality.tail``) can keep consuming it —
    queued batches are still inside and will be yielded.

    ``close()`` stops the pump before a fallback re-runs the stage on
    CPU — otherwise the abandoned thread would keep consuming the old
    source concurrently with the re-run's fresh iterator (a double-read
    of e.g. a Flight stream) and then block on the bounded queue forever.
    Residual race: a pump already blocked INSIDE the source's read when
    ``close()`` lands cannot be interrupted and may consume ONE more item
    before it sees the flag (the item is dropped, never yielded); the
    double-read window is mitigated to that single in-flight read, not
    eliminated.
    """

    _DONE = object()

    def __init__(self, it, depth: int):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._closed = False
        self._exhausted = False

        def pump():
            try:
                for item in it:
                    if self._closed:
                        return  # drop: a fallback re-run owns the source
                    self._q.put(item)
                    if self._closed:
                        return
            except BaseException as e:  # re-raised on the consumer side
                self._q.put(e)
                return
            self._q.put(self._DONE)

        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, BaseException):
            # generator semantics: a terminal exception surfaces once,
            # then the iterator stays exhausted
            self._exhausted = True
            raise item
        return item

    def close(self, deadline_s: float = 1.0) -> None:
        """Stop the pump: drain the queue until the thread exits (freeing
        queue slots unblocks a pump stuck in put; the loop re-checks the
        flag after each put).  Bounded wait: a pump blocked inside the
        SOURCE's read cannot be interrupted — after the deadline the
        daemon thread is abandoned rather than hanging the caller's CPU
        fallback."""
        import queue

        self._closed = True
        self._exhausted = True
        give_up = time.monotonic() + deadline_s
        while self._thread.is_alive() and time.monotonic() < give_up:
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(0.05)


def _shuffle_coalesce_rows(config) -> int:
    """Resolved host-coalescing target for shuffle-fed device stages:
    ``ballista.shuffle.coalesce_rows`` (0 → follow ``ballista.batch.size``,
    negative → disabled)."""
    n = config.shuffle_coalesce_rows
    if n < 0:
        return 0
    return n or config.batch_size


def _reads_shuffle(plan) -> bool:
    """Does this stage source pull from a shuffle reader (whose batches
    arrive as per-map-task fragments worth coalescing)?"""
    from ..shuffle.execution_plans import ShuffleReaderExec

    if isinstance(plan, ShuffleReaderExec):
        return True
    return any(_reads_shuffle(c) for c in plan.children())


@contextlib.contextmanager
def _closing_on_error(ra: Optional[_ReadAhead]):
    """Stop the prefetch pump when the device stage aborts (a
    _CapacityExceeded re-run on the CPU, or an error): a re-run opens a
    FRESH source iterator, so the old pump must not keep reading the
    abandoned one.  _HighCardinality passes through untouched — its
    replay keeps consuming this same iterator."""
    try:
        yield
    except _HighCardinality:
        raise
    except BaseException:
        if ra is not None:
            ra.close()
        raise


class _BufferedExec(ExecutionPlan):
    """In-memory stand-in for a stage source whose batches were already
    pulled by a peek (optionally chaining the still-live remainder)."""

    def __init__(self, template: ExecutionPlan, batches: list, tail=None):
        super().__init__()
        self._template = template
        self._batches = batches
        self._tail = tail

    @property
    def schema(self) -> pa.Schema:
        return self._template.schema

    def output_partitioning(self) -> Partitioning:
        return self._template.output_partitioning()

    def children(self) -> list[ExecutionPlan]:
        return []

    def with_new_children(self, children):
        return self

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        yield from self._batches
        if self._tail is not None:
            yield from self._tail


# ----------------------------------------------------------- substitution
def _subst(e: pe.PhysicalExpr, mapping: list[pe.PhysicalExpr]) -> pe.PhysicalExpr:
    """Rewrite ``e`` (defined over an intermediate projection schema) onto
    the stage source schema by inlining the producing expressions."""
    if isinstance(e, pe.Col):
        return mapping[e.index]
    if isinstance(e, pe.Binary):
        return pe.Binary(_subst(e.left, mapping), e.op, _subst(e.right, mapping))
    if isinstance(e, pe.Not):
        return pe.Not(_subst(e.expr, mapping))
    if isinstance(e, pe.Negative):
        return pe.Negative(_subst(e.expr, mapping))
    if isinstance(e, pe.IsNull):
        return pe.IsNull(_subst(e.expr, mapping), e.negated)
    if isinstance(e, pe.InList):
        return pe.InList(_subst(e.expr, mapping), e.items, e.negated)
    if isinstance(e, pe.Like):
        return pe.Like(_subst(e.expr, mapping), e.pattern, e.negated)
    if isinstance(e, pe.Case):
        return pe.Case(
            tuple((_subst(w, mapping), _subst(t, mapping)) for w, t in e.whens),
            _subst(e.else_expr, mapping) if e.else_expr is not None else None,
            e.out_type,
        )
    if isinstance(e, pe.Cast):
        return pe.Cast(_subst(e.expr, mapping), e.to_type)
    if isinstance(e, pe.ScalarFn):
        return pe.ScalarFn(
            e.fname, tuple(_subst(a, mapping) for a in e.args), e.out_type
        )
    if isinstance(e, (pe.Lit, pe.IntervalLit)):
        return e
    raise ExecutionError(f"cannot substitute through {type(e).__name__}")


@dataclasses.dataclass
class _FusedStage:
    """The flattened eligible subtree, rewritten onto the source schema."""

    source: ExecutionPlan
    filters: list[pe.PhysicalExpr]
    group_exprs: list[tuple[pe.PhysicalExpr, str]]
    aggs: list[AggSpec]
    mode: str


def _flatten(agg: HashAggregateExec) -> Optional[_FusedStage]:
    """Flatten the aggregate's filter/projection chain onto its source.
    The device join is not ported: a join source stays on the CPU below
    the device aggregate (the reference's ``fold_join=False`` shape)."""
    chain: list[ExecutionPlan] = []
    node = agg.input
    while isinstance(node, (FilterExec, ProjectionExec, RenameSchemaExec)):
        chain.append(node)
        node = node.children()[0]
    source = node
    mapping: list[pe.PhysicalExpr] = [
        pe.Col(i, f.name) for i, f in enumerate(source.schema)
    ]
    filters: list[pe.PhysicalExpr] = []
    try:
        for op in reversed(chain):
            if isinstance(op, RenameSchemaExec):
                continue
            if isinstance(op, FilterExec):
                filters.append(_subst(op.predicate, mapping))
            else:
                mapping = [_subst(e, mapping) for e, _ in op.exprs]
        group_exprs = [(_subst(g, mapping), name) for g, name in agg.group_exprs]
        aggs = [
            dataclasses.replace(
                a,
                arg=_subst(a.arg, mapping) if a.arg is not None else None,
                arg2=_subst(a.arg2, mapping) if a.arg2 is not None else None,
            )
            for a in agg.aggs
        ]
    except ExecutionError:
        return None
    return _FusedStage(source, filters, group_exprs, aggs, agg.mode)


def _infer_type(e: pe.PhysicalExpr, schema: pa.Schema) -> Optional[pa.DataType]:
    if isinstance(e, pe.Col):
        return schema.field(e.index).type
    try:
        return K._infer_pa_type(e, schema)
    except Exception:
        return None


class TorchStageExec(ExecutionPlan):
    """Fused scan→filter→project→aggregate stage on one torch device.

    Replaces the interpreted per-batch operator chain with torch ops plus
    one segment-aggregate kernel per batch; partial states accumulate on
    the device and only [num_groups]-sized results return to the host.
    Group-capacity overflow re-executes the original CPU subtree.
    """

    def __init__(
        self,
        original: HashAggregateExec,
        fused: _FusedStage,
        config: BallistaConfig,
        device,
    ):
        super().__init__()
        self.original = original
        self.fused = fused
        self.config = config
        self.device = torch.device(device)
        self._schema = original.schema
        schema = fused.source.schema

        compiler = K.TorchExprCompiler(schema)
        # equal arguments lower to ONE closure, which the kernel function
        # turns into one shared kernel column
        lowered: dict = {}

        def lower(e: pe.PhysicalExpr) -> K.TorchClosure:
            key = repr(e)
            if key not in lowered:
                lowered[key] = compiler._lower(e)
            return lowered[key]

        filter_closure = None
        if fused.filters:
            pred = fused.filters[0]
            for f in fused.filters[1:]:
                pred = pe.Binary(pred, "AND", f)
            filter_closure = compiler._lower_or_leaf(pred)
        # two passes: count(col) resolves AFTER the other aggregates so it
        # can reuse a column leaf's validity that is shipping anyway
        pending: list = [None] * len(fused.aggs)
        count_cols: list[tuple[int, pe.Col]] = []
        for idx, a in enumerate(fused.aggs):
            if a.arg is None:
                if a.func not in ("count", "count_star"):
                    raise K.NotLowerable(a.func)
                pending[idx] = (K.KernelAggSpec("count_star", False), None)
                continue
            if a.func not in ("count", "sum", "avg", "min", "max"):
                # median, count_distinct, corr, the variance family,
                # udaf:*: not ported — reject at PLAN time
                raise K.NotLowerable(a.func)
            if a.func == "count" and isinstance(a.arg, pe.Col):
                count_cols.append((idx, a.arg))
                continue
            t = _infer_type(a.arg, schema)
            is_int = t is not None and pa.types.is_integer(t)
            if a.func in ("min", "max"):
                int_mm = is_int or (t is not None and pa.types.is_date32(t))
                spec = K.KernelAggSpec(a.func, True, int_minmax=int_mm)
            else:
                spec = K.KernelAggSpec(
                    a.func, True, int_sum=a.func == "sum" and is_int
                )
            pending[idx] = (spec, lower(a.arg))
        for idx, colarg in count_cols:
            # count(col) reads only the validity mask: the column's own
            # closure when it ships anyway, else a validity-only leaf
            if f"col_{colarg.index}" in compiler.leaves:
                closure = lower(colarg)
            else:
                closure = compiler.validity_only(colarg)
            pending[idx] = (K.KernelAggSpec("count", True), closure)
        self.specs: list[K.KernelAggSpec] = [s for s, _ in pending]
        self._arg_closures = [c for _, c in pending]
        self._filter_closure = filter_closure
        n_fields = sum(len(K.state_fields(s)) for s in self.specs) + 1
        if n_fields > K.MAX_FIELDS or len(self.specs) > K.MAX_COLUMNS:
            raise K.NotLowerable(f"{len(self.specs)} aggregates")
        self.leaves = compiler.leaves
        self.capacity = config.tpu_segment_capacity if fused.group_exprs else 1
        self.max_capacity = config.tpu_max_capacity if fused.group_exprs else 1
        self._flat_names = K.flat_arg_names(self.leaves)
        self._kernels: dict = {}
        # (exprs, n_out) installed by a downstream ShuffleWriterExec so
        # the hash-partition ids ride the device instead of the host
        self._shuffle_hint = None

    def _build_kernels(self) -> None:
        """The CUDA kernels build on first use; that build is the stage's
        ``tpu_compile_ns``."""
        if self.device.type == "cuda":
            from .cuda import build

            if not build.is_loaded():
                with self.metrics.timer("tpu_compile_ns"):
                    build.load()
                self.metrics.add("kernel_compiles", 1)

    def _kernel_for(self, capacity: int, n_rows: int):
        """The per-batch stage function at the given segment capacity, on
        the route :func:`K.segment_algo` picks for this capacity and batch
        size (scatter, or sort above the bounds on cuda).  Cached per
        (capacity, route), so a capacity growth builds the next one."""
        algo = K.segment_algo(capacity, n_rows, self.device)
        key = (capacity, algo) + K.algo_cache_token()
        kernel = self._kernels.get(key)
        if kernel is None:
            kernel = self._kernels[key] = K.make_partial_agg_kernel(
                self._filter_closure,
                self._arg_closures,
                self.specs,
                capacity,
                self._flat_names,
                algo=algo,
            )
        return kernel

    @property
    def schema(self) -> pa.Schema:
        return self._schema

    def install_shuffle_hint(self, exprs, n_out: int) -> None:
        """Downstream ShuffleWriterExec announces its hash partitioning
        (exprs over THIS stage's output schema, n_out partitions):
        ``_materialize`` then computes the partition-id column on the
        stage's device (``K.device_partition_ids``) and appends it as
        ``SHUFFLE_PID_COLUMN``, so the writer's split skips the host hash.
        The ids equal the host partitioner's bit for bit; keys the kernel
        cannot hash (strings, computed expressions) leave the hint unused,
        and a kernel or build error raises."""
        self._shuffle_hint = (list(exprs), int(n_out))

    def output_partitioning(self) -> Partitioning:
        return self.fused.source.output_partitioning()

    def children(self) -> list[ExecutionPlan]:
        return [self.fused.source]

    def with_new_children(self, children):
        new_original = self.original.with_new_children(
            [_replace_leaf(self.original.input, self.fused.source, children[0])]
        )
        fused = _flatten(new_original)
        if fused is None:
            return new_original
        try:
            return TorchStageExec(new_original, fused, self.config, self.device)
        except K.NotLowerable:
            return new_original

    def __str__(self) -> str:
        return (
            f"TorchStageExec: mode={self.fused.mode}, "
            f"gby={[n for _, n in self.fused.group_exprs]}, "
            f"aggr={[a.name for a in self.fused.aggs]}, "
            f"filters={len(self.fused.filters)}, capacity={self.capacity}, "
            f"device={self.device}"
        )

    # ------------------------------------------------------------ execute
    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        try:
            yield from self._execute_device(partition, ctx)
            return
        except _SmallInput as si:
            # partition under tpu.min_rows: run the CPU operator path over
            # the batches the peek already pulled (no source re-scan), and
            # OUTSIDE this try so real CPU errors propagate
            self.metrics.add("cpu_fallback", 1)
            cpu_plan = self._replay(si.batches)
        except _HighCardinality as hc:
            # groups ~ rows: hand the stage to the CPU hash aggregate,
            # replaying the consumed batch + chaining the live source
            self.metrics.add("highcard_fallback", 1)
            cpu_plan = self._replay(hc.batches, hc.tail)
        except _CapacityExceeded:
            # the group table outgrew tpu.max_capacity or its 62-bit key
            # space.  Nothing else goes to the CPU: a device, kernel or
            # bridge failure raises
            self.metrics.add("tpu_fallback", 1)
            cpu_plan = self.original
        yield from cpu_plan.execute(partition, ctx)

    def _replay(self, batches: list, tail=None) -> ExecutionPlan:
        return self.original.with_new_children(
            [
                _replace_leaf(
                    self.original.input,
                    self.fused.source,
                    _BufferedExec(self.fused.source, batches, tail),
                )
            ]
        )

    def _execute_device(
        self, partition: int, ctx: TaskContext
    ) -> Iterator[pa.RecordBatch]:
        fused = self.fused
        src = fused.source.execute(partition, ctx)
        coalesce = _shuffle_coalesce_rows(self.config)
        if coalesce > 0 and _reads_shuffle(fused.source):
            # shuffle readers yield one fragment per map task; combine
            # them to the target batch size on the host so each launch
            # moves a full batch
            from .bridge import coalesce_batches

            src = coalesce_batches(src, coalesce, self.metrics)
        min_rows = self.config.tpu_min_rows
        if min_rows > 0:
            # peek: launch latency dominates tiny inputs, so partitions
            # under the threshold run the CPU operator path
            import itertools

            buffered: list[pa.RecordBatch] = []
            total = 0
            exhausted = True
            for b in src:
                buffered.append(b)
                total += b.num_rows
                if total >= min_rows:
                    exhausted = False
                    break
            if exhausted and total < min_rows:
                raise _SmallInput(buffered)
            src = itertools.chain(buffered, src)

        depth = self.config.tpu_readahead
        ra: Optional[_ReadAhead] = None
        if depth > 0:
            src = ra = _ReadAhead(src, depth)

        from .bridge import DeviceStaging, make_key_encoder
        from .groups import GroupTable

        key_encoders = [
            make_key_encoder(self._schema.field(pos).type)
            for pos in range(len(fused.group_exprs))
        ]
        group_table = GroupTable(max(len(fused.group_exprs), 1))
        staging = DeviceStaging(self.device)
        on_cuda = self.device.type == "cuda"
        launches: list = []  # (start, end) CUDA events per batch

        state = None
        n_rows_in = 0
        cap = self.capacity
        self._build_kernels()
        with _closing_on_error(ra), self.metrics.timer("tpu_stage_time_ns"):
            for batch in src:
                if batch.num_rows == 0:
                    continue
                n = batch.num_rows
                n_rows_in += n

                if fused.group_exprs:
                    with self.metrics.timer("key_encode_time_ns"):
                        codes = self._encode_codes(batch, key_encoders)
                    if state is None:
                        try:
                            with self.metrics.timer("key_encode_time_ns"):
                                seg = self._assign_gids(codes, group_table)
                            first_groups = group_table.n_groups
                        except _CapacityExceeded:
                            # ONE batch outran the gid table: definitionally
                            # high-cardinality
                            first_groups = None
                        if first_groups is None or _highcard_detect(
                            first_groups, n
                        ):
                            # 'gid' and 'device' pin the device route (the
                            # keyed route behind 'device' is not ported, so
                            # the gid table is the device route)
                            if not (
                                self.config.tpu_highcard_mode in ("gid", "device")
                                and first_groups is not None
                            ):
                                raise _HighCardinality([batch], src)
                        # first batch: shrink the segment table to the
                        # OBSERVED cardinality (2x headroom)
                        tight = 64
                        while tight < 2 * max(1, group_table.n_groups):
                            tight *= 4
                        if tight < cap:
                            cap = min(tight, self.max_capacity)
                    else:
                        with self.metrics.timer("key_encode_time_ns"):
                            seg = self._assign_gids(codes, group_table)
                    # adaptive capacity: grow the segment table in 4x
                    # buckets, padding accumulated states with identities
                    if group_table.n_groups > cap:
                        while cap < group_table.n_groups:
                            cap *= 4
                        cap = min(cap, self.max_capacity)
                        state = K.pad_states(self.specs, state, cap)
                        self.metrics.add("capacity_growths", 1)
                else:
                    seg = None  # all rows → group 0

                kernel = self._kernel_for(cap, n)
                with self.metrics.timer("bridge_time_ns"):
                    args = self._kernel_args(batch, n, seg, staging)
                with self.metrics.timer("device_time_ns"):
                    gid = args.pop()
                    if gid is None:
                        gid = torch.zeros(n, dtype=torch.int32, device=self.device)
                    if on_cuda:
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        state = kernel(gid, None, *args, state=state)
                        end.record()
                        launches.append((start, end))
                    else:
                        t0 = time.perf_counter_ns()
                        state = kernel(gid, None, *args, state=state)
                        self.metrics.add(
                            "tpu_execute_ns", time.perf_counter_ns() - t0
                        )

            # the fetch waits for every launch, so the device timer covers
            # queue + compute + result copy
            with self.metrics.timer("device_time_ns"):
                host_states = self._fetch_states(
                    state, group_table.n_groups if fused.group_exprs else None
                )
            for start, end in launches:
                self.metrics.add(
                    "tpu_execute_ns", int(start.elapsed_time(end) * 1e6)
                )

        yield from self._materialize(
            host_states, key_encoders, group_table, n_rows_in, ctx, partition
        )

    def _kernel_args(self, batch, n: int, seg, staging) -> list:
        """The stage function's per-batch tensors on the device, in flat
        arg order, then the group ids (None for a global aggregate).
        All-valid companions travel as ``None``: no bytes cross."""
        trivial: set = set()
        env = K.build_env(batch, self.leaves, n, trivial_valid=trivial)
        host = {nm: (None if nm in trivial else env[nm]) for nm in self._flat_names}
        host["__gid__"] = seg
        dev = staging.put(host)
        return [dev[nm] for nm in self._flat_names] + [dev["__gid__"]]

    def _fetch_states(
        self, state, n_groups: Optional[int] = None
    ) -> Optional[list]:
        """One device→host copy of the state, bounded to the pow2 bucket
        covering the assigned group ids."""
        if state is None:
            return None
        keep = None if n_groups is None else _keep_bucket(n_groups)
        return K.unpack_host(self.specs, K.fetch_states(state, keep))

    def _encode_codes(self, batch, key_encoders) -> list[np.ndarray]:
        """Per-key dictionary/identity code arrays for one batch."""
        from .groups import RadixOverflow

        try:
            return [
                enc.encode(_eval_arr(g, batch))
                for (g, _), enc in zip(self.fused.group_exprs, key_encoders)
            ]
        except RadixOverflow:
            raise _CapacityExceeded()

    def _assign_gids(self, code_arrays: list, group_table) -> np.ndarray:
        from .groups import RadixOverflow

        try:
            gids = group_table.encode(code_arrays)
        except RadixOverflow:
            raise _CapacityExceeded()
        if group_table.n_groups > self.max_capacity:
            raise _CapacityExceeded()
        return gids

    # ------------------------------------------------------- materialize
    def _materialize(
        self, host_states, key_encoders, group_table, n_rows_in,
        ctx: TaskContext, partition: int,
    ) -> Iterator[pa.RecordBatch]:
        """Build the output batch from the fetched numpy state arrays."""
        fused = self.fused
        schema = self._schema

        if host_states is None:
            if not fused.group_exprs:
                # empty input, global aggregate: the CPU operator supplies
                # the exact SQL empty-input row for THIS (empty) partition
                yield from self.original.execute(partition, ctx)
            return

        n_groups = group_table.n_groups if fused.group_exprs else 1
        host = [a[:n_groups] for a in host_states]
        presence = host[-1]
        keep = np.nonzero(presence > 0)[0] if fused.group_exprs else np.arange(1)

        cols: list[pa.Array] = []
        for slot in range(len(fused.group_exprs)):
            codes = group_table.codes_for(keep, slot)
            cols.append(key_encoders[slot].decode(codes, schema.field(slot).type))

        partial = fused.mode == PARTIAL
        i = 0
        for spec in self.specs:
            if spec.func in ("count", "count_star"):
                cols.append(pa.array(host[i][keep], pa.int64()))
                i += 1
                continue
            field_t = schema.field(len(cols)).type
            n_arr = host[i + 1][keep]
            empty = n_arr == 0
            if spec.int_minmax or spec.int_sum:
                # integer states stay INT end-to-end (an f64 round-trip
                # would round int64 values above 2^53)
                vals = np.where(empty, 0, host[i][keep]).astype(np.int64)
                i += 2
                if pa.types.is_date32(field_t):
                    vals = vals.astype("datetime64[D]")
                cols.append(pa.array(vals, field_t, mask=empty))
                continue
            v = host[i][keep].astype(np.float64)
            i += 2
            if spec.func == "avg":
                if partial:
                    cols.append(pa.array(v, pa.float64()))
                    cols.append(pa.array(n_arr, pa.int64()))
                else:
                    denom = np.where(empty, 1, n_arr)
                    cols.append(pa.array(v / denom, pa.float64(), mask=empty))
                continue
            if pa.types.is_integer(field_t) or pa.types.is_date32(field_t):
                # f64 state of an integer-typed output (±inf extrema
                # identities of empty groups are masked out, zeroed first
                # so the int cast can't warn)
                v_int = np.round(np.where(np.isfinite(v), v, 0.0)).astype(np.int64)
                if pa.types.is_date32(field_t):
                    v_int = v_int.astype("datetime64[D]")
                cols.append(pa.array(v_int, field_t, mask=empty))
            else:
                cols.append(pa.array(v, field_t, mask=empty))

        out = pa.RecordBatch.from_arrays(cols, schema=schema)
        self.metrics.add("output_rows", out.num_rows)
        self.metrics.add("input_rows", n_rows_in)
        hint = self._shuffle_hint
        if hint is not None and out.num_rows:
            pids = K.device_partition_ids(out, hint[0], hint[1], self.device)
            if pids is not None:
                from ..exec.operators import SHUFFLE_PID_COLUMN

                # device_pid_batches is counted once, by the consuming writer
                out = pa.RecordBatch.from_arrays(
                    out.columns + [pa.array(pids, pa.int32())],
                    schema=schema.append(pa.field(SHUFFLE_PID_COLUMN, pa.int32())),
                )
        yield out


def _eval_arr(e: pe.PhysicalExpr, batch: pa.RecordBatch) -> pa.Array:
    v = e.evaluate(batch)
    if isinstance(v, pa.ChunkedArray):
        v = v.combine_chunks()
    if isinstance(v, pa.Scalar):
        v = pa.array([v.as_py()] * batch.num_rows, v.type)
    return v


def _replace_leaf(
    plan: ExecutionPlan, old: ExecutionPlan, new: ExecutionPlan
) -> ExecutionPlan:
    if plan is old:
        return new
    kids = plan.children()
    if not kids:
        return plan
    return plan.with_new_children([_replace_leaf(c, old, new) for c in kids])


# ------------------------------------------------------------------ rule
def maybe_accelerate(
    plan: ExecutionPlan, config: BallistaConfig, device
) -> ExecutionPlan:
    """PhysicalOptimizerRule: replace eligible aggregates with
    TorchStageExec and eligible windows with TorchWindowExec on
    ``device``."""
    if not config.tpu_enable:
        return plan
    kids = plan.children()
    if kids:
        plan = plan.with_new_children(
            [maybe_accelerate(c, config, device) for c in kids]
        )
    from ..exec.window import WindowExec

    if isinstance(plan, WindowExec):
        from .window_compiler import TorchWindowExec

        try:
            return TorchWindowExec(plan, config, device)
        except K.NotLowerable:
            return plan
    if isinstance(plan, HashAggregateExec) and plan.mode in (PARTIAL, SINGLE):
        fused = _flatten(plan)
        if fused is None:
            return plan
        try:
            return TorchStageExec(plan, fused, config, device)
        except K.NotLowerable:
            return plan
    return plan
