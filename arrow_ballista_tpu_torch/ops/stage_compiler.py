"""Device stage compiler: swap eligible subtrees for the CUDA aggregate.

Counterpart of ``arrow_ballista_tpu/ops/stage_compiler.py``: the basic
route with host group ids, on its scatter or sort reduction, the keyed
route with device group ids, and the device join.  ``maybe_accelerate``
walks a physical plan and replaces each
eligible ``HashAggregateExec`` (plus its filter/projection chain) with a
:class:`TorchStageExec`: per batch the host assigns dense group ids, the
leaf arrays cross to the stage's device, the expression closures run as
torch ops and the segment-aggregate kernel (or, above the capacity bound
on cuda, the radix sort and segmented scan) merges the batch into the
running state; after the last batch ONE fetch brings the state back.
An inner PK-FK hash join below the aggregate folds into the stage
(:class:`DeviceJoinSpec`): the build side is collected once on the host,
and each probe batch joins on the device through the probe kernel (B5),
whose match folds into the row mask.
Under a shuffle writer's hint the output also carries each row's
partition id, computed by the partition-id kernel (B4).
The keyed route (:meth:`TorchStageExec._run_keyed`) takes a stage whose
groups ~ rows under ``ballista.tpu.highcard_mode=device``, and every
stage with median, count distinct or corr: raw key columns cross to the
device, and at the end of the stream one radix sort orders the buffered
rows by key, the gid kernel numbers the groups, the segmented scan
reduces every aggregate and the finish kernel (B8) gathers the group keys
into one fetch; the median (B9) and corr (B10) passes reuse that sort.
A stream of at most ``_FUSED_MAX_ENTRIES`` batches within the keyed
buffer budget is one single dispatch (B7c, ``_keyed_reduce_fused``): one
entry-wise launch codes every batch's keys into the sort operands, folded
into one int32 word when the stream's code spans fit 31 bits
(``_radix_combine_bits``), and the finish unfolds each group's word;
past either bound the batches drain into the per-batch key encode (B7).
A join-free basic-route stage over a scan retains its batches instead
of folding each on arrival (``ballista.tpu.cache_columns``, on by
default): each batch's group ids and leaf tensors stay on the device as
one entry, and after the stream the multi-entry kernel (B13a) folds every
entry at the final capacity into one state, fetched once; the entries go
into the device column cache (``ops/device_cache.py``) under the scan's
provider, so a repeated query replays them with no scan, no host encode
and no bridge (``cache_hits``).  Under ``ballista.tpu.whole_stage_fusion``
(``ops/fusion.py``) any such stage retains its batches for that one run,
and the shuffle partition ids of its groups ride the same fetch
(``fused_pid_in_kernel``).  Past ``_FUSED_MAX_ENTRIES`` entries, or at a
capacity that takes the sort route, the entries run one launch each.
A stage built under ``kernels.set_precision("x32")`` runs the reference's
x32 mode (``TorchStageExec._mode``): float32/int32 columns, double-float
sums and order-pair extrema on the matmul, scatter or sort route
(``kernels.x32_reduce``), and on every other route the reference takes
in that mode: the keyed route with int32 key codes, median, count
distinct, corr, the variance family (the Dekker square pair in B3, the
sort route), the join fold with int32 keys; a value that mode cannot
carry re-runs the partition on the CPU operators, as in the reference.
Each eligible ``WindowExec`` becomes a ``TorchWindowExec``
(``ops/window_compiler.py``).  Everything else stays on the CPU operator
path, gated by the same session config (``ballista.tpu.enable``).

Not ported (the plan keeps the CPU operators, decided at plan time):
udafs.  A join the fold declines runs on the CPU below the device
aggregate.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
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


class _JoinIneligible(Exception):
    """The device join cannot run for THIS data (non-unique build keys, or
    build columns the bridge cannot ship): re-run with the join on the CPU
    and only the aggregate on the device."""


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


class _KeyedRoute(Exception):
    """Control flow: route the stage to the device-KEYED aggregation.
    Carries the consumed batch with its host key codes (None when the keys
    encode on the device), the still-live source iterator, the key
    encoders and the prefetch pump."""

    def __init__(self, batches: list, tail, key_encoders, ra):
        super().__init__("keyed aggregate")
        self.batches = batches  # [(RecordBatch, code arrays or None)]
        self.tail = tail
        self.key_encoders = key_encoders
        self.ra = ra


class _KeyedFallback(Exception):
    """The keyed route cannot take THIS data: keys that cannot ship (a
    float key holding the reserved null pattern), or a median/corr stage
    whose buffer outgrew ``tpu.keyed_buffer_mb`` (order statistics cannot
    merge chunks).  The partition re-runs on the CPU operators."""


class _VarianceGuard(Exception):
    """A variance's Σx² - (Σx)²/n cancelled past the digits its f64 moments
    carry: only the CPU operators can answer; the partition re-runs there."""


class _TrackingIter:
    """Iterator wrapper recording whether any item was yielded: a keyed
    fallback replays the buffered batches and chains the tail when the
    live source was never touched."""

    def __init__(self, it):
        self._it = iter(it)
        self.consumed = False

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self._it)
        self.consumed = True
        return item


class _KeyedGroups:
    """GroupTable-shaped view over DEVICE-assigned groups: the fetched
    unique key codes (gid order is key-sorted order) serve the ``n_groups``
    / ``codes_for`` surface ``_materialize`` reads."""

    def __init__(self, key_codes: list, n_groups: int):
        self._codes = key_codes
        self.n_groups = n_groups

    def codes_for(self, gids: np.ndarray, key: int) -> np.ndarray:
        return self._codes[key][gids]


# groups~rows detector bounds and the 'auto' keyed switch: the reference's
# builtin routing defaults (ops/routing.py; no H100 routing grid exists yet)
HIGHCARD_MIN_GROUPS = 1 << 16
HIGHCARD_RATIO = 0.05
KEYED_ROUTE_AUTO = False


# Whole-stage fusion bounds (ballista.tpu.whole_stage_fusion): the
# reference's builtin routing defaults (its fusion_max_ops and
# fusion_min_rows), constants until a cuda routing table exists; tests
# override them as they override the reference's.
_FUSION_MAX_OPS = 8
_FUSION_MIN_ROWS = 2048


# The single-dispatch runner folds at most this many retained entries in
# one multi-entry launch; past it each entry runs its own one-batch launch
# into one state.  The cap is the reference's (which it set for its
# compiler's unroll); it stays until the cuda routing grid measures where
# the multi-entry launch stops paying on the card.
_FUSED_MAX_ENTRIES = 32


def keyed_route_wanted(config) -> bool:
    """Does groups~rows route to the device-KEYED path in this config?
    'device' pins it, 'cpu' and 'gid' never take it, 'auto' follows
    ``KEYED_ROUTE_AUTO``."""
    mode = config.tpu_highcard_mode
    if mode == "device":
        return True
    if mode in ("cpu", "gid"):
        return False
    return KEYED_ROUTE_AUTO


def _highcard_detect(n_groups: int, n_rows: int) -> bool:
    """Raw groups~rows detector (first data batch)."""
    return n_groups > HIGHCARD_MIN_GROUPS and n_groups > HIGHCARD_RATIO * n_rows


# Build-key spans up to this many slots use the dense direct-probe join
# table ([span] int32, 256 MiB of device memory at the cap) instead of the
# sorted keys' binary search (the reference's bound).
_DENSE_JOIN_SPAN_CAP = 1 << 26


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
    abandoned one.  _HighCardinality and _KeyedRoute pass through
    untouched — their replay keeps consuming this same iterator."""
    try:
        yield
    except (_HighCardinality, _KeyedRoute):
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
class DeviceJoinSpec:
    """A PK-FK join folded INTO the device stage.

    Scope: inner single-key equi-join with UNIQUE build keys (every TPC-H
    join).  The build side (the join's left input) is collected once on
    the host, sorted by key and shipped as [m]-sized tensors (plus a dense
    slot table when the key span allows); each probe batch joins on the
    device (``kernels.join_probe``) and the match mask folds into the
    stage's row mask, so the joined rows feed the aggregate without the
    join ever being materialised.
    """

    build: ExecutionPlan  # collected on the host, must have unique keys
    probe_key: pe.PhysicalExpr  # over the probe (source) schema
    build_key_index: int  # plain column of the build schema
    build_cols: list[int]  # build columns the stage reads, virtual order
    # (group-only build columns resolve on the host at materialize; only
    # the ones the kernel reads ship to the device — see _join_slots)


@dataclasses.dataclass
class _FusedStage:
    """The flattened eligible subtree, rewritten onto the source schema."""

    source: ExecutionPlan
    filters: list[pe.PhysicalExpr]
    group_exprs: list[tuple[pe.PhysicalExpr, str]]
    aggs: list[AggSpec]
    mode: str
    join: Optional[DeviceJoinSpec] = None


def _flatten(
    agg: HashAggregateExec, fold_join: bool = True
) -> Optional[_FusedStage]:
    """Flatten the aggregate's filter/projection chain onto its source,
    folding an eligible join source into a :class:`DeviceJoinSpec` unless
    ``fold_join`` is False (then the join stays on the CPU below the
    device aggregate)."""
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
    fused = _FusedStage(source, filters, group_exprs, aggs, agg.mode)
    if fold_join:
        return _maybe_fold_join(fused) or fused
    return fused


def _cols_used(e: pe.PhysicalExpr, out: set) -> None:
    if isinstance(e, pe.Col):
        out.add(e.index)
    for name in ("left", "right", "expr", "else_expr"):
        sub = getattr(e, name, None)
        if sub is not None:
            _cols_used(sub, out)
    for name in ("args",):
        for sub in getattr(e, name, ()) or ():
            _cols_used(sub, out)
    if isinstance(e, pe.Case):
        for w, t in e.whens:
            _cols_used(w, out)
            _cols_used(t, out)


def _shift_cols(e: pe.PhysicalExpr, remap: dict) -> pe.PhysicalExpr:
    """Rewrite column indexes through ``remap`` (join schema → probe +
    virtual build columns)."""
    mapping = [None] * (max(remap) + 1 if remap else 0)
    for i, j in remap.items():
        mapping[i] = pe.Col(j, f"c{j}")
    return _subst(e, mapping)


def _maybe_fold_join(fused: _FusedStage) -> Optional[_FusedStage]:
    """Fold an eligible HashJoinExec source into a DeviceJoinSpec: an
    inner, single-key equi-join with no filter, a plain-column build key
    and integer or date32 keys on both sides.  Build-side group keys must
    be plain build columns, and the probe key must then be a group key."""
    from ..exec.joins import HashJoinExec

    join = fused.source
    if not isinstance(join, HashJoinExec):
        return None
    if (
        join.join_type != "inner"
        or len(join.on) != 1
        or join.filter is not None
    ):
        return None
    lkey, rkey = join.on[0]
    if not isinstance(lkey, pe.Col):
        return None  # build key must be a plain column (sortable table)
    probe = join.right
    left_n = len(join.left.schema)
    probe_n = len(probe.schema)

    def _int_key(t) -> bool:
        return pa.types.is_integer(t) or pa.types.is_date32(t)

    # float keys would truncate through the int64 key path and match rows
    # SQL equality never joins: integer/date keys only
    if not _int_key(join.left.schema.field(lkey.index).type):
        return None
    try:
        if not _int_key(K._infer_pa_type(rkey, probe.schema)):
            return None
    except Exception:
        return None

    # which join-schema columns does the stage actually read?
    used: set = set()
    for f in fused.filters:
        _cols_used(f, used)
    for g, _ in fused.group_exprs:
        _cols_used(g, used)
    for a in fused.aggs:
        if a.arg is not None:
            _cols_used(a.arg, used)
        if a.arg2 is not None:
            _cols_used(a.arg2, used)

    build_cols: list[int] = []
    remap: dict = {}
    for i in sorted(used):
        if i >= left_n:
            remap[i] = i - left_n  # probe side, shifted onto probe schema
        else:
            if i not in build_cols:
                build_cols.append(i)
            remap[i] = probe_n + build_cols.index(i)

    # group keys on the build side must be PLAIN build columns AND the
    # probe join key must itself be a group key, so materialize can
    # resolve them (unique build keys => functional dependency)
    probe_key = rkey
    group_has_build = False
    key_in_groups = False
    for g, _name in fused.group_exprs:
        gused: set = set()
        _cols_used(g, gused)
        if any(i < left_n for i in gused):
            if not (isinstance(g, pe.Col) and g.index < left_n):
                return None
            group_has_build = True
        elif (
            isinstance(g, pe.Col)
            and g.index >= left_n
            and isinstance(probe_key, pe.Col)
            and g.index - left_n == probe_key.index
        ):
            key_in_groups = True
    if group_has_build and not key_in_groups:
        return None

    try:
        filters = [_shift_cols(f, remap) for f in fused.filters]
        group_exprs = [
            (_shift_cols(g, remap), name) for g, name in fused.group_exprs
        ]
        aggs = [
            dataclasses.replace(
                a,
                arg=_shift_cols(a.arg, remap) if a.arg is not None else None,
                arg2=(
                    _shift_cols(a.arg2, remap)
                    if a.arg2 is not None
                    else None
                ),
            )
            for a in fused.aggs
        ]
    except ExecutionError:
        return None

    return _FusedStage(
        probe,
        filters,
        group_exprs,
        aggs,
        fused.mode,
        join=DeviceJoinSpec(
            join.left, probe_key, lkey.index, build_cols
        ),
    )


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
        # device-join stages compile over a VIRTUAL schema: the probe
        # schema plus one appended field per referenced build column
        probe_schema = fused.source.schema
        if fused.join is not None:
            schema = pa.schema(
                list(probe_schema)
                + [fused.join.build.schema.field(i) for i in fused.join.build_cols]
            )
        else:
            schema = probe_schema
        self._probe_ncols = len(probe_schema)

        # the dtype mode is pinned when the stage is built: every kernel,
        # state and cache key of this stage follows it
        self._mode = K.precision_mode()
        x32 = self._mode == "x32"
        compiler = K.TorchExprCompiler(schema, self._mode)
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
            if a.func in ("median", "count_distinct"):
                # the keyed route's sorted-argument pass: each group's valid
                # values ascending by their order pair, the two middle rows
                # gathered (median) and the value runs counted (distinct);
                # the stage is forced onto that route
                if fused.mode == PARTIAL:
                    raise K.NotLowerable(f"{a.func} is single-stage")
                if not fused.group_exprs:
                    raise K.NotLowerable(f"global {a.func} stays on the CPU")
                if not isinstance(a.arg, pe.Col):
                    raise K.NotLowerable(f"{a.func} over expression")
                at = schema.field(a.arg.index).type
                ok = pa.types.is_floating(at) or pa.types.is_integer(at)
                if a.func == "count_distinct":
                    ok = ok or pa.types.is_date(at)
                if not ok:
                    raise K.NotLowerable(f"{a.func} over {at}")
                compiler.ord_pair_column(a.arg)
                pending[idx] = ("median" if a.func == "median" else "cdist",
                                a.arg.index)
                continue
            if a.func == "corr":
                # Pearson r on the keyed route, centred per group; a null or
                # NaN in either argument drops the row pairwise
                if fused.mode == PARTIAL:
                    raise K.NotLowerable("corr is single-stage")
                if not fused.group_exprs:
                    raise K.NotLowerable("global corr stays on the CPU")
                for e in (a.arg, a.arg2):
                    if not isinstance(e, pe.Col):
                        raise K.NotLowerable("corr over expression")
                    at = schema.field(e.index).type
                    if not (pa.types.is_floating(at) or pa.types.is_integer(at)):
                        raise K.NotLowerable(f"corr over {at}")
                for e in (a.arg, a.arg2):
                    # x32 buffers each argument as its exact f32 pair
                    if x32:
                        compiler.pair_column(e)
                    else:
                        compiler._leaf_column(e)
                pending[idx] = ("corr", a.arg.index, a.arg2.index)
                continue
            if a.func in ("stddev", "stddev_pop", "var", "var_pop"):
                # Σx and Σx² (each with its count) on either route; the host
                # finishes (Σx² - (Σx)²/n) / (n - ddof) behind a
                # conditioning guard.  The reference forces its sort route
                # only in x32 (compensated sums), so x64 routes as usual
                if fused.mode == PARTIAL:
                    raise K.NotLowerable("variance family is single-stage")
                if x32:
                    # x32 ships x as its exact f32 pair and squares it
                    # error-free (B12f), so the host's cancellation starts
                    # from ~48-bit moments; the stage takes the sort route
                    if not isinstance(a.arg, pe.Col):
                        raise K.NotLowerable("x32 variance over expression")
                    at = schema.field(a.arg.index).type
                    if not (pa.types.is_floating(at) or pa.types.is_integer(at)):
                        raise K.NotLowerable(f"variance over {at}")
                    pairc = compiler.pair_column(a.arg)
                    parts = [
                        (K.KernelAggSpec("sum", True, pair=True), pairc),
                        (K.KernelAggSpec("sum", True, pair=True),
                         K.square_pair_closure(pairc)),
                    ]
                else:
                    c = lower(a.arg)
                    parts = [
                        (K.KernelAggSpec("sum", True), c),
                        (K.KernelAggSpec("sum", True), K.square_closure(c)),
                    ]
                pending[idx] = ("var", 0 if a.func.endswith("_pop") else 1,
                                a.func.startswith("stddev"), parts)
                continue
            if a.func not in ("count", "sum", "avg", "min", "max"):
                # udaf:* and anything unknown: rejected at PLAN time
                raise K.NotLowerable(a.func)
            if a.func == "count" and isinstance(a.arg, pe.Col):
                count_cols.append((idx, a.arg))
                continue
            t = _infer_type(a.arg, schema)
            is_int = t is not None and pa.types.is_integer(t)
            if x32:
                pending[idx] = self._x32_agg(a, t, compiler, lower)
                continue
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
        # per-OUTPUT entries become kernel specs plus an emission plan (a
        # variance expands into two sums; median, count distinct and corr
        # read the keyed route's post-sort passes)
        specs: list[K.KernelAggSpec] = []
        arg_closures: list = []
        emit: list[tuple] = []
        self._median_cols: list[int] = []
        self._corr_cols: list[int] = []
        self._corr_pairs: list[tuple] = []
        for entry in pending:
            tag = entry[0] if isinstance(entry[0], str) else None
            if tag == "var":
                _, ddof, use_sqrt, parts = entry
                emit.append(("var", len(specs), len(specs) + 1, ddof, use_sqrt))
                for spec, closure in parts:
                    specs.append(spec)
                    arg_closures.append(closure)
            elif tag in ("median", "cdist"):
                if entry[1] not in self._median_cols:
                    self._median_cols.append(entry[1])
                emit.append((tag, self._median_cols.index(entry[1])))
            elif tag == "corr":
                slots = []
                for ci in entry[1:]:
                    if ci not in self._corr_cols:
                        self._corr_cols.append(ci)
                    slots.append(self._corr_cols.index(ci))
                # r is symmetric: corr(x, y) and corr(y, x) share one pass
                pair = tuple(sorted(slots))
                if pair not in self._corr_pairs:
                    self._corr_pairs.append(pair)
                emit.append(("corr", self._corr_pairs.index(pair)))
            else:
                emit.append(("plain", len(specs)))
                specs.append(entry[0])
                arg_closures.append(entry[1])
        self._emit = emit
        # x32 variance: the matmul and scatter routes compensate only
        # across blocks, so the stage sorts (its scan 2Sums every combine)
        self._force_sort = x32 and any(e[0] == "var" for e in emit)
        # median, count distinct and corr need the keyed route's buffers
        self._needs_keyed = bool(self._median_cols or self._corr_pairs)
        self.specs: list[K.KernelAggSpec] = specs
        self._arg_closures = arg_closures
        self._filter_closure = filter_closure
        n_fields = sum(len(K.state_fields(s, self._mode)) for s in self.specs) + 1
        if n_fields > K.MAX_FIELDS or len(self.specs) > K.MAX_COLUMNS:
            raise K.NotLowerable(f"{len(self.specs)} aggregates")
        self.leaves = compiler.leaves
        self.capacity = config.tpu_segment_capacity if fused.group_exprs else 1
        self.max_capacity = config.tpu_max_capacity if fused.group_exprs else 1
        self.keyed_buffer_bytes = config.tpu_keyed_buffer_mb << 20

        # device-join plumbing: leaves over virtual (build-side) columns
        # are gathered on the device by the join probe, never read from
        # the probe batch; validity-only leaves and host-evaluated exprs
        # cannot reference the build side
        self._join_slots: dict[str, int] = {}
        if fused.join is not None:
            for name, spec in self.leaves.items():
                if spec.kind == "cpu_expr":
                    used: set = set()
                    _cols_used(spec.cpu_expr, used)
                    if any(i >= self._probe_ncols for i in used):
                        raise K.NotLowerable("host expr over build side")
                    continue
                if spec.col_index >= self._probe_ncols:
                    if spec.kind != "column":
                        raise K.NotLowerable(f"join leaf kind {spec.kind}")
                    spec.kind = "join_col"
                    j = spec.col_index - self._probe_ncols
                    self._join_slots[name] = j
                    self._join_slots[f"{name}__valid"] = j
        # only the build columns the KERNEL reads ship to the device
        # (group-only build columns resolve on the host at materialize)
        self._device_build_cols: list[int] = []
        if fused.join is not None and self._join_slots:
            device_js = sorted(set(self._join_slots.values()))
            dense = {j: k for k, j in enumerate(device_js)}
            self._join_slots = {n: dense[j] for n, j in self._join_slots.items()}
            self._device_build_cols = [fused.join.build_cols[j] for j in device_js]
        self._flat_names = K.flat_arg_names(self.leaves)

        # group plan: which GROUP BY positions encode on the host and which
        # resolve from the build table at materialize (functionally
        # dependent on the probe join key: unique build keys)
        self._group_plan: list[tuple[str, int]] = []
        slot = 0
        for g, _n in fused.group_exprs:
            if (
                fused.join is not None
                and isinstance(g, pe.Col)
                and g.index >= self._probe_ncols
            ):
                self._group_plan.append(("build", g.index - self._probe_ncols))
            else:
                self._group_plan.append(("enc", slot))
                slot += 1
        self._n_encoded_groups = slot
        self._enc_group_exprs = [
            g
            for (g, _n), (kind, _s) in zip(fused.group_exprs, self._group_plan)
            if kind == "enc"
        ]
        self._jk_slot = self._jk_pos = None
        if fused.join is not None:
            pk = fused.join.probe_key
            for pos, (g, _n) in enumerate(fused.group_exprs):
                if (
                    self._group_plan[pos][0] == "enc"
                    and isinstance(g, pe.Col)
                    and isinstance(pk, pe.Col)
                    and g.index == pk.index
                ):
                    self._jk_slot = self._group_plan[pos][1]
                    self._jk_pos = pos
                    break
            if any(k == "build" for k, _ in self._group_plan) and (
                self._jk_slot is None
            ):
                raise K.NotLowerable("build group keys without probe key")
        self._build_state = None  # prepared once per instance
        self._build_lock = threading.Lock()
        self._nojoin: Optional[TorchStageExec] = None
        self._kernels: dict = {}
        # (exprs, n_out) installed by a downstream ShuffleWriterExec so
        # the hash-partition ids ride the device instead of the host
        self._shuffle_hint = None

    @staticmethod
    def _x32_agg(a, t, compiler, lower) -> tuple:
        """(spec, argument closure) of a count/sum/avg/min/max under x32, as
        the reference lowers it: an f64 min/max must not come back
        f32-rounded, so an f64 COLUMN rides an order pair (bit-exact) and an
        f64 expression stays on the CPU; an avg over int64 sums an exact f32
        (hi, lo) pair; a sum over int64 ships int32 values (a value past
        int32 re-runs the partition on the CPU)."""
        if a.func in ("min", "max"):
            int_mm = t is not None and (pa.types.is_integer(t) or pa.types.is_date32(t))
            if not int_mm and not (t is not None and pa.types.is_float32(t)):
                if isinstance(a.arg, pe.Col) and t is not None and pa.types.is_float64(t):
                    return (K.KernelAggSpec(a.func, True, ord_pair=True),
                            compiler.ord_pair_column(a.arg))
                raise K.NotLowerable("x32 min/max over f64 expression")
            return K.KernelAggSpec(a.func, True, int_minmax=int_mm), lower(a.arg)
        if (
            a.func == "avg" and isinstance(a.arg, pe.Col) and t is not None
            and (pa.types.is_int64(t) or pa.types.is_uint64(t))
        ):
            return K.KernelAggSpec(a.func, True, pair=True), compiler.pair_column(a.arg)
        return K.KernelAggSpec(a.func, True), lower(a.arg)

    def _build_kernels(self) -> None:
        """The CUDA kernels build on first use; that build is the stage's
        ``tpu_compile_ns``."""
        if self.device.type == "cuda":
            from .cuda import build

            if not build.is_loaded():
                with self.metrics.timer("tpu_compile_ns"):
                    build.load()
                self.metrics.add("kernel_compiles", 1)

    def _kernel_for(self, capacity: int, n_rows: int, dense: bool = False):
        """The per-batch stage function at the given segment capacity, on
        the route :func:`K.segment_algo` picks for this capacity and batch
        size (scatter, or sort above the bounds on cuda), wrapped in the
        join probe for a join-fused stage (``dense``: the slot-table form,
        decided per execution from the prepared build side's key span).
        Cached per (capacity, route, dense) on this stage, whose closures
        it holds, so a capacity growth builds the next one."""
        algo = ("sort" if self._force_sort
                else K.segment_algo(capacity, n_rows, self.device, self._mode))
        key = (capacity, algo, dense) + K.algo_cache_token()
        kernel = self._kernels.get(key)
        if kernel is None:
            kernel = K.make_partial_agg_kernel(
                self._filter_closure,
                self._arg_closures,
                self.specs,
                capacity,
                self._flat_names,
                algo=algo,
                mode=self._mode,
            )
            if self.fused.join is not None:
                kernel = K.make_join_kernel(
                    kernel,
                    self._flat_names,
                    self._join_slots,
                    len(self._device_build_cols),
                    dense=dense,
                )
            self._kernels[key] = kernel
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

    def _fused_pid_spec(self):
        """``(slots, n_out)`` when the shuffle pid column can be derived in
        the fused run, else None.

        Eligible exactly when every hint key is a host-encoded group column
        with a device-hashable type: the group table then holds every kept
        group's key codes when the run starts, so decoding them feeds the
        same partition-id kernel the post-materialize hash would run, over
        identical values, hence bit-identical pids, fetched with the state
        in one copy.  ``slots`` is ``[(enc_slot, out_pos), ...]`` in
        hint-key order (the hash combine is order-sensitive)."""
        hint = self._shuffle_hint
        if hint is None or not self.fused.group_exprs:
            return None
        exprs, n_out = hint
        if not exprs or n_out <= 0 or n_out > K.PID_MAX_PARTITIONS:
            return None
        slots = []
        for e in exprs:
            if not isinstance(e, pe.Col) or not (
                0 <= e.index < len(self._group_plan)
            ):
                return None
            kind, slot = self._group_plan[e.index]
            if kind != "enc":
                return None
            t = self._schema.field(e.index).type
            if not (
                pa.types.is_integer(t)
                or pa.types.is_floating(t)
                or pa.types.is_boolean(t)
                or pa.types.is_date(t)
                or pa.types.is_timestamp(t)
            ):
                return None
            slots.append((slot, e.index))
        return slots, n_out

    def output_partitioning(self) -> Partitioning:
        return self.fused.source.output_partitioning()

    def children(self) -> list[ExecutionPlan]:
        return [self.fused.source]

    def with_new_children(self, children):
        new_original = self.original.with_new_children(
            [_replace_leaf(self.original.input, self.fused.source, children[0])]
        )
        return _accelerate_agg(new_original, self.config, self.device) or new_original

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
        except _JoinIneligible:
            # non-unique or unshippable build keys: run the join on the
            # CPU and keep ONLY the aggregate on the device
            self.metrics.add("join_fallback", 1)
            yield from self._nojoin_stage().execute(partition, ctx)
            return
        except _SmallInput as si:
            # partition under tpu.min_rows: run the CPU operator path over
            # the batches the peek already pulled (no source re-scan), and
            # OUTSIDE this try so real CPU errors propagate
            self.metrics.add("cpu_fallback", 1)
            cpu_plan = self._replay(si.batches)
        except _KeyedRoute as kr:
            # device-keyed aggregation; only the data-dependent exits
            # (cardinality past tpu.max_capacity, keys that cannot ship,
            # the median/corr buffer budget, the variance guard) hand the
            # partition to the CPU operators.  A device error raises
            self.metrics.add("keyed_path", 1)
            tail = _TrackingIter(kr.tail)
            try:
                host_states, groups, n_rows_in, aux = self._run_keyed(
                    kr.batches, tail, kr.key_encoders, ctx
                )
                out_batches = list(self._materialize(
                    host_states, kr.key_encoders, groups, n_rows_in, ctx,
                    partition, aux=aux,
                ))
            except (_CapacityExceeded, _KeyedFallback, _VarianceGuard):
                self.metrics.add("tpu_fallback", 1)
                if not tail.consumed:
                    # the live source was never touched: replay the
                    # buffered batches and chain the tail (no re-scan)
                    cpu_plan = self._replay([b for b, _ in kr.batches], tail)
                else:
                    if kr.ra is not None:
                        kr.ra.close()
                    cpu_plan = self.original
                yield from cpu_plan.execute(partition, ctx)
                return
            yield from out_batches
            return
        except _VarianceGuard:
            self.metrics.add("tpu_fallback", 1)
            cpu_plan = self.original
        except _HighCardinality as hc:
            # groups ~ rows: hand the stage to the CPU hash aggregate,
            # replaying the consumed batch + chaining the live source
            self.metrics.add("highcard_fallback", 1)
            cpu_plan = self._replay(hc.batches, hc.tail)
        except (_CapacityExceeded, K.X32RangeError):
            # the group table outgrew tpu.max_capacity or its 62-bit key
            # space, or (x32) a value past what int32/float32 pairs carry.
            # Nothing else goes to the CPU: a device, kernel or bridge
            # failure raises
            self.metrics.add("tpu_fallback", 1)
            if self.fused.join is not None:
                # a join-fused stage's group table holds every distinct
                # PROBE key before the join filters rows; the unfolded
                # shape (join on the CPU, aggregate on the device over the
                # joined rows) keys it on the surviving groups only, and
                # its own execute still falls to the CPU if that overflows
                self.metrics.add("join_fallback", 1)
                yield from self._nojoin_stage().execute(partition, ctx)
                return
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

    # ------------------------------------------------------- device join
    def _nojoin_stage(self) -> "TorchStageExec":
        """Sibling stage with the join UNFOLDED (join on the CPU, aggregate
        on the device) for data the device join cannot take; it shares
        this stage's metrics bag."""
        with self._build_lock:
            if self._nojoin is None:
                fused = _flatten(self.original, fold_join=False)
                nojoin = TorchStageExec(self.original, fused, self.config, self.device)
                nojoin.metrics = self.metrics
                self._nojoin = nojoin
            return self._nojoin

    def _prepare_build(self, ctx: TaskContext):
        """Collect and sort the build side once per stage instance: device
        tensors for the probe, host copies of the sorted keys and the build
        table for group-key resolution at materialize.

        Returns ``("empty",)``, ``("dense", table, bvals, bvalids,
        sorted_keys, build_table, kmin)`` when the key span fits
        ``_DENSE_JOIN_SPAN_CAP`` (counted as ``dense_join``), or ``("ok",
        bkeys, bvals, bvalids, sorted_keys, build_table)``.  Raises
        :class:`_JoinIneligible` on duplicate keys or build columns the
        bridge cannot ship."""
        from .bridge import arrow_to_numpy

        with self._build_lock:
            if self._build_state is not None:
                return self._build_state
            spec = self.fused.join
            batches = []
            for p in range(spec.build.output_partitioning().n):
                for b in spec.build.execute(p, ctx):
                    ctx.check_cancelled()
                    if b.num_rows:
                        batches.append(b)
            if batches:
                table = pa.Table.from_batches(batches, schema=spec.build.schema)
            else:
                table = spec.build.schema.empty_table()
            kv, kvalid = arrow_to_numpy(
                table.column(spec.build_key_index).combine_chunks()
            )
            kv = kv.astype(np.int64)
            if kvalid is not None:
                table = table.filter(pa.array(kvalid))
                kv = kv[kvalid]  # null build keys never match an inner join
            order = np.argsort(kv, kind="stable")
            kv_sorted = kv[order]
            if len(kv_sorted) > 1 and bool(np.any(kv_sorted[1:] == kv_sorted[:-1])):
                raise _JoinIneligible("device join requires unique build keys")
            table = table.take(pa.array(order))

            if len(kv_sorted) == 0:
                self._build_state = ("empty",)
                return self._build_state

            dev = self.device
            try:
                # x32: int32 build keys and f32/int32 build columns (a key
                # or value past them joins on the CPU: _JoinIneligible)
                bkeys = torch.from_numpy(
                    K.coerce_host_values(kv_sorted, self._mode).copy()
                ).to(dev)
                bvals, bvalids = [], []
                for ci in self._device_build_cols:
                    vals, validity = arrow_to_numpy(table.column(ci).combine_chunks())
                    bvals.append(torch.from_numpy(
                        K.coerce_host_values(vals, self._mode).copy()
                    ).to(dev))
                    bvalids.append(
                        None if validity is None
                        else torch.from_numpy(validity.copy()).to(dev)
                    )
            except ExecutionError as e:
                # unshippable column ranges or types: join on the CPU,
                # aggregate on the device (not a full CPU fallback)
                raise _JoinIneligible(str(e)) from e
            kmin = int(kv_sorted[0])
            span = int(kv_sorted[-1]) - kmin + 1
            if span <= _DENSE_JOIN_SPAN_CAP:
                # dense direct probe: one slot-table read per probe row
                # instead of a binary search over the sorted keys
                span_b = max(16, 1 << (span - 1).bit_length())
                self._build_state = (
                    "dense", K.join_build_table(bkeys, kmin, span_b), bvals,
                    bvalids, kv_sorted, table, kmin,
                )
                self.metrics.add("dense_join", 1)
                return self._build_state
            self._build_state = ("ok", bkeys, bvals, bvalids, kv_sorted, table)
            return self._build_state

    def _cache_key(self, ctx: TaskContext):
        """(provider, signature) when the stage source is a cacheable scan."""
        if not ctx.config.tpu_cache_columns:
            return None
        from ..exec.operators import ScanExec

        node = self.fused.source
        while isinstance(node, RenameSchemaExec):
            node = node.children()[0]
        if not isinstance(node, ScanExec):
            return None
        # leaf col_index values are scan-relative, so the signature must pin
        # the scan's actual column identity (projection / schema names) or
        # two queries over different columns of the same provider collide
        source_cols = ",".join(self.fused.source.schema.names)
        sig = "|".join(
            [f"{s.kind}:{s.col_index}:{s.cpu_expr}" for s in self.leaves.values()]
            + [str(g) for g, _ in self.fused.group_exprs]
            + [f"proj={node.projection}", f"cols={source_cols}"]
            + [str(ctx.batch_size), f"cap={self.capacity}", self._mode]
        )
        return node.provider, sig

    def _execute_device(
        self, partition: int, ctx: TaskContext
    ) -> Iterator[pa.RecordBatch]:
        from . import device_cache

        fused = self.fused
        build = None
        if fused.join is not None:
            with self.metrics.timer("join_build_time_ns"):
                build = self._prepare_build(ctx)
            if build[0] == "empty":
                # inner join against an empty build side: no rows at all
                yield from self._materialize(None, [], None, 0, ctx, partition)
                return
        # the device column cache keys on scan inputs; join stages add
        # build-side state and keyed stages buffer raw keys, so both skip it
        ck = (
            self._cache_key(ctx)
            if fused.join is None and not self._needs_keyed
            else None
        )
        # whole-stage fusion plan (ballista.tpu.whole_stage_fusion; off by
        # default, which leaves the launches unchanged): when every compute
        # op lands in segment 0 the batches are retained and the stage runs
        # as ONE multi-entry launch even without a cache key, with the
        # shuffle pid row fetched beside the state when the pid op fused too
        fuse_pid = False
        fusion_retain = False
        if (
            fused.join is None
            and not self._needs_keyed
            and self.config.tpu_whole_stage_fusion
        ):
            from .fusion import plan_segments, stage_ops

            fplan = plan_segments(stage_ops(self), _FUSION_MAX_OPS)
            self.metrics.add("fused_segments", len(fplan.segments))
            self.metrics.add("fused_ops_per_dispatch", fplan.max_segment_ops)
            fusion_retain = fplan.compute_fused()
            fuse_pid = fplan.pid_fused()
        if ck is not None:
            cached = device_cache.get(ck[0], partition, ck[1])
            if cached is not None:
                # no scan, no host encode, no bridge: the retained device
                # entries and group ids replay through the fused runner
                entries, key_encoders, group_table, n_rows_in, cap = cached
                with self.metrics.timer("tpu_stage_time_ns"):
                    with self.metrics.timer("device_time_ns"):
                        host_states, pids = self._run_fused(
                            entries, cap,
                            group_table if fused.group_exprs else None,
                            key_encoders, fuse_pid,
                        )
                self.metrics.add("cache_hits", 1)
                yield from self._materialize(
                    host_states, key_encoders, group_table, n_rows_in, ctx,
                    partition, fused_pids=pids,
                )
                return

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

        # encoders exist only for host-ENCODED group positions (build-side
        # group keys resolve from the build table at materialize)
        key_encoders = [
            make_key_encoder(self._schema.field(pos).type)
            for pos, (kind, _s) in enumerate(self._group_plan)
            if kind == "enc"
        ]
        group_table = GroupTable(max(self._n_encoded_groups, 1))
        staging = DeviceStaging(self.device)
        launches: list = []  # (start, end) CUDA events per launch
        # cache-eligible and fusion-retaining stages keep each batch's
        # device tensors and run them all after the stream
        retain = ck is not None or fusion_retain
        entries: list = []

        state = None
        fused_pids = None
        n_rows_in = 0
        cap = self.capacity
        dense_join = build is not None and build[0] == "dense"
        self._build_kernels()
        with _closing_on_error(ra), self.metrics.timer("tpu_stage_time_ns"):
            for batch in src:
                if batch.num_rows == 0:
                    continue
                n = batch.num_rows
                n_rows_in += n
                first = state is None and not entries

                if fused.group_exprs:
                    if first:
                        # keyed-pinned stages whose keys encode on the
                        # device route BEFORE any host group encode: the
                        # raw key columns cross the bridge and
                        # key_encode_time_ns stays about 0
                        fast = self._keyed_fast_encoders(batch)
                        if fast is not None:
                            raise _KeyedRoute([(batch, None)], src, fast, ra)
                    with self.metrics.timer("key_encode_time_ns"):
                        codes = self._encode_codes(batch, key_encoders)
                    # x32: key codes past 32 bits cannot ship to the keyed
                    # route; the host-assigned gids of the basic route are
                    # dense int32, so that route stays available
                    keyed_ok = not first or self._mode != "x32" or all(
                        _fits_x32_code(c) for c in codes
                    )
                    if first and self._needs_keyed:
                        # median, count distinct and corr live on the keyed
                        # route at any cardinality; keys it cannot take
                        # re-run the partition on the CPU operators
                        if not keyed_ok:
                            raise K.X32RangeError("group key codes exceed 32 bits")
                        raise _KeyedRoute([(batch, codes)], src, key_encoders, ra)
                    if first:
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
                            if keyed_route_wanted(self.config) and keyed_ok:
                                raise _KeyedRoute([(batch, codes)], src,
                                                  key_encoders, ra)
                            # 'gid' pins the group table while it fits
                            pinned = (
                                self.config.tpu_highcard_mode == "gid"
                                and first_groups is not None
                            )
                            if fused.join is None and not pinned:
                                raise _HighCardinality([batch], src)
                            # a fused device join at high cardinality stays
                            # on the group table while it can fit; but the
                            # table keys on every distinct PROBE key before
                            # the join filters, so when batch 1 alone fills
                            # half the ceiling, bail to the unfolded shape
                            # now rather than after encoding the stream
                            if fused.join is not None and (
                                first_groups is None
                                or first_groups > self.max_capacity // 2
                            ):
                                raise _CapacityExceeded()
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

                with self.metrics.timer("bridge_time_ns"):
                    args = self._kernel_args(batch, n, seg, staging, build)
                with self.metrics.timer("device_time_ns"):
                    gid = args.pop()
                    if gid is None:
                        gid = torch.zeros(n, dtype=torch.int32, device=self.device)
                    if retain:
                        # a retained tensor must own its memory: on the
                        # CPU a staged tensor aliases its numpy array (on
                        # cuda the copy out of the pinned buffer is fresh)
                        if self.device.type == "cpu":
                            gid = gid.clone()
                            args = [None if a is None else a.clone() for a in args]
                        entries.append((gid, None, args))
                        continue
                    kernel = self._kernel_for(cap, n, dense_join)
                    state = self._timed(
                        launches,
                        lambda: kernel(gid, None, *args, state=state),
                    )

            # the fetch waits for every launch, so the device timer covers
            # queue + compute + result copy
            with self.metrics.timer("device_time_ns"):
                if entries:
                    host_states, fused_pids = self._run_fused(
                        entries, cap,
                        group_table if fused.group_exprs else None,
                        key_encoders, fuse_pid,
                        # below the amortization floor the retained entries
                        # stream instead (the cache path always fuses)
                        stream=ck is None and n_rows_in < _FUSION_MIN_ROWS,
                    )
                else:
                    host_states = self._fetch_states(
                        state, group_table.n_groups if fused.group_exprs else None
                    )
            self._add_launch_times(launches)

        if ck is not None and entries:
            device_cache.put(
                ck[0], partition, ck[1],
                (entries, key_encoders, group_table, n_rows_in, cap),
            )
        yield from self._materialize(
            host_states, key_encoders, group_table, n_rows_in, ctx, partition,
            fused_pids=fused_pids,
        )

    def _timed(self, launches: list, call):
        """Run one kernel call: timed by CUDA events appended to
        ``launches`` on cuda (read after the fetch), by the host clock into
        ``tpu_execute_ns`` on the CPU."""
        if self.device.type != "cuda":
            t0 = time.perf_counter_ns()
            out = call()
            self.metrics.add("tpu_execute_ns", time.perf_counter_ns() - t0)
            return out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = call()
        end.record()
        launches.append((start, end))
        return out

    def _add_launch_times(self, launches: list) -> None:
        for start, end in launches:
            self.metrics.add("tpu_execute_ns", int(start.elapsed_time(end) * 1e6))

    def _entries_kernel(self, capacity: int):
        """The multi-entry stage function at ``capacity`` (cached)."""
        key = ("entries", capacity) + K.algo_cache_token()
        fn = self._kernels.get(key)
        if fn is None:
            fn = K.make_entries_agg_kernel(
                self._filter_closure, self._arg_closures, self.specs, capacity,
                self._flat_names, mode=self._mode, force_sort=self._force_sort,
            )
            self._kernels[key] = fn
        return fn

    def _run_fused(
        self, entries: list, cap: int, group_table, key_encoders, fuse_pid: bool,
        stream: bool = False,
    ) -> tuple:
        """ONE multi-entry launch over the retained entries at the final
        capacity, then ONE fetch of the kept groups' states (with the
        shuffle pid row beside them when ``fuse_pid`` and the hint keys
        allow): ``(host_states, pids or None)``.

        Past ``_FUSED_MAX_ENTRIES``, under ``stream``, or when the final
        capacity takes the sort route (B13a is a scatter-route kernel;
        counted as ``fused_streamed``), each entry runs its own one-batch
        launch into one state instead.  A failed launch raises: nothing
        re-runs the entries another way."""
        if self.fused.join is not None:
            # cache- and fusion-retained stages are join-free; a join-fused
            # stage's kernel needs the build side, which entries do not hold
            raise ExecutionError("the fused runner takes join-free stages only")
        launches: list = []
        n_groups = group_table.n_groups if group_table is not None else None
        # x32's entries runner takes every route itself (one route launch
        # and one merge per entry)
        sort_route = self._mode == "x64" and any(
            K.segment_algo(cap, gid.shape[0], self.device) != "scatter"
            for gid, _tail, _args in entries
        )
        if sort_route:
            self.metrics.add("fused_streamed", 1)
        if stream or sort_route or len(entries) > _FUSED_MAX_ENTRIES:
            state = None
            for gid, tail, args in entries:
                kernel = self._kernel_for(cap, gid.shape[0])
                state = self._timed(
                    launches, lambda: kernel(gid, tail, *args, state=state)
                )
            host_states = self._fetch_states(state, n_groups)
            self._add_launch_times(launches)
            return host_states, None
        keep = None if n_groups is None else _keep_bucket(n_groups)
        pid = None
        spec = self._fused_pid_spec() if fuse_pid and n_groups is not None else None
        if spec is not None:
            # the group table is complete: every group's hint-key values
            # decode now and their ids ride the same fetch as the state
            slots, n_out = spec
            arrays = [
                key_encoders[slot].decode(
                    group_table.codes_for(np.arange(n_groups), slot),
                    self._schema.field(pos).type,
                )
                for slot, pos in slots
            ]
            bits = K.pid_key_bits(arrays, min(keep, cap), self.device)
            if bits is not None:
                pid = (bits, n_out)
        fn = self._entries_kernel(cap)
        state = self._timed(launches, lambda: fn(entries))
        self.metrics.add("fused_dispatches", 1)
        if pid is None:
            host_states = self._fetch_states(state, n_groups)
            pids = None
        else:
            (bits, nulls), n_out = pid
            packed, pids = K.fetch_states_with_pids(state, keep, bits, nulls, n_out)
            host_states = K.unpack_host(self.specs, packed)
            self.metrics.add("fused_pid_in_kernel", 1)
        self._add_launch_times(launches)
        return host_states, pids

    def _kernel_args(self, batch, n: int, seg, staging, build=None, keys=None):
        """The stage function's per-batch tensors on the device: the
        non-join flat args in order, then, for a join-fused stage, the
        probe key (int64) and its validity, the dense slot table and kmin
        or the sorted build keys, the build values and their validities;
        last the group ids (None for a global aggregate).  All-valid
        companions travel as ``None``: no bytes cross.  With ``keys`` (the
        keyed route's per-key host operand tuples) they cross in the same
        staging and ``(args, device key tuples)`` is returned."""
        trivial: set = set()
        env = K.build_env(batch, self.leaves, n, trivial_valid=trivial, mode=self._mode)
        names = [nm for nm in self._flat_names if nm not in self._join_slots]
        host = {nm: (None if nm in trivial else env[nm]) for nm in names}
        host["__gid__"] = seg
        for k, ops in enumerate(keys or ()):
            for j, a in enumerate(ops):
                host[f"__key{k}_{j}__"] = a
        if build is not None:
            from .bridge import arrow_to_numpy

            pkv, pk_valid = arrow_to_numpy(_eval_arr(self.fused.join.probe_key, batch))
            pkv = pkv.astype(np.int64)
            if self._mode == "x32":
                # probe keys outside int32 cannot match the range-checked
                # build keys: masked, not failed (as the reference)
                in_range = (pkv >= -(1 << 31)) & (pkv < (1 << 31))
                if not in_range.all():
                    pk_valid = in_range if pk_valid is None else pk_valid & in_range
                    pkv = np.where(in_range, pkv, 0)
                pkv = pkv.astype(np.int32)
            host["__pkey__"] = pkv
            host["__pkey_valid__"] = pk_valid
        dev = staging.put(host)
        args = [dev[nm] for nm in names]
        if build is not None:
            args += [dev["__pkey__"], dev["__pkey_valid__"], build[1]]
            if build[0] == "dense":
                args.append(build[6])  # kmin
            args += build[2] + build[3]  # build values, validities
        args.append(dev["__gid__"])
        if keys is None:
            return args
        return args, [
            tuple(dev[f"__key{k}_{j}__"] for j in range(len(ops)))
            for k, ops in enumerate(keys)
        ]

    # ---------------------------------------------------- keyed aggregate
    def _key_kinds_for(self, key_encoders) -> tuple:
        """Per-encoded-key device-encode kind ("code" = host encode, the
        dictionary handoff), from the encoder instances in play so code
        spaces never mix across batches."""
        from .bridge import BoolKeyEncoder, FloatKeyEncoder, IdentityKeyEncoder

        if not self.config.tpu_device_encode:
            return tuple("code" for _ in key_encoders)
        kinds = []
        for enc in key_encoders:
            if isinstance(enc, IdentityKeyEncoder):
                kinds.append("ident")
            elif isinstance(enc, BoolKeyEncoder):
                kinds.append("bool")
            elif isinstance(enc, FloatKeyEncoder):
                kinds.append(enc.kind)
            else:
                kinds.append("code")
        return tuple(kinds)

    def _keyed_fast_encoders(self, batch) -> Optional[list]:
        """Encoder set of the PRE-ENCODE keyed path, or None when this stage
        takes the host-encode routing: the stage is pinned keyed (median,
        count distinct or corr, or ``highcard_mode=device``), device encode
        is on and at least one key has a device kind.  The port's identity
        codes are zigzag images, so negative keys need no precheck (the
        reference's value+1 codes send them back to its host route); in
        x32 an identity key of the first batch whose zigzag code passes 32
        bits sends the stage to that routing, as the reference's past-i32
        precheck does, and an f64 key stays on the host dictionary."""
        cfg = self.config
        if not cfg.tpu_device_encode:
            return None
        if not (self._needs_keyed or cfg.tpu_highcard_mode == "device"):
            return None
        from .bridge import device_key_encoder

        encs, kinds = [], []
        for pos, (kind, _s) in enumerate(self._group_plan):
            if kind != "enc":
                continue
            enc, k = device_key_encoder(self._schema.field(pos).type, self._mode)
            encs.append(enc)
            kinds.append(k)
        if not encs or all(k is None for k in kinds):
            return None
        if self._mode == "x32":
            from .bridge import arrow_to_numpy

            for k, g in zip(kinds, self._enc_group_exprs):
                if k != "ident":
                    continue
                try:
                    vals, _valid = arrow_to_numpy(_eval_arr(g, batch))
                except ExecutionError:
                    return None
                if not _fits_x32_ident(vals):
                    return None
        return encs

    def _keyed_key_ops(self, batch, kinds, key_encoders, codes,
                       key_state: Optional[dict] = None) -> list:
        """Per-key host operands of one batch: ``(codes,)`` for kind "code"
        (``codes`` reuses the routing batch's host codes), else the RAW key
        column as ``(values, validity-or-None)``.  A key the device cannot
        code raises: an identity key of magnitude 2^61 or more needs a wider
        code (:class:`_CapacityExceeded`, as the host encoder's
        RadixOverflow), and a float key holding the reserved null pattern
        has no code (:class:`_KeyedFallback`).

        ``key_state`` tracks each key's running span of the words K1 sorts
        (the reference's ``note_range``) over every row of the batch, the
        filtered ones too: host codes as shipped (x32: their signed 32-bit
        words), identity keys their zigzag images (null 0; x32: the signed
        words), booleans 0..2; a float key has none (signed bit patterns:
        no fold).  :func:`_radix_combine_bits` plans the fold from it."""
        from .bridge import arrow_to_numpy

        def note(slot: int, span) -> None:
            if key_state is None:
                return
            _note_range(key_state, slot, span)

        ops: list = []
        for slot, (kind, enc) in enumerate(zip(kinds, key_encoders)):
            g = self._enc_group_exprs[slot]
            if kind == "code":
                if codes is not None and codes[slot] is not None:
                    c = codes[slot]
                else:
                    with self.metrics.timer("key_encode_time_ns"):
                        c = self._encode_codes_one(slot, enc, batch)
                if self._mode == "x32":
                    # x32 ships each code's 32-bit word
                    if not _fits_x32_code(c):
                        raise _KeyedFallback("group key codes outgrew 32 bits")
                    c = (c.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
                if len(c):
                    note(slot, (int(c.min()), int(c.max())))
                ops.append((c,))
                continue
            vals, valid = arrow_to_numpy(_eval_arr(g, batch))
            vals = K.key_host_values(kind, vals)
            if kind == "ident" and self._mode == "x32":
                # x32 ships int32 keys whose zigzag codes fit 32 bits; a
                # later batch past them re-runs the partition on the CPU
                if not _fits_x32_ident(vals):
                    raise _KeyedFallback("group key outgrew the x32 key codes")
                vals = vals.astype(np.int32)
            elif kind == "ident":
                if len(vals) and (
                    int(vals.max()) >= K.IDENT_KEY_LIMIT
                    or int(vals.min()) <= -K.IDENT_KEY_LIMIT
                ):
                    raise _CapacityExceeded()
            elif kind in ("f32", "f64"):
                bits = vals.view(np.int32 if kind == "f32" else np.int64)
                null = K.FLOAT32_NULL_BITS if kind == "f32" else K.FLOAT64_NULL_BITS
                hit = bits == null
                if valid is not None:
                    hit &= valid
                if bool(np.any(hit)):
                    raise _KeyedFallback(
                        "float group key collides with the reserved null pattern"
                    )
            if kind == "ident" and len(vals):
                note(slot, _zigzag_span(vals, valid, self._mode == "x32"))
            elif kind == "bool":
                note(slot, (0, 2))
            elif kind in ("f32", "f64"):
                note(slot, None)
            ops.append((vals, valid))
        return ops

    def _encode_codes_one(self, slot: int, enc, batch) -> np.ndarray:
        """One key's host codes; a code past the group table's 62 bits is a
        capacity fallback."""
        from .groups import RadixOverflow

        try:
            return enc.encode(_eval_arr(self._enc_group_exprs[slot], batch))
        except RadixOverflow:
            raise _CapacityExceeded()

    def _median_extra_names(self) -> tuple:
        """Env names of the median/count-distinct and corr argument leaves,
        buffered raw through the keyed prep for the post-sort passes."""
        out: list[str] = []
        for ci in self._median_cols:
            base = f"col_{ci}__ordpair"
            out.extend([f"{base}__ohi", f"{base}__olo", f"{base}__valid"])
        for ci in self._corr_cols:
            if self._mode == "x32":
                base = f"col_{ci}__pair"
                out.extend([f"{base}__hi", f"{base}__lo", f"{base}__valid"])
            else:
                out.extend([f"col_{ci}", f"col_{ci}__valid"])
        return tuple(out)

    def _keyed_prep(self, kinds: tuple, dense: bool = False):
        """The keyed route's per-batch function (cached per key kinds and
        join form), wrapped in the join probe for a join-fused stage."""
        key = ("keyed_prep", kinds, dense)
        fn = self._kernels.get(key)
        if fn is None:
            fn = K.make_keyed_prep_kernel(
                self._filter_closure, self._arg_closures, self.specs,
                self._flat_names, kinds, extra_names=self._median_extra_names(),
                mode=self._mode,
            )
            layout = fn.layout
            if self.fused.join is not None:
                fn = K.make_join_kernel(
                    fn, self._flat_names, self._join_slots,
                    len(self._device_build_cols), dense=dense,
                )
                fn.layout = layout
            self._kernels[key] = fn
        return fn

    def _run_keyed(self, first: list, src, key_encoders, ctx: TaskContext):
        """Device-keyed aggregation: per batch the filter (and the join
        probe) and the key encode run on the device and the masked scan
        columns buffer there beside the key codes; at the end of the stream
        ONE radix sort assigns group ids from key changes, one segmented
        scan reduces every aggregate, and one packed fetch returns the
        states and the unique key codes.

        Single dispatch (the reference's ``pending`` / ``fuse``): each
        batch is bridged as it comes and waits in ``pending``; a stream of
        at most ``_FUSED_MAX_ENTRIES`` batches whose host bytes (args and
        key operands, not the shared join build) stay under
        ``keyed_buffer_bytes`` codes every batch's keys in ONE entry-wise
        launch at the end (:meth:`_keyed_reduce_fused`), folded into one
        sort word when the stream's code spans allow.  Past either bound
        the pending batches drain through the per-batch prep and the rest
        streams: past ``keyed_buffer_bytes`` the buffered block is reduced
        now and the blocks merge by key on the host at the end
        (``merge_keyed_host``).  Both budgets count the bytes the
        reference buffers for the batch (:class:`_BudgetWidths`), so the
        drain and every flush fall where the reference's do.

        Returns ``(host_states, _KeyedGroups, n_rows_in, aux)``, ``aux``
        holding the median and corr passes' packed results; raises
        :class:`_CapacityExceeded` past tpu.max_capacity and
        :class:`_KeyedFallback` for data the route cannot take."""
        from .bridge import DeviceStaging

        build = None
        if self.fused.join is not None:
            # prepared by the _execute_device run that raised _KeyedRoute
            build = self._prepare_build(ctx)
        kinds = self._key_kinds_for(key_encoders)
        prep = self._keyed_prep(kinds, dense=build is not None and build[0] == "dense")
        signed = self._signed_key_slots(key_encoders)
        staging = DeviceStaging(self.device)
        self._build_kernels()
        n_keys = self._n_encoded_groups
        buf: list = []
        chunks: list = []
        buffered = 0
        n_rows_in = 0
        device_kinds = any(k != "code" for k in kinds)
        key_state: dict = {}
        pending: list = []  # (device key tuples, args) of each waiting batch
        pending_bytes = 0
        fuse = True
        widths = _BudgetWidths(self, kinds, build is not None)

        def flush():
            nonlocal buf, buffered
            if not buf:
                return
            if self._median_cols or self._corr_pairs:
                # order statistics need every row in ONE sort: refuse the
                # unbounded buffer before the device runs out of memory
                raise _KeyedFallback("keyed buffer budget exceeded by median/corr")
            states, key_codes, n_groups, _post = self._keyed_reduce(buf, prep, signed)
            chunks.append((states, key_codes, n_groups))
            self.metrics.add("keyed_chunks", 1)
            buf, buffered = [], 0

        def dispatch_prep(keys, args):
            nonlocal buffered
            with self.metrics.timer("device_time_ns"):
                out = prep(keys, None, *args)
            buf.append(out)
            buffered += widths.device_bytes(out)
            if self.keyed_buffer_bytes and buffered >= self.keyed_buffer_bytes:
                flush()

        def feed(batch, codes):
            nonlocal pending_bytes, fuse
            n = batch.num_rows
            host_keys = self._keyed_key_ops(batch, kinds, key_encoders, codes, key_state)
            with self.metrics.timer("bridge_time_ns"):
                args, keys = self._kernel_args(batch, n, None, staging, build,
                                               keys=host_keys)
            args.pop()  # no host group ids on this route
            if device_kinds:
                self.metrics.add("device_encode_batches", 1)
            widths.note_keys(host_keys)
            if fuse:
                ebytes = widths.host_bytes(n, args)
                if len(pending) < _FUSED_MAX_ENTRIES and (
                    not self.keyed_buffer_bytes
                    or pending_bytes + ebytes < self.keyed_buffer_bytes
                ):
                    pending.append((keys, args))
                    pending_bytes += ebytes
                    return
                # past the entry cap or the budget: drain into streaming mode
                fuse = False
                for entry in pending:
                    dispatch_prep(*entry)
                pending.clear()
            dispatch_prep(keys, args)

        with self.metrics.timer("tpu_stage_time_ns"):
            for batch, codes in first:
                n_rows_in += batch.num_rows
                feed(batch, codes)
            for batch in src:
                if batch.num_rows == 0:
                    continue
                n_rows_in += batch.num_rows
                feed(batch, None)

            if chunks:
                flush()
                merge = (K.merge_keyed_host_x32 if self._mode == "x32"
                         else K.merge_keyed_host)
                with self.metrics.timer("keyed_merge_time_ns"):
                    merged, merged_keys, n_groups = merge(self.specs, chunks)
                if n_groups > self.max_capacity:
                    raise _CapacityExceeded()
                return (merged, _KeyedGroups(merged_keys, n_groups), n_rows_in,
                        {"median": [], "corr": []})

            if pending:
                # the fold belongs to the device encode, as in the reference:
                # a stage whose keys are all host-coded sorts them unfolded
                fold = _radix_combine_bits(key_state, n_keys) if device_kinds else None
                states, key_codes, n_groups, post = self._keyed_reduce_fused(
                    pending, prep, kinds, signed, fold)
            else:
                states, key_codes, n_groups, post = self._keyed_reduce(buf, prep, signed)
            inv, codes, extras, perm, gids, cap = post
            med_results: list = []
            corr_results: list = []
            x32 = self._mode == "x32"
            with self.metrics.timer("device_time_ns"):
                for j in range(len(self._median_cols)):
                    ohi, olo, ovalid = extras[3 * j:3 * j + 3]
                    med = K.keyed_median(inv, codes, ohi, olo, ovalid, cap,
                                         K.index_dtype(self._mode))
                    med_results.append(med.cpu().numpy())
                base = 3 * len(self._median_cols)
                w = 3 if x32 else 2  # buffered tensors per corr argument
                for sx, sy in self._corr_pairs:
                    xa = extras[base + w * sx:base + w * sx + w]
                    ya = extras[base + w * sy:base + w * sy + w]
                    corr = K.keyed_corr_x32 if x32 else K.keyed_corr
                    packed = corr(gids["s2"], perm, gids["gid_in"], *xa, *ya, cap)
                    corr_results.append(packed.cpu().numpy())
        aux = {"median": med_results, "corr": corr_results}
        return states, _KeyedGroups(key_codes, n_groups), n_rows_in, aux

    def _buffered_fields(self, buf: list) -> tuple:
        """The buffered batches' scan values, validities and extras, each
        joined over the batches: ``(values, valids, extras)``."""
        lengths = [b.rows for b in buf]

        def field(get) -> Optional[torch.Tensor]:
            return _concat([get(b) for b in buf], lengths)

        values = [field(lambda b, c=c: b.values[c]) for c in range(len(buf[0].values))]
        valids = [field(lambda b, c=c: b.valids[c]) for c in range(len(buf[0].values))]
        extras = [field(lambda b, e=e: b.extras[e])
                  for e in range(len(self._median_extra_names()))]
        return values, valids, extras

    def _keyed_reduce(self, buf: list, prep, signed: tuple = ()):
        """ONE sort + segmented scan + packed fetch over the buffered
        batches.  Returns ``(host_states, key_codes, n_groups, post)`` with
        ``post = (inv, codes, extras, perm, gids, cap)`` for the median and
        corr passes; raises :class:`_CapacityExceeded` past
        tpu.max_capacity."""
        n_keys = self._n_encoded_groups
        with self.metrics.timer("device_time_ns"):
            lengths = [b.rows for b in buf]
            inv = _concat([b.inv for b in buf], lengths)
            codes = [_concat([b.codes[k] for b in buf], lengths) for k in range(n_keys)]
            fields = self._buffered_fields(buf)
        return self._keyed_sort_finish(inv, codes, fields, prep, signed)

    def _keyed_reduce_fused(self, pending: list, prep, kinds: tuple, signed: tuple,
                            fold: Optional[tuple]):
        """The single-dispatch runner over the pending batches (the
        reference's ``_keyed_reduce_fused``): each batch's B3 program and
        join probe run once per batch, then ONE entry-wise launch
        (:func:`K.keyed_encode_entries`) writes every batch's sort operand
        and key codes, folded into one word by ``fold``
        (:func:`_radix_combine_bits`), straight into the concatenated
        operands; K1 sorts ``[inv, comb]`` (or ``[inv, *codes]``) once, and
        the finish unfolds each group's word into its key codes.  Same
        return contract as :meth:`_keyed_reduce`; with ``fold`` the codes
        in ``post`` are ``[comb]``, which orders the rows as the keys do."""
        code_dtype = K.index_dtype(self._mode)
        with self.metrics.timer("device_time_ns"):
            buf = [prep(keys, None, *args, encode=False) for keys, args in pending]
            entries = [(b.keys, b.masks, b.rows) for b in buf]
            inv, codes = K.keyed_encode_entries(kinds, entries, fold, code_dtype)
            self.metrics.add("fused_keyed_dispatches", 1)
            fields = self._buffered_fields(buf)
        return self._keyed_sort_finish(inv, codes, fields, prep, signed, fold)

    def _keyed_sort_finish(self, inv, codes: list, fields: tuple, prep, signed: tuple,
                           fold: Optional[tuple] = None):
        """K1 and the gid kernel over ``[inv, *codes]``, the one read of
        ``n_groups``, the capacity check, and the finish into the packed
        layout; ``fold`` when ``codes`` is the folded word."""
        if self._mode == "x32":
            ops = cols = None
        else:
            _columns, ops, cols = prep.layout
        n_keys = self._n_encoded_groups
        values, valids, extras = fields
        with self.metrics.timer("device_time_ns"):
            perm, gids, n_groups = K.keyed_sort(inv, codes)
        if n_groups > self.max_capacity:
            raise _CapacityExceeded()
        cap = max(64, 1 << (max(n_groups, 1) - 1).bit_length())
        if self._mode == "x32":
            layout = prep.layout
            columns, field_col = K._x32_scan_plan(layout, values, valids)
            finish, ops = K.keyed_finish_x32, layout.ops
        else:
            columns, field_col = K._build_scan_plan(values, valids, ops, cols)
            finish = K.keyed_finish
        with self.metrics.timer("device_time_ns"):
            packed = finish(self.specs, columns, field_col, ops, perm, gids,
                            n_groups, cap, fold)
            host = packed.cpu().numpy()
        states, key_codes = K.unpack_keyed_host(self.specs, host, n_keys, signed)
        return states, key_codes, n_groups, (inv, codes, extras, perm, gids, cap)

    @staticmethod
    def _signed_key_slots(key_encoders) -> tuple:
        """Encoded key slots whose x32 code words widen signed: f32 bit
        patterns (the rest are non-negative codes below 2^32)."""
        from .bridge import FloatKeyEncoder

        return tuple(k for k, enc in enumerate(key_encoders)
                     if isinstance(enc, FloatKeyEncoder))

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
        return [
            self._encode_codes_one(slot, enc, batch)
            for slot, enc in enumerate(key_encoders)
        ]

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
        ctx: TaskContext, partition: int, aux=None, fused_pids=None,
    ) -> Iterator[pa.RecordBatch]:
        """Build the output batch from the fetched numpy state arrays (and,
        on the keyed route, ``aux``: the median and corr passes' packed
        results; after a fused run with the pid fused, ``fused_pids``: the
        partition id of every group slot)."""
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
        jk_positions = None
        for kind, slot in self._group_plan:
            field_t = schema.field(len(cols)).type
            if kind == "enc":
                codes = group_table.codes_for(keep, slot)
                cols.append(key_encoders[slot].decode(codes, field_t))
                continue
            # build-resolved group key: look the kept groups' probe join
            # keys up in the sorted host build keys (unique keys: exact)
            if jk_positions is None:
                jk_vals = (
                    key_encoders[self._jk_slot]
                    .decode(
                        group_table.codes_for(keep, self._jk_slot),
                        schema.field(self._jk_pos).type,
                    )
                    .cast(pa.int64())
                    .to_numpy(zero_copy_only=False)
                    .astype(np.int64)
                )
                bkeys_host = self._build_state[4]
                jk_positions = np.minimum(
                    np.searchsorted(bkeys_host, jk_vals),
                    max(len(bkeys_host) - 1, 0),
                )
            vals = self._build_state[5].column(fused.join.build_cols[slot]).take(
                pa.array(jk_positions)
            )
            if not vals.type.equals(field_t):
                import pyarrow.compute as pc

                vals = pc.cast(vals, field_t)
            cols.append(
                vals.combine_chunks() if isinstance(vals, pa.ChunkedArray) else vals
            )

        partial = fused.mode == PARTIAL
        # state-field offset of each kernel spec in the host arrays
        offs: list[int] = []
        off = 0
        for spec in self.specs:
            offs.append(off)
            off += len(K.state_fields(spec, self._mode))

        def typed(arr: pa.Array) -> pa.Array:
            field_t = schema.field(len(cols)).type
            if arr.type.equals(field_t):
                return arr
            import pyarrow.compute as pc

            return pc.cast(arr, field_t, safe=False)

        for entry in self._emit:
            tag = entry[0]
            if tag in ("median", "cdist", "corr") and aux is None:
                raise ExecutionError(f"{tag} requires the keyed route")
            if tag == "corr":
                pkd = aux["corr"][entry[1]]
                if self._mode == "x32":
                    # double-float moments: hi + lo in f64
                    sxy, sxx, syy = (
                        pkd[2 * j][keep].view(np.float32).astype(np.float64)
                        + pkd[2 * j + 1][keep].view(np.float32)
                        for j in range(3)
                    )
                    n_arr = pkd[6][keep]
                else:
                    sxy = pkd[0][keep].view(np.float64)
                    sxx = pkd[1][keep].view(np.float64)
                    syy = pkd[2][keep].view(np.float64)
                    n_arr = pkd[3][keep]
                empty = (n_arr < 2) | (sxx <= 0) | (syy <= 0)
                with np.errstate(all="ignore"):
                    r = sxy / np.sqrt(sxx * syy)
                r = np.where(empty, 0.0, r)
                cols.append(typed(pa.array(r, pa.float64(), mask=empty)))
                continue
            if tag == "cdist":
                cd = aux["median"][entry[1]][5][keep].astype(np.int64)
                cols.append(typed(pa.array(cd, pa.int64())))
                continue
            if tag == "median":
                from .bridge import order_decode_f64

                med = aux["median"][entry[1]]
                empty = med[4][keep] == 0
                va = order_decode_f64(
                    np.where(empty, 0, med[0][keep]).astype(np.int32),
                    np.where(empty, 0, med[1][keep]).astype(np.int32),
                )
                vb = order_decode_f64(
                    np.where(empty, 0, med[2][keep]).astype(np.int32),
                    np.where(empty, 0, med[3][keep]).astype(np.int32),
                )
                cols.append(typed(pa.array((va + vb) / 2.0, pa.float64(), mask=empty)))
                continue
            if tag == "var":
                _, si, qi, ddof, use_sqrt = entry
                if self._mode == "x32":
                    # double-float moments: hi + lo in f64
                    s_v = host[offs[si]][keep].astype(np.float64) + host[offs[si] + 1][keep]
                    q_v = host[offs[qi]][keep].astype(np.float64) + host[offs[qi] + 1][keep]
                    n_arr = host[offs[si] + 2][keep]
                else:
                    s_v = host[offs[si]][keep].astype(np.float64)
                    n_arr = host[offs[si] + 1][keep]
                    q_v = host[offs[qi]][keep].astype(np.float64)
                n_f = n_arr.astype(np.float64)
                empty = n_arr < (ddof + 1)
                with np.errstate(all="ignore"):
                    var = (q_v - s_v * s_v / np.maximum(n_f, 1.0)) / np.maximum(
                        n_f - ddof, 1.0
                    )
                    m2 = q_v / np.maximum(n_f, 1.0)
                # conditioning guard: when the subtraction consumed more
                # digits than the moments carry (var below 1e-8 of the mean
                # square for f64 moments, 1e-6 for x32's ~48-bit ones, a
                # constant column included), only the exact CPU operators
                # can answer
                live = (~empty) & (m2 > 0)
                kmax = 1e-6 if self._mode == "x32" else 1e-8
                if bool(np.any(live & (var < m2 * kmax))):
                    raise _VarianceGuard()
                var = np.where(var < 0, 0.0, var)
                out_v = np.sqrt(var) if use_sqrt else var
                cols.append(typed(pa.array(out_v, pa.float64(), mask=empty)))
                continue
            spec = self.specs[entry[1]]
            i = offs[entry[1]]
            if spec.func in ("count", "count_star"):
                cols.append(pa.array(host[i][keep], pa.int64()))
                continue
            field_t = schema.field(len(cols)).type
            if spec.ord_pair:
                # x32 order-pair f64 extremum: the lexicographic (hi, lo)
                # int32 words decode to the bit-exact f64 min/max
                from .bridge import order_decode_f64

                n_arr = host[i + 2][keep]
                empty = n_arr == 0
                v = order_decode_f64(
                    np.where(empty, 0, host[i][keep]).astype(np.int32),
                    np.where(empty, 0, host[i + 1][keep]).astype(np.int32),
                )
                cols.append(pa.array(v, field_t, mask=empty))
                continue
            if spec.func in ("sum", "avg") and self._mode == "x32":
                # double-float state: hi + lo recombine in f64 on the host
                v = host[i][keep].astype(np.float64) + host[i + 1][keep].astype(np.float64)
                n_arr = host[i + 2][keep]
            else:
                v = None
                n_arr = host[i + 1][keep]
            empty = n_arr == 0
            if spec.int_minmax or spec.int_sum:
                # integer states stay INT end-to-end (an f64 round-trip
                # would round int64 values above 2^53)
                vals = np.where(empty, 0, host[i][keep]).astype(np.int64)
                if pa.types.is_date32(field_t):
                    vals = vals.astype("datetime64[D]")
                cols.append(pa.array(vals, field_t, mask=empty))
                continue
            if v is None:
                v = host[i][keep].astype(np.float64)
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
            if fused_pids is not None:
                # derived in the fused run over every group slot: the kept
                # groups' ids, bit-identical to the separate kernel's (the
                # same decoded key values through the same hash)
                pids = fused_pids[:n_groups][keep]
            else:
                pids = K.device_partition_ids(out, hint[0], hint[1], self.device)
            if pids is not None:
                from ..exec.operators import SHUFFLE_PID_COLUMN

                # device_pid_batches is counted once, by the consuming writer
                out = pa.RecordBatch.from_arrays(
                    out.columns + [pa.array(pids, pa.int32())],
                    schema=schema.append(pa.field(SHUFFLE_PID_COLUMN, pa.int32())),
                )
        yield out


def _note_range(key_state: dict, slot: int, span) -> None:
    """Widen key ``slot``'s running code span (the reference's
    ``note_range``): ``span`` is ``(min, max)`` of one batch's words, or
    None for a key with no bounded code space, which stays None."""
    if span is None or key_state.get(("max", slot), 0) is None:
        key_state[("max", slot)] = None
        return
    lo, hi = span
    key_state[("max", slot)] = max(key_state.get(("max", slot), hi), hi)
    cur = key_state.get(("min", slot))
    key_state[("min", slot)] = lo if cur is None else min(cur, lo)


def _zigzag_span(vals: np.ndarray, valid: Optional[np.ndarray], x32: bool) -> tuple:
    """(min, max) of an identity key's codes as K1 sorts them: the zigzag
    images ``2v + 1`` / ``-2v`` of the valid values, 0 for a null, and in
    x32 each code's signed 32-bit word.  Zigzag is not monotone (``zz(-1)
    = 2``, ``zz(1) = 3``), so a key whose values take both signs codes
    every value; one sign needs only the values' min and max."""
    has_null = valid is not None and not bool(valid.all())
    v = vals[valid] if has_null else vals
    if len(v) == 0:
        return (0, 0)
    lo, hi = int(v.min()), int(v.max())
    if lo >= 0 and not (x32 and 2 * hi + 1 >= 1 << 31):
        span = (2 * lo + 1, 2 * hi + 1)
    elif hi < 0 and not (x32 and -2 * lo >= 1 << 31):
        span = (-2 * hi, -2 * lo)
    else:
        # both signs, or x32 codes from 2^31, which wrap to negative words
        w = v.astype(np.int64)
        zz = np.where(w >= 0, 2 * w + 1, -2 * w)
        if x32:
            zz = np.where(zz >= 1 << 31, zz - (1 << 32), zz)
        span = (int(zz.min()), int(zz.max()))
    if has_null:
        span = (min(span[0], 0), max(span[1], 0))
    return span


def _radix_combine_bits(key_state: dict, n_keys: int) -> Optional[tuple]:
    """Per-key ``(min_code, width)`` plan when every key's min-rebased
    codes fold into one non-negative int32 sort word (None otherwise), the
    reference's rule on the port's code words: fewer than 2 keys, a key
    with no span, a code past 2^31 - 2 or widths summing past 31 bits
    decline.  The spans are the whole stream's (``_keyed_key_ops``), so
    the plan is right by construction: no key regrows after it."""
    if n_keys < 2:
        return None
    plan = []
    total = 0
    for slot in range(n_keys):
        m = key_state.get(("max", slot), None)
        if m is None:
            return None  # float bit-pattern codes are signed: no fold
        if int(m) > (1 << 31) - 2:
            return None
        lo = key_state.get(("min", slot), 0) or 0
        width = max(1, int(m - lo).bit_length())
        plan.append((int(lo), width))
        total += width
    if total > 31:
        return None
    return tuple(plan)


def _fits_x32_code(c: np.ndarray) -> bool:
    """Whether host key codes ship as x32's 32-bit words: zigzag,
    dictionary and bool codes below 2^32, f32 bit patterns (signed)."""
    return len(c) == 0 or (int(c.min()) >= -(1 << 31) and int(c.max()) < (1 << 32))


def _fits_x32_ident(values: np.ndarray) -> bool:
    """Whether identity key values ship as int32 with zigzag codes below
    2^32: every value in (-2^31, 2^31)."""
    return len(values) == 0 or (
        int(values.min()) > -(1 << 31) and int(values.max()) < (1 << 31)
    )


def _valid_source(closure):
    """What the reference's scan plan takes an argument's validity to be
    when it shares count columns (by identity): the env name of the leaf
    validity it passes through unchanged, None when it has none, or a new
    object for one computed anew at each call (two operands' validities
    ANDed)."""
    node = getattr(closure, "node", None)
    if node is None and getattr(closure, "halves", None):
        node = closure.halves[0].node
    if node is None:
        return getattr(closure, "valid_name", object())

    def source(nd):
        if nd.op == "leaf":
            return nd.const[1]
        srcs = [v for v in map(source, nd.args) if v is not None]
        if len(srcs) == 1:
            return srcs[0]
        return object() if srcs else None

    return source(node)


class _BudgetWidths:
    """The bytes a row of a keyed batch costs the reference's budgets, so
    that the port drains its pending batches and flushes its buffer where
    the reference does (its ``keyed_chunks``).  The reference pads every
    batch to :func:`K.bucket_rows` rows and counts, while batches wait,
    the host arrays it ships (each leaf and its validity, the probe key
    and its validity, each key's operands: an identity key as int32 when
    the first batch allows, a validity for every device kind) and, once
    it streams, its prep's outputs (a bool mask, each key's code, the
    scan-form columns: a count column per distinct argument and one
    column per sum, avg, min or max, then the raw extras).  An absent
    validity (all valid) counts as the reference's bool array."""

    def __init__(self, stage, kinds: tuple, join: bool):
        self.kinds = kinds
        self.word = 4 if stage._mode == "x32" else 8
        # the batch's own args: the non-join leaves, then the probe key and
        # its validity (the build's tensors are one shared allocation)
        self.n_own = sum(1 for nm in stage._flat_names if nm not in stage._join_slots)
        self.n_own += 2 if join else 0
        self.scan = self._scan_width(stage.specs, stage._arg_closures)
        self.keys: Optional[tuple] = None  # (host, device) bytes a row of the keys

    def _scan_width(self, specs, arg_closures) -> int:
        seen: list = []
        width = 0
        for spec, closure in zip(specs, arg_closures):
            if spec.func == "count_star":
                continue
            src = _valid_source(closure)
            if src is not None and not any(s is src or s == src for s in seen):
                seen.append(src)
                width += self.word  # the argument validity's count column
            if spec.func == "count":
                continue
            if self.word == 8 or spec.func in ("sum", "avg") or spec.ord_pair:
                width += 8  # f64 / i64, or x32's (hi, lo) pair
            else:
                width += 4
        return width

    def note_keys(self, host_keys) -> None:
        """The keys' widths, fixed by the first batch as the reference's
        identity dtype is."""
        if self.keys is not None:
            return
        host = dev = 0
        for kind, ops in zip(self.kinds, host_keys):
            if kind == "code":
                host += ops[0].dtype.itemsize
                dev += ops[0].dtype.itemsize
                continue
            if kind == "ident":
                vals = ops[0]
                fits = self.word == 4 or not len(vals) or int(vals.max()) <= (1 << 31) - 2
                w = 4 if fits else 8
            else:
                w = {"bool": 1, "f32": 4, "f64": 8}[kind]
            host += w + 1  # values and validity
            dev += 4 if kind == "bool" else w
        self.keys = (host, dev)

    def host_bytes(self, n: int, args: list) -> int:
        """A waiting batch's bytes: its own args and its key operands."""
        own = sum(1 if t is None else t.element_size() for t in args[:self.n_own])
        return K.bucket_rows(n) * (own + self.keys[0])

    def device_bytes(self, out) -> int:
        """A streamed batch's bytes: the prep's outputs."""
        extras = sum(1 if t is None else t.element_size() for t in out.extras)
        return K.bucket_rows(out.rows) * (1 + self.keys[1] + self.scan + extras)


def _concat(parts: list, lengths: list) -> Optional[torch.Tensor]:
    """One buffered field over every batch: None when every batch has None,
    else the batches' tensors joined, where a None part (an all-valid mask)
    stands for all-true of its batch's length."""
    if all(p is None for p in parts):
        return None
    like = next(p for p in parts if p is not None)
    if any(p is None for p in parts):
        if like.dtype != torch.bool:
            raise ValueError("a buffered value column is missing from a batch")
        parts = [
            torch.ones(n, dtype=torch.bool, device=like.device) if p is None else p
            for p, n in zip(parts, lengths)
        ]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


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
    ``device``, and point each mesh repartition's exchange at it."""
    if not config.tpu_enable:
        return plan
    kids = plan.children()
    if kids:
        plan = plan.with_new_children(
            [maybe_accelerate(c, config, device) for c in kids]
        )
    from ..exec.window import WindowExec
    from ..parallel.mesh_stage import MeshRepartitionExec

    if isinstance(plan, MeshRepartitionExec):
        # the exchange runs on this pass's device (the executor's)
        plan.device = torch.device(device)
        return plan
    if isinstance(plan, WindowExec):
        from .window_compiler import TorchWindowExec

        try:
            return TorchWindowExec(plan, config, device)
        except K.NotLowerable:
            return plan
    if isinstance(plan, HashAggregateExec) and plan.mode in (PARTIAL, SINGLE):
        return _accelerate_agg(plan, config, device) or plan
    return plan


def _accelerate_agg(
    agg: HashAggregateExec, config: BallistaConfig, device
) -> Optional[TorchStageExec]:
    """The device stage of an aggregate, or None when it does not lower.
    The fold-then-retry ladder: with an eligible join folded first, and
    if that shape does not lower (a host expression or a validity-only
    leaf over the build side), with the join on the CPU below it."""
    for fold in (True, False):
        fused = _flatten(agg, fold_join=fold)
        if fused is None:
            return None
        try:
            return TorchStageExec(agg, fused, config, device)
        except K.NotLowerable:
            if fused.join is None:
                return None
    return None
