"""Mesh gang stages: whole-stage execution over the device mesh.

Counterpart of ``arrow_ballista_tpu/parallel/mesh_stage.py``: partitions
of a stage are SHARDS of one :class:`~.mesh.TorchMesh`, driven by one task
in one process.  The partial-aggregate exchange collapses into the
cross-shard reduce (``mesh_reduce``), and a hash repartition into the
mesh exchange (``mesh_route`` plus block copies).

Mechanically: the distributed planner wraps an eligible stage subtree
(filter→project→partial-aggregate, the same shapes ``maybe_accelerate``
fuses) in a :class:`MeshGangExec` whose output partitioning is 1 — so the
scheduler creates ONE task for the stage, and the executor that receives
it runs every input partition as a shard.  Nothing else in the graph/task
machinery changes: recovery, retries and stats see an ordinary one-task
stage.  The reduced [capacity]-sized states are the only thing that
leaves the device.

Device errors raise.  The reference re-runs a gang sequentially after any
``ExecutionError`` or device runtime error; the port re-runs only on the
data-dependent exits (group capacity, the high-cardinality stage, the
keyed route's fallback, a stage that does not lower), so a failed launch
of ``mesh_reduce``, ``mesh_route`` or a stage kernel propagates.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import pyarrow as pa

from ..exec.operators import ExecutionPlan, Partitioning, TaskContext


class _MeshKeyedRoute(Exception):
    """Control flow: the gang's first batch showed groups ~ rows — run
    the KEYED reduction per shard and merge the [distinct]-sized results
    on the host, instead of abandoning the mesh for the sequential
    fallback."""

    def __init__(self, n_dev: int):
        super().__init__("mesh keyed high-cardinality")
        self.n_dev = n_dev


class _HighCardGang(Exception):
    """Control flow: groups ~ rows and the keyed route is not wanted: the
    sequential fallback routes each partition to the CPU hash aggregate."""


def gang_eligible(plan: ExecutionPlan) -> bool:
    """Structural check (no kernel build, no device touch — safe on the
    scheduler): does this stage subtree fuse into a partial-aggregate
    kernel whose states reduce across the mesh?"""
    from ..exec.aggregates import PARTIAL, HashAggregateExec
    from ..ops.stage_compiler import _flatten

    if not isinstance(plan, HashAggregateExec) or plan.mode != PARTIAL:
        return False
    if any(
        a.func == "count_distinct" or a.func.startswith("udaf:")
        for a in plan.aggs
    ):
        return False
    fused = _flatten(plan)
    # device-join stages run sequentially for now: the gang path would
    # need the build side replicated across shards
    return fused is not None and fused.join is None


def _mesh_width(n_devices: int, ctx: TaskContext, device) -> int:
    """The gang's shard count: the node's, else the config's, else every
    visible device, capped at the visible count."""
    from .mesh import visible_devices

    n_vis = max(1, visible_devices(device))
    n_dev = n_devices or ctx.config.mesh_devices or n_vis
    return max(1, min(n_dev, n_vis))


class MeshGangExec(ExecutionPlan):
    """Runs a whole stage as one program over the mesh.

    Output partitioning is always 1: the scheduler sees a one-task stage.
    When the subtree is an accelerated, join-free ``TorchStageExec``,
    execution shards ALL input partitions over the mesh, reduces each
    shard's rows on its device, folds the shards' states with the
    cross-shard reduce and materializes the combined partial result.  A
    capacity or cardinality exit re-runs the input partitions
    sequentially inside the same task; a device error raises.
    """

    def __init__(self, input: ExecutionPlan, n_devices: int = 0):
        super().__init__()
        self.input = input
        self.n_devices = n_devices

    @property
    def schema(self) -> pa.Schema:
        return self.input.schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(1)

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def with_new_children(self, children):
        return MeshGangExec(children[0], self.n_devices)

    def __str__(self) -> str:
        n = self.n_devices or "auto"
        return f"MeshGangExec: devices={n}"

    # ------------------------------------------------------------ execute
    def execute(
        self, partition: int, ctx: TaskContext
    ) -> Iterator[pa.RecordBatch]:
        assert partition == 0, "gang stages are single-task"
        from ..ops import kernels as K
        from ..ops.stage_compiler import (
            TorchStageExec,
            _CapacityExceeded,
            _KeyedFallback,
        )

        # the acceleration pass ran before: at plan time locally, on the
        # executor's device for a distributed task
        inner = self.input
        data_exits = (_CapacityExceeded, _KeyedFallback, K.NotLowerable, K.X32RangeError)
        if (
            isinstance(inner, TorchStageExec)
            and ctx.config.tpu_enable
            and inner.fused.join is None
        ):
            try:
                # fully materialized before yielding: a capacity fallback
                # must never follow already-emitted rows with a re-run
                batches = list(self._execute_mesh(inner, ctx))
                yield from batches
                return
            except _MeshKeyedRoute as route:
                try:
                    batches = list(
                        self._execute_mesh_keyed(inner, ctx, route.n_dev)
                    )
                    yield from batches
                    return
                except data_exits:
                    self.metrics.add("mesh_fallback", 1)
            except data_exits + (_HighCardGang,):
                # group capacity overflow, groups ~ rows without the keyed
                # route, or a stage that does not lower: re-run
                # sequentially.  A device or kernel error raises
                self.metrics.add("mesh_fallback", 1)
        yield from self._execute_sequential(inner, ctx)

    def _execute_sequential(
        self, inner: ExecutionPlan, ctx: TaskContext
    ) -> Iterator[pa.RecordBatch]:
        for p in range(self.input.output_partitioning().n):
            yield from inner.execute(p, ctx)

    def _execute_mesh(self, tpu, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        """All input partitions → one stage function per shard + the
        cross-shard reduce."""
        import torch

        from ..ops.bridge import DeviceStaging, make_key_encoder
        from ..ops.groups import GroupTable
        from ..ops.stage_compiler import _highcard_detect, keyed_route_wanted
        from . import mesh as M

        fused = tpu.fused
        n_dev = _mesh_width(self.n_devices, ctx, tpu.device)
        key_encoders = [
            make_key_encoder(tpu._schema.field(i).type)
            for i in range(len(fused.group_exprs))
        ]
        group_table = GroupTable(max(len(fused.group_exprs), 1))
        n_rows = 0
        n_parts = fused.source.output_partitioning().n
        # Partitions ARE the shards: each partition's tensors go to its
        # shard (round-robin) as soon as the partition is scanned, so peak
        # host memory is ONE batch.  Column order per chunk:
        # [gid, tail (None: every row live), *args].
        with self.metrics.timer("mesh_stage_time_ns"):
            mesh = M.make_mesh(n_dev, tpu.device)
            staging = [DeviceStaging(d) for d in mesh.devices]
            n_dev_chunks: list[list[list]] = [[] for _ in mesh.devices]
            tpu._build_kernels()
            for p in range(n_parts):
                s = p % n_dev
                for batch in fused.source.execute(p, ctx):
                    ctx.check_cancelled()
                    if batch.num_rows == 0:
                        continue
                    n = batch.num_rows
                    if fused.group_exprs:
                        with self.metrics.timer("key_encode_time_ns"):
                            seg = tpu._assign_gids(
                                tpu._encode_codes(batch, key_encoders),
                                group_table,
                            )
                        if n_rows == 0 and _highcard_detect(
                            group_table.n_groups, n
                        ):
                            if keyed_route_wanted(tpu.config):
                                # groups ~ rows: per-shard KEYED reduction
                                raise _MeshKeyedRoute(n_dev)
                            if tpu.config.tpu_highcard_mode != "gid":
                                # 'gid' pins the gid-table gang path
                                raise _HighCardGang("high-cardinality gang stage")
                    else:
                        seg = None
                    with self.metrics.timer("bridge_time_ns"):
                        args = tpu._kernel_args(batch, n, seg, staging[s])
                        gid = args.pop()
                        if gid is None:
                            gid = torch.zeros(n, dtype=torch.int32, device=mesh.devices[s])
                        if mesh.devices[s].type == "cpu":
                            # a retained tensor must own its memory: on the
                            # CPU a staged tensor aliases its numpy array
                            gid = gid.clone()
                            args = [None if a is None else a.clone() for a in args]
                        n_dev_chunks[s].append([gid, None] + args)
                    n_rows += n

            if n_rows == 0:
                yield from tpu._materialize(
                    None, key_encoders, group_table, 0, ctx, 0
                )
                return

            # the reference's 4x capacity bucketing — segment ids beyond
            # the table would be dropped silently
            cap = tpu.capacity
            while cap < group_table.n_groups:
                cap *= 4
            cap = min(cap, tpu.max_capacity)
            if cap > tpu.capacity:
                self.metrics.add("capacity_growths", 1)

            def kernel(gid, tail, *arrays, state=None):
                # each shard's rows on the route segment_algo picks for them
                fn = tpu._kernel_for(cap, gid.shape[0])
                return fn(gid, tail, *arrays, state=state)

            step = M.make_distributed_agg_step(kernel, tpu.specs, mesh, cap, tpu._mode)
            with self.metrics.timer("device_time_ns"):
                width = len(next(ch for chunks in n_dev_chunks for ch in chunks))
                shards = M.assemble_shards(mesh, n_dev_chunks, width)
                n_dev_chunks = None  # the shards hold the only references
                state = step(shards)
                # ONE fetch of the reduced state, bounded to the pow2 bucket
                # of the assigned groups
                host_states = tpu._fetch_states(
                    state, group_table.n_groups if fused.group_exprs else None
                )
        self.metrics.add("mesh_rows_in", n_rows)
        self.metrics.add("mesh_devices", n_dev)
        yield from tpu._materialize(
            host_states, key_encoders, group_table, n_rows, ctx, 0
        )

    def _execute_mesh_keyed(
        self, tpu, ctx: TaskContext, n_dev: int
    ) -> Iterator[pa.RecordBatch]:
        """High-cardinality gang: per-shard KEYED reduction (the port's
        keyed route: key encode, radix sort, gids, segmented scan and
        finish on each shard's device), then a [distinct]-sized vectorized
        host merge by key (``merge_keyed_host``).  The O(rows) work stays
        on the shards; only each shard's (unique keys, states) cross to the
        host."""
        from ..ops import kernels as K
        from ..ops.bridge import DeviceStaging, make_key_encoder
        from ..ops.stage_compiler import _KeyedGroups
        from . import mesh as M

        fused = tpu.fused
        key_encoders = [
            make_key_encoder(tpu._schema.field(pos).type)
            for pos, (kind, _s) in enumerate(tpu._group_plan)
            if kind == "enc"
        ]
        kinds = tpu._key_kinds_for(key_encoders)
        prep = tpu._keyed_prep(kinds)
        mesh = M.make_mesh(n_dev, tpu.device)
        staging = [DeviceStaging(d) for d in mesh.devices]
        per_dev_buf: list[list] = [[] for _ in mesh.devices]
        n_rows = 0
        with self.metrics.timer("mesh_stage_time_ns"):
            tpu._build_kernels()
            n_parts = fused.source.output_partitioning().n
            for p in range(n_parts):
                s = p % n_dev
                for batch in fused.source.execute(p, ctx):
                    ctx.check_cancelled()
                    n = batch.num_rows
                    if n == 0:
                        continue
                    with self.metrics.timer("key_encode_time_ns"):
                        codes = [
                            tpu._encode_codes_one(slot, enc, batch)
                            if kind == "code" else None
                            for slot, (kind, enc) in enumerate(zip(kinds, key_encoders))
                        ]
                    # x32: a key past 32-bit codes is the gang's data exit
                    # (_KeyedFallback), as the reference's "gang keys
                    # exceed i32"
                    host_keys = tpu._keyed_key_ops(batch, kinds, key_encoders, codes)
                    with self.metrics.timer("bridge_time_ns"):
                        args, keys = tpu._kernel_args(
                            batch, n, None, staging[s], keys=host_keys
                        )
                    args.pop()  # no host group ids on this route
                    with self.metrics.timer("device_time_ns"):
                        per_dev_buf[s].append(prep(keys, None, *args))
                    n_rows += n

            if n_rows == 0:
                yield from tpu._materialize(
                    None, key_encoders, _KeyedGroups([], 0), 0, ctx, 0
                )
                return

            per_dev = []
            with self.metrics.timer("device_time_ns"):
                for buf in per_dev_buf:
                    if buf:
                        states, key_codes, n_groups, _post = tpu._keyed_reduce(
                            buf, prep, tpu._signed_key_slots(key_encoders)
                        )
                        per_dev.append((states, key_codes, n_groups))
            merge = K.merge_keyed_host_x32 if tpu._mode == "x32" else K.merge_keyed_host
            merged_states, merged_keys, n_groups = merge(tpu.specs, per_dev)
        self.metrics.add("mesh_rows_in", n_rows)
        self.metrics.add("mesh_devices", n_dev)
        self.metrics.add("mesh_keyed", 1)
        yield from tpu._materialize(
            merged_states, key_encoders,
            _KeyedGroups(merged_keys, n_groups), n_rows, ctx, 0,
        )


class MeshExchangeError(Exception):
    """Exchange-specific failure (capacity ceiling, untransferable column):
    the owning writer falls back to the classic hash-split.  Deliberately
    NOT an ExecutionError so inner-plan execution errors propagate to the
    normal stage-retry machinery instead of being silently re-run."""


def exchange_supported(schema: pa.Schema) -> bool:
    """Can every field of this schema cross the mesh exchange?
    (numeric/bool/date/timestamp directly, strings as dictionary codes —
    mesh.BatchExchanger's layout rules)."""
    from ..ops.bridge import _is_device_friendly

    for f in schema:
        t = f.type
        if not (
            pa.types.is_string(t)
            or pa.types.is_large_string(t)
            or _is_device_friendly(t)
        ):
            return False
    return True


class MeshRepartitionExec(ExecutionPlan):
    """Gang-form hash repartition: the stage's shuffle IS the mesh exchange.

    The reference hash-splits every batch per input partition and writes
    n_in x n_out shuffle files (``shuffle_writer.rs:201-285``); when the
    stage's partitions are mesh-resident, this node runs ONE task that
    shards every input partition over the mesh, routes rows to their
    destination output partition with the route kernel and the block
    all-to-all (:class:`..parallel.mesh.BatchExchanger`), and hands the
    owning :class:`ShuffleWriterExec` already-partitioned output batches —
    zero hash-split files, one memory write per output partition.

    ``output_partitioning()`` is 1 so the scheduler sees an ordinary
    one-task stage (same trick as :class:`MeshGangExec`).  Capacity follows
    the documented n_dropped contract: computed exactly from the shard
    layout, doubled and retried if the exchange still reports drops,
    :class:`MeshExchangeError` (→ writer fallback) past the ceiling.
    ``device`` is the executor's (the acceleration pass sets it); None
    means ``cuda``.
    """

    _CAP_CEILING = 1 << 24
    # process-wide observability: completed exchanges
    exchanges_completed = 0

    def __init__(
        self, input: ExecutionPlan, partitioning: Partitioning,
        n_devices: int = 0, device=None,
    ):
        super().__init__()
        assert partitioning.kind == "hash"
        self.input = input
        self.partitioning = partitioning
        self.n_devices = n_devices
        self.device = device

    @property
    def schema(self) -> pa.Schema:
        return self.input.schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(1)

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def with_new_children(self, children):
        return MeshRepartitionExec(
            children[0], self.partitioning, self.n_devices, self.device
        )

    def __str__(self) -> str:
        return (
            f"MeshRepartitionExec: hash({self.partitioning.n}) "
            f"devices={self.n_devices or 'auto'}"
        )

    def execute(
        self, partition: int, ctx: TaskContext
    ) -> Iterator[pa.RecordBatch]:
        # direct execution (no writer): repartition does not change row
        # content, so pass every input partition through unchanged
        for p in range(self.input.output_partitioning().n):
            yield from self.input.execute(p, ctx)

    # -------------------------------------------------------- exchanged
    def execute_exchanged(
        self, ctx: TaskContext
    ) -> Iterator[tuple[int, pa.RecordBatch]]:
        """Yield (output_partition, batch) pairs after the mesh exchange."""
        from ..errors import ExecutionError
        from ..shuffle.execution_plans import partition_indices
        from . import mesh as M

        device = "cuda" if self.device is None else self.device
        n_out = self.partitioning.n
        exprs = list(self.partitioning.exprs)
        n_dev = _mesh_width(self.n_devices, ctx, device)

        # the exchange buffers the stage input in host memory (~2x resident
        # plus device staging): a row ceiling keeps huge shuffles on the
        # streaming hash-split path instead of running this task out of
        # memory
        max_rows = ctx.config.mesh_exchange_max_rows
        with self.metrics.timer("mesh_stage_time_ns"):
            batches: list[pa.RecordBatch] = []
            dest_parts: list[np.ndarray] = []
            rows_seen = 0
            for p in range(self.input.output_partitioning().n):
                for b in self.input.execute(p, ctx):
                    ctx.check_cancelled()
                    if b.num_rows == 0:
                        continue
                    rows_seen += b.num_rows
                    if rows_seen > max_rows:
                        raise MeshExchangeError(
                            f"stage exceeds mesh.exchange_max_rows "
                            f"({rows_seen} > {max_rows})"
                        )
                    with self.metrics.timer("repart_time_ns"):
                        idx = partition_indices(b, exprs, n_out)
                    batches.append(b)
                    dest_parts.append(idx.astype(np.int32))
            if not batches:
                return

            # destination column rides the exchange so one device can
            # carry several output partitions (n_out != n_dev)
            ext_schema = pa.schema(
                list(self.input.schema) + [pa.field("__part", pa.int32())]
            )
            ext_batches = [
                pa.RecordBatch.from_arrays(
                    list(b.columns) + [pa.array(d)], schema=ext_schema
                )
                for b, d in zip(batches, dest_parts)
            ]
            dest_dev = np.concatenate(dest_parts) % n_dev
            dest_dev = dest_dev.astype(np.int32)
            total = len(dest_dev)
            valid = np.ones(total, dtype=bool)

            # exact per-(source shard, destination) bucket need from the
            # known contiguous shard layout (shard_batch's split)
            per_shard = -(-total // n_dev)
            shard_id = np.arange(total, dtype=np.int64) // per_shard
            need = int(
                np.bincount(
                    shard_id * n_dev + dest_dev, minlength=n_dev * n_dev
                ).max()
            )
            cap = 1 << max(need - 1, 0).bit_length()

            mesh = M.make_mesh(n_dev, device)
            try:
                base_ex = None
                cols = None
                while True:
                    ex = M.BatchExchanger(
                        mesh, ext_schema, cap, share_from=base_ex
                    )
                    if cols is None:  # encoding is capacity-independent
                        base_ex = ex
                        cols_per_batch = [
                            ex.to_columns(b) for b in ext_batches
                        ]
                        cols = [
                            np.concatenate(parts)
                            for parts in zip(*cols_per_batch)
                        ]
                    with self.metrics.timer("device_time_ns"):
                        recv_cols, recv_valid, n_dropped = ex.exchange(
                            dest_dev, valid, cols
                        )
                    if n_dropped == 0:
                        break
                    cap *= 2  # grow-or-fallback contract (mesh.py docstring)
                    if cap > self._CAP_CEILING:
                        raise MeshExchangeError(
                            "mesh exchange capacity ceiling exceeded"
                        )
                    self.metrics.add("capacity_growths", 1)
            except ExecutionError as e:
                # column didn't cross the bridge (dtype slipped past the
                # plan-time check): an exchange failure, not a plan failure
                raise MeshExchangeError(str(e)) from e

            self.metrics.add("mesh_exchange_rows", total)
            self.metrics.add("mesh_devices", n_dev)
            MeshRepartitionExec.exchanges_completed += 1

            part_col = len(ext_schema) - 1
            for recv in ex.to_batches(recv_cols, recv_valid):
                if recv.num_rows == 0:
                    continue
                parts = np.asarray(recv.column(part_col))
                core = recv.select(range(part_col))
                order = np.argsort(parts, kind="stable")
                sorted_parts = parts[order]
                shuffled = core.take(pa.array(order))
                bounds = np.searchsorted(
                    sorted_parts, np.arange(n_out + 1)
                )
                for out_p in range(n_out):
                    lo, hi = int(bounds[out_p]), int(bounds[out_p + 1])
                    if hi > lo:
                        yield out_p, shuffled.slice(lo, hi - lo)


def maybe_mesh(plan: ExecutionPlan, config) -> ExecutionPlan:
    """Physical-optimizer rule for the LOCAL engine (SessionContext): run
    an accelerated partial-aggregate under Repartition/Coalesce as one
    mesh gang so the local path exercises the same collectives as the
    distributed gang stages."""
    from ..exec.operators import CoalescePartitionsExec, RepartitionExec
    from ..ops.stage_compiler import TorchStageExec

    if not (config.mesh_enable and config.tpu_enable):
        return plan
    kids = plan.children()
    if kids:
        plan = plan.with_new_children([maybe_mesh(c, config) for c in kids])
    if isinstance(plan, (RepartitionExec, CoalescePartitionsExec)):
        child = plan.children()[0]
        if (
            isinstance(child, TorchStageExec)
            and child.fused.mode == "partial"
            and child.fused.source.output_partitioning().n > 1
        ):
            return plan.with_new_children(
                [MeshGangExec(child, config.mesh_devices)]
            )
    return plan
