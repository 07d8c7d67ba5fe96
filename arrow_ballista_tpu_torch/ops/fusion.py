"""Whole-stage fusion planner: enumerate the fusion boundaries of a
``_FusedStage`` subplan instead of hardcoding them.

The SystemML move (PAPERS.md "On Optimizing Operator Fusion Plans for
Large-Scale ML") applied to this executor: a map stage's operator chain
(scan → filter… → project → join → partial-agg → shuffle-pid) is walked
once and partitioned into SEGMENTS.  Everything inside one segment
compiles into one traced function and executes as ONE jitted dispatch —
filter masks, projected columns and agg state flow as jax arrays,
intermediates never leave the device (PAPERS.md "Data Path Fusion in
GPU for Analytical Query Processing").  A cut is forced exactly where
fusion is impossible or unprofitable:

* **non-traceable op** — an operator with no jax lowering (a string-key
  shuffle-pid derivation, a host UDF) becomes its own single-op segment
  and runs on the existing per-operator path;
* **pipeline breaker** — an operator that must consume its whole input
  before producing output (join build, the keyed sort-based agg) cuts
  BEFORE itself: upstream ops still fuse, the breaker starts a fresh
  segment;
* **capacity** — segments wider than ``fusion_max_ops`` (a measured
  ``ops/routing_table.json`` entry, not a code constant) are split so
  the unrolled XLA program stays clear of the compile cliff.

The planner is pure bookkeeping — no jax, no device.  ``TpuStageExec``
maps the plan onto its retained-entry single-dispatch runner: a plan
whose compute ops all land in segment 0 executes as one
``fused_dispatches`` call (with the shuffle pid column derived inside
the same trace when the pid op fused too), anything else degrades
segment-by-segment to per-operator dispatch.  Invariant (property-
tested): the segments partition the op list exactly once, in order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Tuple

__all__ = [
    "FusionOp",
    "FusionPlan",
    "plan_segments",
    "stage_ops",
]


@dataclass(frozen=True)
class FusionOp:
    """One operator of the stage subplan, as the planner sees it."""

    kind: str  # scan | filter | project | join | partial_agg | agg | shuffle_pid
    traceable: bool = True
    pipeline_breaker: bool = False
    label: str = ""


@dataclass(frozen=True)
class FusionPlan:
    """Ordered segments partitioning the op list, plus why each cut
    happened (``cuts`` holds ``(op_index, reason)`` — the boundary sits
    immediately before that op index)."""

    segments: Tuple[Tuple[FusionOp, ...], ...]
    cuts: Tuple[Tuple[int, str], ...] = field(default_factory=tuple)

    @property
    def ops(self) -> Tuple[FusionOp, ...]:
        return tuple(op for seg in self.segments for op in seg)

    @property
    def max_segment_ops(self) -> int:
        return max((len(s) for s in self.segments), default=0)

    def compute_fused(self) -> bool:
        """True when every COMPUTE op (everything but shuffle_pid) lives
        in segment 0 — the shape the single-dispatch runner can take."""
        if not self.segments:
            return False
        for seg in self.segments[1:]:
            for op in seg:
                if op.kind != "shuffle_pid":
                    return False
        return True

    def pid_fused(self) -> bool:
        """True when the shuffle-pid op fused into segment 0 (compute +
        partition-id derivation in ONE dispatch)."""
        return any(
            op.kind == "shuffle_pid" for op in (self.segments[0] if self.segments else ())
        )


def plan_segments(ops: Iterable[FusionOp], max_ops: int) -> FusionPlan:
    """Partition ``ops`` into fused segments under the cut rules above.

    The result's segments always concatenate back to ``ops`` exactly —
    no op is dropped, duplicated or reordered; degradation happens by
    making segments smaller, never by changing the plan's meaning."""
    ops = list(ops)
    max_ops = max(1, int(max_ops))
    segments: List[Tuple[FusionOp, ...]] = []
    cuts: List[Tuple[int, str]] = []
    cur: List[FusionOp] = []
    for i, op in enumerate(ops):
        if not op.traceable:
            # no lowering: isolate it so neighbours still fuse
            if cur:
                segments.append(tuple(cur))
                cur = []
            cuts.append((i, "non_traceable"))
            segments.append((op,))
            continue
        if op.pipeline_breaker and cur:
            segments.append(tuple(cur))
            cur = []
            cuts.append((i, "pipeline_breaker"))
        if len(cur) >= max_ops:
            segments.append(tuple(cur))
            cur = []
            cuts.append((i, "capacity"))
        cur.append(op)
    if cur:
        segments.append(tuple(cur))
    return FusionPlan(tuple(segments), tuple(cuts))


def _is_col(e) -> bool:
    from ..exec import expressions as pe

    return isinstance(e, pe.Col)


def stage_ops(stage) -> List[FusionOp]:
    """The op descriptors of one compiled ``TpuStageExec`` subplan.

    Everything a TpuStageExec compiled is traceable by construction
    (``K.NotLowerable`` already routed unsupported expressions to the
    CPU operator path before this planner runs) — the exceptions the
    descriptors record are the join build and the keyed sort-based agg
    (pipeline breakers: they consume the whole stream before emitting)
    and a shuffle-pid derivation whose keys the device hash can't take
    (string keys, non-column exprs, too many partitions: non-traceable,
    runs as its own host-prepped dispatch after materialize)."""
    fused = stage.fused
    ops: List[FusionOp] = [
        FusionOp("scan", label=type(fused.source).__name__)
    ]
    for _ in fused.filters:
        ops.append(FusionOp("filter"))
    # a projection op exists when any agg arg / group key is a computed
    # expression rather than a bare column reference
    computed = any(
        not _is_col(g) for g, _name in fused.group_exprs
    ) or any(
        a.arg is not None and not _is_col(a.arg) for a in fused.aggs
    )
    if computed:
        ops.append(FusionOp("project"))
    if fused.join is not None:
        ops.append(FusionOp("join", pipeline_breaker=True))
    ops.append(
        FusionOp(
            "partial_agg",
            pipeline_breaker=bool(getattr(stage, "_needs_keyed", False)),
            label="keyed" if getattr(stage, "_needs_keyed", False) else "",
        )
    )
    if getattr(stage, "_shuffle_hint", None) is not None:
        ops.append(
            FusionOp(
                "shuffle_pid",
                traceable=stage._fused_pid_spec() is not None,
            )
        )
    return ops
