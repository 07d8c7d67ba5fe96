"""Plan-fingerprint result/shuffle cache.

The scheduler's memory: a completed stage's shuffle output is pinned to the
external store and registered under a *canonical fingerprint* of the subplan
that produced it.  A later job whose producer subtree fingerprints to the
same value resolves its consumers directly against the cached partition
locations — the producer stage (and its whole upstream subtree) is never
dispatched.

Fingerprint = sha256 over a canonicalized encoding of the physical plan
object tree, hashed together with *source snapshot identity* (per-file
mtime_ns + size for file-backed tables, content digest for in-memory
tables).  Canonicalization strips naming noise that cannot change output
bytes — column aliases, output field names, commutative operand order,
IN-list item order — while preserving everything that can: literals,
operator structure, partitioning expression order, sort directions, UDF
bytecode.

Everything here is inert unless ``ballista.cache.enabled`` is set; with the
knob off no fingerprint is ever computed and planning/dispatch are
byte-identical to a build without this module.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from ..catalog import MemoryTable
from ..config import BallistaConfig
from ..exec.expressions import (
    Binary,
    Case,
    Cast,
    Col,
    InList,
    IntervalLit,
    IsNull,
    Like,
    Lit,
    Negative,
    Not,
    ScalarFn,
    ScalarUdf,
)
from ..exec.aggregates import HashAggregateExec
from ..exec.joins import CrossJoinExec, HashJoinExec
from ..exec.operators import (
    CoalescePartitionsExec,
    EmptyExec,
    FilterExec,
    LimitExec,
    ProjectionExec,
    RepartitionExec,
    ScanExec,
    SortExec,
    UnionExec,
)
from ..exec.planner import RenameSchemaExec
from ..exec.window import WindowExec
from ..shuffle.execution_plans import ShuffleWriterExec, UnresolvedShuffleExec
from ..obs.registry import process_registry
from ..shuffle.store import upload_file
from ..udf import global_registry

__all__ = [
    "CacheIneligible",
    "plan_fingerprint",
    "stage_fingerprints",
    "PlanCache",
    "try_serve",
    "store_completed",
]


class CacheIneligible(Exception):
    """Raised when a (sub)plan cannot be safely fingerprinted.

    Unknown operators, nondeterministic functions, and source providers
    without a snapshot identity all land here; the caller treats the
    subtree as uncacheable and moves on.
    """


# Scalar functions whose output depends on more than their arguments.  A
# subtree containing one can never be served from cache.
_NONDETERMINISTIC_FNS = frozenset(
    {"random", "rand", "uuid", "now", "current_timestamp", "current_date"}
)

# Binary ops where operand order cannot change output bytes.
_COMMUTATIVE_OPS = frozenset({"AND", "OR", "+", "*", "=", "==", "!="})


# ---------------------------------------------------------------------------
# canonical expression encoding
# ---------------------------------------------------------------------------


def _canon_expr(e: Any) -> Any:
    """Canonical, JSON-able encoding of a physical expression.

    Column *names* are dropped (index-only) so alias noise collides;
    everything value-bearing is preserved.
    """
    if isinstance(e, Col):
        return ["col", e.index]
    if isinstance(e, Lit):
        return ["lit", repr(e.value), str(e.dtype)]
    if isinstance(e, IntervalLit):
        return ["interval", e.months, e.days]
    if isinstance(e, Binary):
        l, r = _canon_expr(e.left), _canon_expr(e.right)
        if e.op in _COMMUTATIVE_OPS:
            a, b = sorted(
                (json.dumps(l, sort_keys=True), json.dumps(r, sort_keys=True))
            )
            return ["bin", e.op, json.loads(a), json.loads(b)]
        return ["bin", e.op, l, r]
    if isinstance(e, Not):
        return ["not", _canon_expr(e.expr)]
    if isinstance(e, Negative):
        return ["neg", _canon_expr(e.expr)]
    if isinstance(e, IsNull):
        return ["isnull", _canon_expr(e.expr), e.negated]
    if isinstance(e, InList):
        return [
            "inlist",
            _canon_expr(e.expr),
            sorted(repr(v) for v in e.items),
            e.negated,
        ]
    if isinstance(e, Like):
        return ["like", _canon_expr(e.expr), e.pattern, e.negated]
    if isinstance(e, Case):
        return [
            "case",
            [[_canon_expr(w), _canon_expr(t)] for w, t in e.whens],
            _canon_expr(e.else_expr) if e.else_expr is not None else None,
            str(e.out_type),
        ]
    if isinstance(e, Cast):
        return ["cast", _canon_expr(e.expr), str(e.to_type)]
    if isinstance(e, ScalarUdf):
        return [
            "udf",
            e.fname,
            _udf_body_digest(e.fname),
            [_canon_expr(a) for a in e.args],
            str(e.out_type),
        ]
    if isinstance(e, ScalarFn):
        if e.fname.lower() in _NONDETERMINISTIC_FNS:
            raise CacheIneligible(f"nondeterministic function {e.fname}")
        return [
            "fn",
            e.fname,
            [_canon_expr(a) for a in e.args],
            str(e.out_type),
        ]
    raise CacheIneligible(f"unknown expression {type(e).__name__}")


def _udf_body_digest(fname: str) -> str:
    """Digest of a UDF's bytecode so edited bodies diverge.

    An unregistered name (scheduler never saw the UDF) gets a sentinel —
    fingerprints still work, but two different unregistered bodies under
    one name would collide, so registration is the contract.
    """
    try:
        spec = global_registry().scalar(fname)
    except Exception:
        spec = None
    if spec is None:
        return "unregistered"
    code = spec.fn.__code__
    h = hashlib.sha256()
    h.update(code.co_code)
    h.update(repr(code.co_consts).encode())
    return h.hexdigest()[:16]


def _canon_schema(schema: Any) -> list:
    """Types + nullability only — field names are alias noise."""
    return [[str(f.type), bool(f.nullable)] for f in schema]


def _canon_partitioning(p: Any) -> Any:
    if p is None:
        return None
    exprs = [_canon_expr(e) for e in (p.exprs or [])] if p.exprs else []
    # expr ORDER is load-bearing: it decides which row hashes to which
    # output partition, so two orders produce differently-laid-out bytes.
    return [p.kind, p.n, exprs]


# ---------------------------------------------------------------------------
# source snapshot identity
# ---------------------------------------------------------------------------


def _snapshot_of(provider: Any) -> Any:
    """Identity of the data behind a scan *right now*.

    File-backed: per-file (path, mtime_ns, size).  In-memory: the
    describe() already embeds the data hex, so content IS the snapshot.
    Providers exposing an ``etag`` use it directly.
    """
    etag = getattr(provider, "etag", None)
    if etag:
        return ["etag", str(etag)]
    if isinstance(provider, MemoryTable):
        return ["inline"]  # content-addressed via describe()
    files = getattr(provider, "files", None)
    if files:
        snap = []
        for f in sorted(files):
            try:
                st = os.stat(f)
                snap.append([f, st.st_mtime_ns, st.st_size])
            except OSError:
                snap.append([f, "missing", 0])
        return ["files", snap]
    path = getattr(provider, "path", None)
    if path:
        try:
            st = os.stat(path)
            return ["files", [[path, st.st_mtime_ns, st.st_size]]]
        except OSError:
            return ["files", [[path, "missing", 0]]]
    raise CacheIneligible(
        f"provider {type(provider).__name__} has no snapshot identity"
    )


# ---------------------------------------------------------------------------
# canonical plan encoding
# ---------------------------------------------------------------------------


def _canon_plan(p: Any, child_fps: dict[int, str], with_snapshot: bool) -> Any:
    # device wrapper nodes fingerprint as the plan they wrap
    orig = getattr(p, "original", None)
    if orig is not None and type(p).__name__ in ("TorchStageExec", "TorchWindowExec"):
        return _canon_plan(orig, child_fps, with_snapshot)
    if isinstance(p, ScanExec):
        desc = dict(p.provider.describe())
        if not with_snapshot and "data" in desc:
            # shape fingerprint: inline memory-table bytes are a
            # snapshot, not a shape — keep only the schema identity
            desc["data"] = _canon_schema(p.schema)
        node = [
            "scan",
            json.dumps(desc, sort_keys=True, default=str),
            list(p.projection) if p.projection is not None else None,
        ]
        if with_snapshot:
            node.append(_snapshot_of(p.provider))
        return node
    if isinstance(p, FilterExec):
        return [
            "filter",
            _canon_expr(p.predicate),
            _canon_plan(p.input, child_fps, with_snapshot),
        ]
    if isinstance(p, ProjectionExec):
        # output names dropped — consumers address columns by index
        return [
            "project",
            [_canon_expr(e) for e, _name in p.exprs],
            _canon_plan(p.input, child_fps, with_snapshot),
        ]
    if isinstance(p, HashAggregateExec):
        return [
            "agg",
            p.mode,
            [_canon_expr(e) for e, _name in p.group_exprs],
            [
                [
                    a.func,
                    _canon_expr(a.arg) if a.arg is not None else None,
                    _canon_expr(a.arg2) if a.arg2 is not None else None,
                    str(a.out_type),
                ]
                for a in p.aggs
            ],
            _canon_plan(p.input, child_fps, with_snapshot),
        ]
    if isinstance(p, HashJoinExec):
        return [
            "hashjoin",
            p.join_type,
            p.partition_mode,
            [[_canon_expr(l), _canon_expr(r)] for l, r in p.on],
            _canon_expr(p.filter) if p.filter is not None else None,
            _canon_plan(p.left, child_fps, with_snapshot),
            _canon_plan(p.right, child_fps, with_snapshot),
        ]
    if isinstance(p, CrossJoinExec):
        return [
            "crossjoin",
            _canon_plan(p.left, child_fps, with_snapshot),
            _canon_plan(p.right, child_fps, with_snapshot),
        ]
    if isinstance(p, SortExec):
        return [
            "sort",
            [[_canon_expr(e), bool(asc), bool(nf)] for e, asc, nf in p.sort_keys],
            p.fetch,
            _canon_plan(p.input, child_fps, with_snapshot),
        ]
    if isinstance(p, WindowExec):
        return [
            "window",
            [
                [
                    s.func,
                    _canon_expr(s.arg) if s.arg is not None else None,
                    [_canon_expr(e) for e in s.partition_by],
                    [
                        [_canon_expr(e), bool(asc), bool(nf)]
                        for e, asc, nf in s.order_by
                    ],
                    str(s.out_type),
                    s.offset,
                    list(s.frame) if s.frame is not None else None,
                ]
                for s in p.specs
            ],
            _canon_plan(p.input, child_fps, with_snapshot),
        ]
    if isinstance(p, LimitExec):
        return [
            "limit",
            p.skip,
            p.fetch,
            _canon_plan(p.input, child_fps, with_snapshot),
        ]
    if isinstance(p, UnionExec):
        # branch order is load-bearing: output partitions concatenate
        return [
            "union",
            [_canon_plan(i, child_fps, with_snapshot) for i in p.inputs],
        ]
    if isinstance(p, RepartitionExec):
        return [
            "repartition",
            _canon_partitioning(p.partitioning),
            _canon_plan(p.input, child_fps, with_snapshot),
        ]
    if isinstance(p, CoalescePartitionsExec):
        return ["coalesce", _canon_plan(p.input, child_fps, with_snapshot)]
    if isinstance(p, RenameSchemaExec):
        # pure renaming: transparent for fingerprinting
        return _canon_plan(p.input, child_fps, with_snapshot)
    if isinstance(p, EmptyExec):
        return ["empty", bool(p.produce_one_row), _canon_schema(p.schema)]
    if isinstance(p, ShuffleWriterExec):
        # job/stage ids are session noise; the partitioning decides bytes
        return [
            "shuffle_write",
            _canon_partitioning(p.shuffle_output_partitioning),
            _canon_plan(p.input, child_fps, with_snapshot),
        ]
    if isinstance(p, UnresolvedShuffleExec):
        fp = child_fps.get(p.stage_id)
        if fp is None:
            raise CacheIneligible(f"producer stage {p.stage_id} ineligible")
        return [
            "shuffle_read",
            fp,
            sorted(p.selections) if p.selections else None,
        ]
    # the mesh operators are not ported: the port's planner never emits them
    raise CacheIneligible(f"unknown operator {type(p).__name__}")


def plan_fingerprint(
    plan: Any,
    child_fps: dict[int, str] | None = None,
    with_snapshot: bool = True,
) -> str:
    """sha256 hexdigest of the canonical encoding of ``plan``.

    ``child_fps`` maps producer stage_id → fingerprint for any
    UnresolvedShuffleExec leaves.  ``with_snapshot=False`` yields a pure
    *shape* fingerprint (used by the policy store, where knob overrides
    apply regardless of the data snapshot).

    Raises :class:`CacheIneligible` for plans that can't be fingerprinted.
    """
    tree = _canon_plan(plan, child_fps or {}, with_snapshot)
    blob = json.dumps(tree, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def stage_fingerprints(stages: dict[int, Any]) -> dict[int, str]:
    """Fingerprint every stage plan bottom-up.

    ``stages`` maps stage_id → physical plan (the stage's full plan,
    ShuffleWriterExec root for producers).  A stage whose own plan — or
    any producer it reads — is ineligible is simply absent from the
    result; its consumers become ineligible too (their shuffle_read leaf
    has no child fingerprint to substitute).
    """
    from .planner import find_unresolved_shuffles

    deps = {sid: find_unresolved_shuffles(p) for sid, p in stages.items()}
    fps: dict[int, str] = {}
    remaining = dict(stages)
    while remaining:
        progressed = False
        for sid in sorted(remaining):
            if any(d not in fps and d in stages for d in deps[sid]):
                if all(d in fps or d in remaining for d in deps[sid]):
                    continue  # wait for producers still in flight
            try:
                fps[sid] = plan_fingerprint(remaining[sid], fps)
            except CacheIneligible:
                pass
            del remaining[sid]
            progressed = True
        if not progressed:  # pragma: no cover - cycle guard
            break
    return fps


# ---------------------------------------------------------------------------
# the cache proper
# ---------------------------------------------------------------------------


def _registry_counters():
    reg = process_registry()
    return (
        reg.counter("plan_cache_hits_total", "plan-cache fingerprint hits"),
        reg.counter("plan_cache_misses_total", "plan-cache fingerprint misses"),
        reg.counter("plan_cache_stores_total", "plan-cache entries stored"),
        reg.counter("plan_cache_evictions_total", "plan-cache entries evicted"),
    )


@dataclass
class CacheEntry:
    fingerprint: str
    job_id: str
    stage_id: int
    n_tasks: int
    # tasks[k] = list of partition dicts written by producer task k:
    #   {"partition_id", "path", "num_batches", "num_rows", "num_bytes"}
    tasks: list = field(default_factory=list)
    bytes: int = 0
    created_unix: float = 0.0
    last_used_unix: float = 0.0
    hits: int = 0
    schema_names: list = field(default_factory=list)
    plan: str = ""

    def to_dict(self) -> dict:
        return {
            "fingerprint": self.fingerprint,
            "job_id": self.job_id,
            "stage_id": self.stage_id,
            "n_tasks": self.n_tasks,
            "tasks": self.tasks,
            "bytes": self.bytes,
            "created_unix": self.created_unix,
            "last_used_unix": self.last_used_unix,
            "hits": self.hits,
            "schema_names": self.schema_names,
            "plan": self.plan,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CacheEntry":
        return cls(**{k: d.get(k) for k in cls.__dataclass_fields__ if k in d})


class PlanCache:
    """Durable fingerprint → cached-shuffle-output index.

    Partition files live under ``root_dir/<fp>/t<task>_p<part>.arrow``; the
    index itself is ``root_dir/index.json`` (atomic rewrite).  Thread-safe;
    one instance is shared by the scheduler's task manager.
    """

    def __init__(self, root_dir: str):
        self.root_dir = root_dir
        self._lock = threading.Lock()
        self._entries: dict[str, CacheEntry] = {}
        # fingerprints evicted by the most recent store(); the caller
        # drains them into cache_evicted journal events
        self.evicted_fps: list = []
        self._hits, self._misses, self._stores, self._evictions = (
            _registry_counters()
        )
        os.makedirs(root_dir, exist_ok=True)
        self._load()

    # -- persistence --------------------------------------------------------

    def _index_path(self) -> str:
        return os.path.join(self.root_dir, "index.json")

    def _load(self) -> None:
        try:
            with open(self._index_path()) as f:
                raw = json.load(f)
            self._entries = {
                fp: CacheEntry.from_dict(d) for fp, d in raw.items()
            }
        except (OSError, ValueError):
            self._entries = {}

    def _save_locked(self) -> None:
        tmp = self._index_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {fp: e.to_dict() for fp, e in self._entries.items()}, f
            )
        os.replace(tmp, self._index_path())

    # -- lookup / store / evict --------------------------------------------

    def lookup(self, fp: str, config: BallistaConfig) -> CacheEntry | None:
        """Return a live entry for ``fp`` or None (counting hit/miss).

        Validates TTL and on-disk file existence; a stale or hollow entry
        is evicted and reported as a miss.  Existence only shrinks the
        window — a file lost *after* lookup degrades through the normal
        lost-shuffle recovery path at fetch time.
        """
        now = time.time()
        with self._lock:
            e = self._entries.get(fp)
            if e is not None and now - e.created_unix > config.cache_ttl_seconds:
                self._evict_locked(fp, reason="ttl")
                e = None
            if e is not None:
                for task in e.tasks:
                    if any(not os.path.exists(p["path"]) for p in task):
                        self._evict_locked(fp, reason="lost")
                        e = None
                        break
            if e is None:
                self._misses.inc()
                return None
            e.hits += 1
            e.last_used_unix = now
            self._hits.inc()
            self._save_locked()
            return e

    def store(
        self,
        fp: str,
        job_id: str,
        stage_id: int,
        task_partitions: list,
        schema_names: list,
        plan_summary: str,
        config: BallistaConfig,
    ) -> CacheEntry | None:
        """Pin a completed stage's output under ``fp``.

        ``task_partitions[k]`` is the list of ShuffleWritePartitions
        written by producer task ``k`` (source paths on local disk or the
        external store).  Returns the new entry, or None if any source
        file is unavailable (partial uploads are rolled back).
        """
        with self._lock:
            if fp in self._entries:
                return self._entries[fp]
        dest_dir = os.path.join(self.root_dir, fp)
        os.makedirs(dest_dir, exist_ok=True)
        tasks, total = [], 0
        try:
            for k, parts in enumerate(task_partitions):
                out = []
                for p in parts:
                    src = None
                    for cand in (p.replica_path, p.path):
                        if cand and os.path.exists(cand):
                            src = cand
                            break
                    if src is None:
                        raise FileNotFoundError(p.path)
                    dest = os.path.join(
                        dest_dir, f"t{k}_p{p.partition_id}.arrow"
                    )
                    total += upload_file(src, dest)
                    out.append(
                        {
                            "partition_id": p.partition_id,
                            "path": dest,
                            "num_batches": p.num_batches,
                            "num_rows": p.num_rows,
                            "num_bytes": p.num_bytes,
                        }
                    )
                tasks.append(out)
        except OSError:
            self._remove_dir(dest_dir)
            return None
        if total > config.cache_max_bytes:
            self._remove_dir(dest_dir)  # never fits
            return None
        now = time.time()
        entry = CacheEntry(
            fingerprint=fp,
            job_id=job_id,
            stage_id=stage_id,
            n_tasks=len(task_partitions),
            tasks=tasks,
            bytes=total,
            created_unix=now,
            last_used_unix=now,
            schema_names=list(schema_names),
            plan=plan_summary,
        )
        with self._lock:
            if fp in self._entries:  # lost a store race: keep the first
                self._remove_dir(dest_dir)
                return self._entries[fp]
            self._entries[fp] = entry
            self._stores.inc()
            self.evicted_fps = self._enforce_locked(config)
            self._save_locked()
        return entry

    def _enforce_locked(self, config: BallistaConfig) -> list[str]:
        """TTL sweep + LRU bytes eviction; returns evicted fingerprints."""
        now = time.time()
        out = []
        for fp in [
            fp
            for fp, e in self._entries.items()
            if now - e.created_unix > config.cache_ttl_seconds
        ]:
            self._evict_locked(fp, reason="ttl")
            out.append(fp)
        while (
            sum(e.bytes for e in self._entries.values())
            > config.cache_max_bytes
            and len(self._entries) > 1
        ):
            lru = min(
                self._entries.values(), key=lambda e: e.last_used_unix
            ).fingerprint
            self._evict_locked(lru, reason="bytes")
            out.append(lru)
        return out

    def _evict_locked(self, fp: str, reason: str) -> None:
        e = self._entries.pop(fp, None)
        if e is None:
            return
        self._evictions.inc()
        self._remove_dir(os.path.join(self.root_dir, fp))
        self._save_locked()

    def _remove_dir(self, d: str) -> None:
        try:
            for name in os.listdir(d):
                try:
                    os.remove(os.path.join(d, name))
                except OSError:
                    pass
            os.rmdir(d)
        except OSError:
            pass

    def invalidate(self, fp: str) -> bool:
        with self._lock:
            present = fp in self._entries
            self._evict_locked(fp, reason="explicit")
            return present

    # -- observability ------------------------------------------------------

    def snapshot(self) -> dict:
        reg = process_registry()
        with self._lock:
            entries = [
                {
                    "fingerprint": e.fingerprint,
                    "job_id": e.job_id,
                    "stage_id": e.stage_id,
                    "n_tasks": e.n_tasks,
                    "bytes": e.bytes,
                    "hits": e.hits,
                    "created_unix": e.created_unix,
                    "last_used_unix": e.last_used_unix,
                    "plan": e.plan,
                }
                for e in sorted(
                    self._entries.values(),
                    key=lambda e: -e.last_used_unix,
                )
            ]
            total = sum(e.bytes for e in self._entries.values())
        return {
            "entries": entries,
            "entry_count": len(entries),
            "total_bytes": total,
            "hits": reg.value("plan_cache_hits_total"),
            "misses": reg.value("plan_cache_misses_total"),
            "stores": reg.value("plan_cache_stores_total"),
            "evictions": reg.value("plan_cache_evictions_total"),
        }


# ---------------------------------------------------------------------------
# graph integration: serve at submit, store at completion
# ---------------------------------------------------------------------------


def _schema_names(plan: Any) -> list[str]:
    try:
        return [f.name for f in plan.schema]
    except Exception:  # noqa: BLE001 - names are a guard, not a requirement
        return []


def _upstream_subtree(sid: int, deps: dict[int, list[int]]) -> set[int]:
    """Every stage feeding ``sid`` transitively, excluding ``sid``."""
    out: set[int] = set()
    frontier = list(deps.get(sid, []))
    while frontier:
        s = frontier.pop()
        if s in out:
            continue
        out.add(s)
        frontier.extend(deps.get(s, []))
    return out


def try_serve(graph: Any, cache: PlanCache, config: BallistaConfig) -> list[int]:
    """Resolve cache-hit subtrees of a freshly-built graph.

    Called by the task manager between graph construction and the first
    ``revive()``: every stage is still in its born state.  Iterates stages
    largest-first (the final stage has the max id) so the biggest matching
    subtree wins; a served stage becomes a fabricated CompletedStage whose
    tasks point at the cached partition files under the external sentinel
    executor, its consumers' inputs complete instantly, and its upstream
    subtree is marked elided (revive never dispatches it).

    A subtree is served only when it is *self-contained* — no interior
    stage feeds a consumer outside it.  A shared producer (diamond DAG)
    must still run for its other consumer, and half-reviving a subtree on
    cache loss would otherwise double-feed that consumer.

    Stores the full fingerprint map on ``graph.cache_fps`` (the
    completion-side store path reuses it) and returns the served sids."""
    from .execution_stage import CompletedStage, StageInput, TaskInfo
    from .planner import find_unresolved_shuffles
    from ..obs.export import CACHE_OP
    from ..serde.scheduler_types import (
        PartitionId,
        PartitionLocation,
        PartitionStats,
        ShuffleWritePartition,
    )
    from ..shuffle.store import EXTERNAL_EXECUTOR, EXTERNAL_EXECUTOR_ID

    plans = {sid: s.plan for sid, s in graph.stages.items()}
    fps = stage_fingerprints(plans)
    graph.cache_fps = fps
    graph.cache_stored = set()
    deps = {
        sid: [sh.stage_id for sh in find_unresolved_shuffles(p)]
        for sid, p in plans.items()
    }
    consumers = {sid: list(graph.stages[sid].output_links) for sid in plans}
    served: list[int] = []
    for sid in sorted(graph.stages, reverse=True):
        if sid in graph.cache_elided or sid in graph.cache_served:
            continue
        fp = fps.get(sid)
        if fp is None:
            continue
        subtree = _upstream_subtree(sid, deps)
        closed = {sid} | subtree
        if any(
            c not in closed for s in subtree for c in consumers.get(s, [])
        ):
            continue  # shared interior producer: not self-contained
        entry = cache.lookup(fp, config)
        if entry is None:
            continue
        stage = graph.stages[sid]
        is_final = sid == graph.final_stage_id
        if is_final and entry.schema_names != _schema_names(stage.plan):
            # alias-normalized fingerprints collide across output names,
            # but the FINAL stage's IPC files embed field names the
            # client surfaces — only an exact-name entry may serve it
            continue
        statuses, locations = [], []
        for k, parts in enumerate(entry.tasks):
            pid = PartitionId(graph.job_id, sid, k)
            swps = []
            for p in parts:
                swp = ShuffleWritePartition(
                    p["partition_id"],
                    p["path"],
                    p["num_batches"],
                    p["num_rows"],
                    p["num_bytes"],
                )
                swps.append(swp)
                locations.append(
                    PartitionLocation(
                        PartitionId(graph.job_id, sid, p["partition_id"]),
                        EXTERNAL_EXECUTOR,
                        PartitionStats(
                            p["num_rows"], p["num_batches"], p["num_bytes"]
                        ),
                        p["path"],
                    )
                )
            statuses.append(
                TaskInfo(pid, "completed", EXTERNAL_EXECUTOR_ID, partitions=swps)
            )
        completed = CompletedStage(
            sid,
            stage.plan,
            list(stage.output_links),
            {d: StageInput(complete=True) for d in deps.get(sid, [])},
            statuses,
            stage_metrics={
                CACHE_OP: {"cache_hit": 1, "bytes": int(entry.bytes)}
            },
        )
        graph.stages[sid] = completed
        graph.cache_served[sid] = fp
        graph.cache_elided.update(subtree)
        for link in consumers.get(sid, []):
            consumer = graph.stages.get(link)
            if hasattr(consumer, "add_input_partitions"):
                consumer.add_input_partitions(sid, locations)
                consumer.complete_input(sid)
        if is_final:
            # full-plan hit: the job is complete before a single task is
            # dispatched; the submit path routes it through complete_job
            from .execution_graph import COMPLETED

            graph.output_locations = locations
            graph.status = COMPLETED
        graph._journal(
            "cache_hit",
            stage=sid,
            fingerprint=fp,
            stages_elided=sorted(subtree),
            bytes=int(entry.bytes),
            full_plan=is_final,
        )
        served.append(sid)
    return served


def store_completed(
    graph: Any, cache: PlanCache, config: BallistaConfig
) -> list[str]:
    """Pin newly-completed eligible stages' outputs under their
    fingerprints.  Called by the task manager after task-status updates
    commit; idempotent per stage per graph (``graph.cache_stored``).
    Returns the fingerprints stored this call."""
    from .execution_stage import CompletedStage

    fps = getattr(graph, "cache_fps", None)
    if not fps:
        return []  # decoded/adopted graph: fingerprints didn't survive
    done = getattr(graph, "cache_stored", None)
    if done is None:
        done = graph.cache_stored = set()
    stored: list[str] = []
    for sid, stage in graph.stages.items():
        if (
            sid in done
            or sid in graph.cache_served
            or sid not in fps
            or not isinstance(stage, CompletedStage)
        ):
            continue
        done.add(sid)
        task_partitions = [
            list(t.partitions)
            for t in stage.task_statuses
            if t is not None
        ]
        entry = cache.store(
            fps[sid],
            graph.job_id,
            sid,
            task_partitions,
            _schema_names(stage.plan),
            f"stage {sid}: {type(stage.plan).__name__}",
            config,
        )
        if entry is None:
            continue
        stored.append(entry.fingerprint)
        graph._journal(
            "cache_store",
            stage=sid,
            fingerprint=entry.fingerprint,
            bytes=int(entry.bytes),
            tasks=entry.n_tasks,
        )
        for fp in getattr(cache, "evicted_fps", None) or []:
            graph._journal("cache_evicted", fingerprint=fp)
        cache.evicted_fps = []
    return stored
