"""Whole-stage fusion in the PyTorch port against the JAX package, on the
CPU.

Twins of ``tests/test_whole_stage_fusion.py`` over the port's copy of
``ops/fusion.py`` and its ``TorchStageExec``: the planner partitions an op
list exactly once and cuts where the reference cuts (each case also run
through the reference's planner); with ``ballista.tpu.whole_stage_fusion``
on, a fusion-eligible stage retains its batches and runs them as ONE
multi-entry launch, and under a shuffle hint the partition ids of its
groups come back with the state, bit-identical to the host partitioner.
Fusion on and off give the same rows (sha over the row set), equal to the
reference's and to the CPU operators'.

One pinned divergence: where the reference re-runs the batches one by
one after a failed fused call (``fused_degraded``), the port raises — a
device error is never caught and worked around (ROADMAP, "Device errors
raise").
"""

import hashlib

import numpy as np
import pyarrow as pa
import pytest

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu.catalog import MemoryTable as JMemoryTable
from arrow_ballista_tpu.ops import fusion as JF
from arrow_ballista_tpu_torch.catalog import MemoryTable as TMemoryTable
from arrow_ballista_tpu_torch.ops.fusion import (
    FusionOp,
    plan_segments,
    stage_ops,
)
from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec

FUSION = {"ballista.tpu.whole_stage_fusion": "true",
          "ballista.mesh.enable": "false"}


def _as_ref(ops):
    return [JF.FusionOp(o.kind, o.traceable, o.pipeline_breaker, o.label) for o in ops]


def _same_plan(ops, max_ops):
    """The port's plan of ``ops``, held to the reference planner's."""
    plan = plan_segments(ops, max_ops)
    ref = JF.plan_segments(_as_ref(ops), max_ops)
    assert [[(o.kind, o.traceable, o.pipeline_breaker) for o in s] for s in plan.segments] == [
        [(o.kind, o.traceable, o.pipeline_breaker) for o in s] for s in ref.segments]
    assert plan.cuts == ref.cuts
    assert plan.compute_fused() == ref.compute_fused()
    assert plan.pid_fused() == ref.pid_fused()
    return plan


# ----------------------------------------------------------------- planner
def _random_ops(rng, n):
    return [
        FusionOp(kind=f"op{i}", traceable=bool(rng.uniform() > 0.2),
                 pipeline_breaker=bool(rng.uniform() > 0.8))
        for i in range(n)
    ]


@pytest.mark.parametrize("seed", range(20))
def test_planner_partitions_exactly_once(seed):
    """Every plan partitions the op list exactly once, in order, and
    equals the reference planner's."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 24))
    ops = _random_ops(rng, n)
    max_ops = int(rng.integers(1, 9))
    plan = _same_plan(ops, max_ops)
    assert [op for seg in plan.segments for op in seg] == ops
    assert all(len(seg) >= 1 for seg in plan.segments)
    for seg in plan.segments:
        if all(op.traceable for op in seg):
            assert len(seg) <= max_ops


def test_planner_non_traceable_forces_own_segment():
    ops = [FusionOp("scan"), FusionOp("udf", traceable=False), FusionOp("agg")]
    plan = _same_plan(ops, 8)
    assert [len(s) for s in plan.segments] == [1, 1, 1]
    assert "non_traceable" in [r for _, r in plan.cuts]
    assert plan.segments[1] == (ops[1],)
    assert not plan.compute_fused()


def test_planner_pipeline_breaker_cuts_before():
    ops = [FusionOp("scan"), FusionOp("filter"),
           FusionOp("join", pipeline_breaker=True), FusionOp("agg")]
    plan = _same_plan(ops, 8)
    assert plan.segments[0] == (ops[0], ops[1])
    assert plan.segments[1] == (ops[2], ops[3])
    assert "pipeline_breaker" in [r for _, r in plan.cuts]


def test_planner_capacity_overflow_splits():
    ops = [FusionOp(f"op{i}") for i in range(7)]
    plan = _same_plan(ops, 3)
    assert [len(s) for s in plan.segments] == [3, 3, 1]
    assert [r for _, r in plan.cuts] == ["capacity", "capacity"]
    assert plan.max_segment_ops == 3


def test_planner_single_segment_when_all_traceable():
    ops = [FusionOp("scan"), FusionOp("filter"), FusionOp("agg")]
    plan = _same_plan(ops, 8)
    assert len(plan.segments) == 1
    assert plan.compute_fused()
    assert plan.max_segment_ops == 3


# ------------------------------------------------------------ query parity
def _settings(tpu: bool, extra: dict) -> dict:
    s = {
        "ballista.tpu.enable": "true" if tpu else "false",
        "ballista.tpu.min_rows": "0",
        "ballista.shuffle.partitions": "1",
        "ballista.mesh.enable": "false",
    }
    s.update({k: str(v) for k, v in extra.items()})
    return s


def _port(**extra):
    return tbt.SessionContext(tbt.BallistaConfig(_settings(True, extra)), device="cpu")


def _jax(tpu: bool, **extra):
    return jbt.SessionContext(jbt.BallistaConfig(_settings(tpu, extra)))


def _reg(ctx, name, table, partitions=1):
    mt = TMemoryTable if isinstance(ctx, tbt.SessionContext) else JMemoryTable
    ctx.register_table(name, mt.from_table(table, partitions))


def _stage_metrics(plan) -> dict:
    agg: dict = {}
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, TorchStageExec):
            for k, v in node.metrics.to_dict().items():
                agg[k] = agg.get(k, 0) + v
        stack.extend(node.children())
    return agg


def _run(ctx, sql):
    plan = ctx.sql(sql).physical_plan()
    table = ctx.execute(plan)
    return table, _stage_metrics(plan)


def _fingerprint(table: pa.Table) -> str:
    """Order-insensitive sha over the row set (rows sorted by repr)."""
    cols = table.column_names
    rows = sorted(
        repr(tuple(table.column(c)[i].as_py() for c in cols))
        for i in range(table.num_rows)
    )
    h = hashlib.sha256()
    for r in rows:
        h.update(r.encode())
    return h.hexdigest()


def _assert_tables_close(a: pa.Table, b: pa.Table, rel=1e-9):
    """``tests/test_tpu_stage.py:_assert_tables_equal``'s bar across the
    two packages (their sums add in different orders)."""
    assert a.schema.names == b.schema.names and a.num_rows == b.num_rows
    keys = [(c, "ascending") for c in a.column_names
            if not pa.types.is_floating(a.schema.field(c).type)]
    a, b = a.sort_by(keys), b.sort_by(keys)
    for name in a.schema.names:
        for x, y in zip(a.column(name).to_pylist(), b.column(name).to_pylist()):
            if isinstance(x, float) and x is not None and y is not None:
                assert y == pytest.approx(x, rel=rel), name
            else:
                assert x == y, name


def _mktable(n=6000, groups=9, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, groups, n), pa.int64()),
        "v": pa.array(rng.uniform(-100, 100, n), pa.float64()),
        "q": pa.array(rng.integers(1, 50, n).astype(np.float64)),
    })


SHAPES = {
    "filter": "select k, sum(v), count(v) from t where q < 30 group by k",
    "project": ("select k, sum(v * q), min(v + q) from t "
                "where v > -50 group by k"),
    "partial_agg": "select k, sum(v), count(*), min(q), max(v) from t "
                   "group by k",
    "scalar": "select sum(v), count(*), min(v) from t where q < 25",
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fusion_on_off_sha_identical(shape):
    sql = SHAPES[shape]
    t = _mktable()
    c_off, c_on = _port(), _port(**FUSION)
    _reg(c_off, "t", t)
    _reg(c_on, "t", t)
    off, m_off = _run(c_off, sql)
    on, m_on = _run(c_on, sql)
    assert _fingerprint(off) == _fingerprint(on)
    assert m_off.get("fused_segments", 0) == 0  # knob off: no planner
    assert m_on.get("fused_segments", 0) >= 1, m_on
    assert m_on.get("fused_ops_per_dispatch", 0) >= 2, m_on
    # the reference's fused stage gives the same rows and the same plan
    j_on = _jax(True, **FUSION)
    _reg(j_on, "t", t)
    jt = j_on.sql(sql)
    jplan = jt.physical_plan()
    _assert_tables_close(j_on.execute(jplan), on)
    from arrow_ballista_tpu.ops.stage_compiler import TpuStageExec

    stack, jm = [jplan], {}
    while stack:
        node = stack.pop()
        if isinstance(node, TpuStageExec):
            jm = node.metrics.values
        stack.extend(node.children())
    for k in ("fused_segments", "fused_ops_per_dispatch"):
        assert m_on.get(k) == jm.get(k), (k, m_on, jm)


def test_fusion_join_shape_sha_identical():
    n = 5000
    rng = np.random.default_rng(2)
    fact = pa.table({
        "fk": pa.array(rng.integers(0, 100, n), pa.int64()),
        "grp": pa.array(rng.integers(0, 5, n), pa.int64()),
        "x": pa.array(rng.uniform(0, 1, n), pa.float64()),
    })
    dim = pa.table({
        "pk": pa.array(np.arange(100), pa.int64()),
        "dv": pa.array(np.linspace(0.5, 1.5, 100)),
    })
    sql = ("select grp, sum(x * dv), count(*) from dim, fact "
           "where pk = fk group by grp")
    c_off, c_on, j_on = _port(), _port(**FUSION), _jax(True, **FUSION)
    for c in (c_off, c_on, j_on):
        _reg(c, "fact", fact)
        _reg(c, "dim", dim)
    off, _ = _run(c_off, sql)
    on, m_on = _run(c_on, sql)
    assert _fingerprint(off) == _fingerprint(on)
    assert m_on.get("fused_dispatches", 0) == 0, m_on  # a join stage never fuses
    _assert_tables_close(j_on.sql(sql).collect(), on)


def test_fusion_matches_cpu_oracle():
    t = _mktable(seed=3)
    c_cpu, c_on = _jax(False), _port(**FUSION)
    _reg(c_cpu, "t", t)
    _reg(c_on, "t", t)
    cpu, _ = _run(c_cpu, SHAPES["partial_agg"])
    on, m = _run(c_on, SHAPES["partial_agg"])
    assert _fingerprint(cpu) == _fingerprint(on)
    assert m.get("fused_dispatches", 0) >= 1, m


def test_knob_off_is_byte_identical():
    """Knob off leaves the run untouched: batches from a knob-off run equal
    (pa equals, byte level) a run on a config that never mentions it."""
    t = _mktable(seed=4)
    c_base, c_off = _port(), _port(**{"ballista.tpu.whole_stage_fusion": "false"})
    _reg(c_base, "t", t)
    _reg(c_off, "t", t)
    base, _mb = _run(c_base, SHAPES["partial_agg"])
    off, mo = _run(c_off, SHAPES["partial_agg"])
    bb, ob = base.combine_chunks().to_batches(), off.combine_chunks().to_batches()
    assert len(bb) == len(ob)
    for x, y in zip(bb, ob):
        assert x.equals(y)
    assert mo.get("fused_segments", 0) == 0


# -------------------------------------------------------- pid in the fetch
def _find_stage(plan):
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, TorchStageExec):
            return node
        stack.extend(node.children())
    return None


def _stage_with_hint(n_out=4, fusion=True, n=4000, groups=50, **extra):
    from arrow_ballista_tpu_torch.exec import expressions as pe

    ctx = _port(**(FUSION if fusion else {}), **extra)
    t = _mktable(n=n, groups=groups, seed=5)
    _reg(ctx, "t", t)
    plan = ctx.sql(SHAPES["partial_agg"]).physical_plan()
    st = _find_stage(plan)
    assert st is not None
    st.install_shuffle_hint([pe.Col(0, "k")], n_out)
    return ctx, st


def test_fused_pid_matches_host_partitioner():
    """The pid column fetched with the fused run's state is bit-identical
    to the host partitioner over the stage's output keys."""
    from arrow_ballista_tpu_torch.exec import expressions as pe
    from arrow_ballista_tpu_torch.exec.operators import (
        SHUFFLE_PID_COLUMN,
        TaskContext,
        hash_partition_indices,
    )

    n_out = 4
    ctx, st = _stage_with_hint(n_out=n_out)
    batches = list(st.execute(0, TaskContext(config=ctx.config)))
    m = st.metrics.to_dict()
    assert m.get("fused_pid_in_kernel", 0) >= 1, m
    assert m.get("fused_segments", 0) == 1, m
    out = pa.Table.from_batches(batches)
    assert SHUFFLE_PID_COLUMN in out.column_names
    stripped = out.drop([SHUFFLE_PID_COLUMN])
    for b_out, b_strip in zip(out.combine_chunks().to_batches(),
                              stripped.combine_chunks().to_batches()):
        oracle = hash_partition_indices(b_strip, [pe.Col(0, "k")], n_out)
        got = np.asarray(b_out.column(SHUFFLE_PID_COLUMN))
        np.testing.assert_array_equal(got, oracle)


def test_fused_pid_off_matches_on():
    """Hinted stage output (pid column included) is identical whether the
    pids came with the fused run's fetch or from the separate kernel."""
    from arrow_ballista_tpu_torch.exec.operators import TaskContext

    ctx_on, st_on = _stage_with_hint(fusion=True)
    ctx_off, st_off = _stage_with_hint(fusion=False)
    on = pa.Table.from_batches(list(st_on.execute(0, TaskContext(config=ctx_on.config))))
    off = pa.Table.from_batches(list(st_off.execute(0, TaskContext(config=ctx_off.config))))
    assert st_on.metrics.to_dict().get("fused_pid_in_kernel", 0) >= 1
    assert st_off.metrics.to_dict().get("fused_pid_in_kernel", 0) == 0
    assert _fingerprint(on) == _fingerprint(off)


def test_fused_failure_raises_instead_of_degrading(monkeypatch):
    """Pinned divergence: the reference re-runs the batches one by one when
    its fused call fails (``fused_degraded``); the port's fused launch
    failing raises, with no degrade and no CPU re-run, on the fusion path
    and on the cache path alike."""
    from arrow_ballista_tpu_torch.errors import ExecutionError
    from arrow_ballista_tpu_torch.ops import kernels as TK

    def boom(*args, **kwargs):
        raise ExecutionError("injected fused failure")

    monkeypatch.setattr(TK, "segment_agg_entries", boom)
    for extra in (dict(FUSION, **{"ballista.tpu.cache_columns": "false"}), {}):
        ctx = _port(**extra)
        _reg(ctx, "t", _mktable(seed=6))
        plan = ctx.sql(SHAPES["partial_agg"]).physical_plan()
        with pytest.raises(ExecutionError, match="injected fused failure"):
            ctx.execute(plan)
        m = _stage_metrics(plan)
        for k in ("fused_degraded", "fused_dispatches", "tpu_fallback", "cpu_fallback"):
            assert k not in m, (k, m)


def test_stage_ops_enumerates_shuffle_pid():
    """stage_ops includes the shuffle_pid op exactly when a hint is
    installed, and marks it traceable when the pid spec is derivable."""
    _ctx, st = _stage_with_hint()
    kinds = [op.kind for op in stage_ops(st)]
    assert "shuffle_pid" in kinds
    pid_op = [op for op in stage_ops(st) if op.kind == "shuffle_pid"][0]
    assert pid_op.traceable
    st._shuffle_hint = None
    assert "shuffle_pid" not in [op.kind for op in stage_ops(st)]


def test_fusion_only_retain_streams_below_min_rows(monkeypatch):
    """A fusion-only stage (the column cache off) retains its batches for
    one run: below ``_FUSION_MIN_ROWS`` they stream one launch each, at or
    above it they fold in one multi-entry launch; the bounds are the
    reference's and stay overridable, and the answer is the same."""
    from arrow_ballista_tpu.ops import stage_compiler as JSC
    from arrow_ballista_tpu_torch.ops import stage_compiler as TSC

    assert (TSC._FUSION_MAX_OPS, TSC._FUSION_MIN_ROWS) == (8, 2048) == (
        JSC._fusion_max_ops(), JSC._fusion_min_rows())
    t = _mktable(n=1500, seed=12)
    extra = dict(FUSION, **{"ballista.tpu.cache_columns": "false",
                            "ballista.batch.size": 512})
    want = _jax(False)
    _reg(want, "t", t)
    want = want.sql(SHAPES["partial_agg"]).collect()
    results = []
    for min_rows, fused in ((2048, 0), (0, 1)):
        monkeypatch.setattr(TSC, "_FUSION_MIN_ROWS", min_rows)
        ctx = _port(**extra)
        _reg(ctx, "t", t)
        got, m = _run(ctx, SHAPES["partial_agg"])
        assert m.get("fused_dispatches", 0) == fused, m
        assert m.get("cache_hits", 0) == 0, m
        _assert_tables_close(want, got)
        results.append(got)
    assert _fingerprint(results[0]) == _fingerprint(results[1])
