"""The PyTorch port stands alone: it never imports jax or the JAX package,
its host modules are copies of the JAX package's, and a session without a
CUDA device refuses to run rather than quietly using the CPU."""

import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "arrow_ballista_tpu_torch")
REF = os.path.join(ROOT, "arrow_ballista_tpu")

# the import closures of context.py and client/context.py, copied with only
# the import root changed and the reference's history tags left out
HOST_COPIES = [
    "errors.py", "config.py", "udf.py", "catalog.py", "avro.py",
    "sql/__init__.py", "sql/lexer.py", "sql/ast.py", "sql/parser.py",
    "plan/__init__.py", "plan/logical.py", "plan/expressions.py",
    "plan/builder.py", "plan/optimizer.py",
    "exec/__init__.py", "exec/expressions.py", "exec/operators.py",
    "exec/aggregates.py", "exec/joins.py", "exec/planner.py", "ops/groups.py",
    "client/__init__.py",
    "executor/__init__.py", "executor/execution_loop.py", "executor/server.py",
    "executor/isolation.py",
    "flight/__init__.py", "flight/client.py", "flight/server.py",
    "native/__init__.py", "native/partitioner.cc",
    "obs/__init__.py", "obs/critical_path.py", "obs/doctor.py", "obs/events.py",
    "obs/recorder.py", "obs/registry.py", "obs/telemetry.py", "obs/timeseries.py",
    "obs/trace.py",
    "proto/rpc.py", "proto/ballista.proto", "proto/keda.proto",
    "proto/gen/ballista_pb2.py", "proto/gen/keda_pb2.py",
    "scheduler/__init__.py", "scheduler/admission.py", "scheduler/autoscaler.py",
    "scheduler/backend.py", "scheduler/display.py", "scheduler/event_loop.py",
    "scheduler/execution_graph.py", "scheduler/execution_stage.py",
    "scheduler/executor_manager.py", "scheduler/external_scaler.py",
    "scheduler/failure.py", "scheduler/grpc_service.py", "scheduler/kvstore.py",
    "scheduler/policy_store.py", "scheduler/query_stage_scheduler.py",
    "scheduler/queue_wal.py", "scheduler/server.py", "scheduler/speculation.py",
    "scheduler/standalone.py", "scheduler/state.py", "scheduler/task_manager.py",
    "scheduler/task_status.py",
    "serde/__init__.py", "serde/arrow_utils.py", "serde/expressions.py",
    "serde/logical_plan.py", "serde/scheduler_types.py",
    "shuffle/__init__.py", "shuffle/store.py", "shuffle/transport.py",
    "shuffle/fetcher.py", "shuffle/writer.py", "shuffle/memory_store.py",
    "shuffle/delta_store.py",
    "testing/__init__.py", "testing/faults.py", "utils/diagram.py",
]
# ported, not copied: context.py gains the device, ops/bridge.py gains the
# device staging (appended after the copied body) and a zigzag identity key
# encoder (negative keys stay on the device route), the two sorting
# operators sort through exec/operators.py:sort_indices, because pyarrow
# before 25 rejects per-key null placement, exec/window.py's float running
# sums restart per segment (_segmented_cumsum), and the window lowering
# (ops/window_compiler.py, ops/window_kernel.py) runs the port's kernels,
# x64 only, and raises on device errors instead of re-running on the CPU
ALLOWLIST = {
    "context.py", "ops/bridge.py", "exec/operators.py", "exec/window.py",
    "ops/window_compiler.py", "ops/window_kernel.py",
    # imports its own generated modules package-qualified (a bare
    # `ballista_pb2` would resolve to the JAX package's through sys.modules)
    "proto/__init__.py",
    # unwraps TorchStageExec/TorchWindowExec; the mesh nodes are not ported
    "serde/physical_plan.py",
    # the writer's mesh branches go (the mesh is not ported)
    "shuffle/execution_plans.py",
    # no mesh rewrite: every shuffle boundary is a writer hop
    "scheduler/planner.py",
    # the AQE broadcast rewrite has no mesh gang bodies to skip
    "scheduler/adaptive.py",
    # fingerprints the port's device wrappers as the plan they wrap
    "scheduler/plan_cache.py",
    # the scheduler's sessions only plan, so they need no CUDA device
    "scheduler/session_manager.py",
    # the executor carries a torch device and accelerates on it; a cuda
    # executor keeps device stages in its own process
    "executor/executor.py",
    # passes the device on to the executor
    "executor/standalone.py",
    # the task-runner worker builds its executor on device="cpu", no jax
    "executor/task_runner.py",
    # BallistaContext(device=...): standalone hands it to every executor
    "client/context.py",
    # profiles roll up the port's device stages (TorchStage*, TorchWindow*)
    "obs/export.py",
    # apply_jax_platform_env goes (only the JAX package's binaries call it)
    "utils/__init__.py",
}


def _is_forbidden(module: str) -> bool:
    return module == "jax" or module.startswith("jax.") or (
        module == "arrow_ballista_tpu" or module.startswith("arrow_ballista_tpu.")
    )


def _imports(path: str) -> list[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def _port_sources() -> list[str]:
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        paths.extend(os.path.join(d, f) for f in files if f.endswith(".py"))
    return sorted(paths)


def test_static_scan_finds_no_jax_or_reference_import():
    bad = [
        (os.path.relpath(p, ROOT), m)
        for p in _port_sources()
        for m in _imports(p)
        if _is_forbidden(m)
    ]
    assert not bad, bad


def _normalise(text: str) -> str:
    text = re.sub(r"\barrow_ballista_tpu\b", "arrow_ballista_tpu_torch", text)
    # the copies name the upstream reference without its checkout path
    text = re.sub(r"in /\w+/reference", "in the reference", text)
    return _drop_history_tags(text)


_TAG = r"(?:ISSUE|PR) \d+(?:/\d+)?"


def _drop_history_tags(text: str) -> str:
    """The copies leave out the reference's history tags (the issue or
    change number that introduced a feature), rewording around them."""
    text = re.sub(r"(?:\n[ \t]*#?)? ?\(" + _TAG + r"(?: [\w ,]*)?\)", "", text)
    text = re.sub(r"\(" + _TAG + r"(?: [\w ]*)?(?:[;,:]| —) ", "(", text)
    text = re.sub(r"(?:,|;)\s*" + _TAG + r"\)", ")", text)
    text = re.sub(r"^" + _TAG + r"'s (\w)", lambda m: "The " + m.group(1), text, flags=re.M)
    text = re.sub(_TAG + r"'s\b", "the", text)
    text = re.sub(r" (?:of|in)(\s+)" + _TAG + r" ", r"\1", text)
    return re.sub(r"\bthe " + _TAG + r"(?=\s)", "the", text)


@pytest.mark.parametrize("rel", HOST_COPIES + sorted(ALLOWLIST))
def test_host_copy_equals_original(rel):
    with open(os.path.join(REF, rel)) as f:
        want = _normalise(f.read())
    with open(os.path.join(PORT, rel)) as f:
        got = f.read()
    if rel == "ops/bridge.py":
        assert _drop_identity_encoder(got).startswith(_drop_identity_encoder(want))
    elif rel == "exec/window.py":
        assert _drop_segmented_cumsum(_undo_sort_helper(got)) == _drop_segmented_cumsum(want)
    elif rel.startswith("exec/"):
        assert _undo_sort_helper(got) == want
    elif rel not in ALLOWLIST:
        assert got == want


def _drop_identity_encoder(text: str) -> str:
    return re.sub(
        r"class IdentityKeyEncoder:.*?\n\n\n(?=class )", "", text, count=1, flags=re.S
    )


def _drop_segmented_cumsum(text: str) -> str:
    # the port's float cumsum restarts per segment (the reference rounds
    # running float sums at the whole table's magnitude)
    return re.sub(
        r"def _segmented_cumsum\(.*?\n\n\n(?=def )", "", text, count=1, flags=re.S
    )


def _undo_sort_helper(text: str) -> str:
    text = re.sub(r"def sort_indices\(.*?\n\n\n(?=class SortExec)", "", text, flags=re.S)
    text = text.replace(
        "sort_indices(sort_tbl, keys)", "pc.sort_indices(sort_tbl, sort_keys=keys)"
    )
    return text.replace(", TaskContext, sort_indices\n", ", TaskContext\n")


SUBPROCESS_Q1 = r"""
import sys
sys.path.insert(0, sys.argv[1])
import arrow_ballista_tpu_torch as tbt
from benchmarks.tpch.datagen import gen_lineitem
from benchmarks.tpch.queries import QUERIES

ctx = tbt.SessionContext(
    tbt.BallistaConfig({"ballista.tpu.min_rows": "0"}), device="cpu"
)
ctx.register_arrow_table("lineitem", gen_lineitem(0.01), partitions=2)
df = ctx.sql(QUERIES[1])
assert "TorchStageExec" in df.explain()
out = df.collect()
assert out.num_rows == 4, out.num_rows
leaked = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.")
    or m == "arrow_ballista_tpu" or m.startswith("arrow_ballista_tpu.")
)
print("LEAKED", leaked)
assert not leaked, leaked
"""


def test_q1_in_subprocess_loads_no_jax():
    r = subprocess.run(
        [sys.executable, "-c", SUBPROCESS_Q1, ROOT],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


SUBPROCESS_STANDALONE_Q3 = r"""
import os, sys, tempfile
root = sys.argv[1]
sys.path.insert(0, root)
tmp = os.path.realpath(tempfile.gettempdir())
inside = (tmp + os.sep, os.path.realpath(root) + os.sep)  # TMPDIR, the checkout
outside = []


def audit(event, args):
    # every file or directory this process creates, writes or removes
    if event == "open" and args[0] is not None and not isinstance(args[0], int):
        flags = args[2] if isinstance(args[2], int) else 0
        if not (flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)) and (
            not args[1] or not set(args[1]) & set("wax+")
        ):
            return
    elif event not in ("os.mkdir", "os.rename", "os.replace", "os.remove",
                       "os.rmdir", "shutil.rmtree"):
        return
    elif isinstance(args[-1], int) and args[-1] >= 0:
        return  # relative to a directory whose own event was checked
    path = args[0]
    if isinstance(path, (str, bytes, os.PathLike)):
        path = os.path.realpath(os.fsdecode(path))
        if path != os.devnull and not path.startswith(inside):
            outside.append((event, path))


sys.addaudithook(audit)
import pyarrow.parquet as pq
import arrow_ballista_tpu_torch as tbt
from benchmarks.tpch.datagen import gen_table
from benchmarks.tpch.queries import QUERIES

d = tempfile.mkdtemp()
ctx = tbt.BallistaContext.standalone(
    tbt.BallistaConfig({"ballista.tpu.min_rows": "0",
                        "ballista.shuffle.partitions": "2"}),
    num_executors=1, concurrent_tasks=2, device="cpu",
)
try:
    for name in ("lineitem", "orders", "customer"):
        os.makedirs(os.path.join(d, name))
        pq.write_table(gen_table(name, 0.01), os.path.join(d, name, "p0.parquet"))
        ctx.register_parquet(name, os.path.join(d, name))
    out = ctx.sql(QUERIES[3]).collect()
    assert out.num_rows == 10, out.num_rows
finally:
    ctx.close()
ref = os.path.join(root, "arrow_ballista_tpu") + os.sep
leaked = sorted(
    m for m, mod in list(sys.modules.items())
    if m == "jax" or m.startswith("jax.")
    or m == "arrow_ballista_tpu" or m.startswith("arrow_ballista_tpu.")
    or os.path.abspath(getattr(mod, "__file__", None) or "").startswith(ref)
)
print("LEAKED", leaked)
print("OUTSIDE", sorted(set(outside)))
print("LEFT_IN_TMPDIR", sorted(os.listdir(tmp)))
"""


@pytest.fixture(scope="module")
def standalone_q3_run(tmp_path_factory):
    """One q3 through the port's standalone cluster in a fresh process
    whose TMPDIR is a directory of its own; its stdout."""
    tmp = tmp_path_factory.mktemp("standalone-tmpdir")
    env = dict(os.environ, TMPDIR=str(tmp), PYTHONDONTWRITEBYTECODE="1")
    r = subprocess.run(
        [sys.executable, "-c", SUBPROCESS_STANDALONE_Q3, ROOT],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_standalone_q3_in_subprocess_loads_no_jax(standalone_q3_run):
    """The distributed path loads no jax and no file of the JAX package
    (a bare ``ballista_pb2`` import would load the JAX package's copy)."""
    assert "LEAKED []" in standalone_q3_run


def test_standalone_cluster_writes_only_under_tmpdir(standalone_q3_run):
    """The scheduler, executors, shuffle and Flight of a standalone cluster
    create, write and remove files only under TMPDIR and the checkout (the
    native partitioner's build): no fixed path that two checkouts or the
    JAX package's cluster would share.  close() removes the scheduler's
    directory."""
    assert "OUTSIDE []" in standalone_q3_run, standalone_q3_run
    left = [ln for ln in standalone_q3_run.splitlines() if ln.startswith("LEFT_IN_TMPDIR")]
    assert left and "ballista-scheduler-" not in left[0], standalone_q3_run


def test_session_without_cuda_raises(monkeypatch):
    import torch

    import arrow_ballista_tpu_torch as tbt
    from arrow_ballista_tpu_torch.errors import ExecutionError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ExecutionError):
        tbt.SessionContext()
    with pytest.raises(ExecutionError):
        tbt.SessionContext(device="cuda")
    assert tbt.SessionContext(device="cpu").device.type == "cpu"


def test_standalone_without_cuda_raises(monkeypatch):
    import torch

    import arrow_ballista_tpu_torch as tbt
    from arrow_ballista_tpu_torch.errors import ExecutionError
    from arrow_ballista_tpu_torch.executor.executor import Executor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ExecutionError):
        tbt.BallistaContext.standalone()
    with pytest.raises(ExecutionError):
        tbt.BallistaContext.standalone(device="cuda")
    with pytest.raises(ExecutionError):
        Executor(None, "unused")
