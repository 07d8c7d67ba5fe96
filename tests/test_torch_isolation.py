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

# the import closure of context.py, copied with only the import root changed
HOST_COPIES = [
    "errors.py", "config.py", "udf.py", "catalog.py", "avro.py",
    "sql/__init__.py", "sql/lexer.py", "sql/ast.py", "sql/parser.py",
    "plan/__init__.py", "plan/logical.py", "plan/expressions.py",
    "plan/builder.py", "plan/optimizer.py",
    "exec/__init__.py", "exec/expressions.py", "exec/operators.py",
    "exec/aggregates.py", "exec/joins.py", "exec/planner.py", "ops/groups.py",
]
# ported, not copied: context.py gains the device, ops/bridge.py gains the
# device staging (appended after the copied body) and a zigzag identity key
# encoder (negative keys stay on the device route), and the two sorting
# operators sort through exec/operators.py:sort_indices, because pyarrow
# before 25 rejects per-key null placement
ALLOWLIST = {"context.py", "ops/bridge.py", "exec/operators.py", "exec/window.py"}


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
    return re.sub(r"in /\w+/reference", "in the reference", text)


@pytest.mark.parametrize("rel", HOST_COPIES + sorted(ALLOWLIST))
def test_host_copy_equals_original(rel):
    with open(os.path.join(REF, rel)) as f:
        want = _normalise(f.read())
    with open(os.path.join(PORT, rel)) as f:
        got = f.read()
    if rel == "ops/bridge.py":
        assert _drop_identity_encoder(got).startswith(_drop_identity_encoder(want))
    elif rel.startswith("exec/"):
        assert _undo_sort_helper(got) == want
    elif rel not in ALLOWLIST:
        assert got == want


def _drop_identity_encoder(text: str) -> str:
    return re.sub(
        r"class IdentityKeyEncoder:.*?\n\n\n(?=class )", "", text, count=1, flags=re.S
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
