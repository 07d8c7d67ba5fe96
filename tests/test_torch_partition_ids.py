"""The PyTorch port's shuffle partition ids (kernel B4) against the JAX
package's.

On ``device="cpu"`` the port runs the kernel's plain twin
(``partition_ids_twin``, int64 arithmetic).  Its ids must be bit-identical
to both of the JAX package's partitioners — the host
``exec.operators.hash_partition_indices`` and the jitted
``ops.kernels.device_partition_ids`` (run on the CPU, as
``tests/test_shuffle_writer.py`` runs it) — over every key type the device
hash takes, nulls, NaN, ±0.0 and ±inf, one to four key columns and
partition counts up to 2^16: map and reduce sides must co-partition
whichever side computed the ids.  Then the port's ``ShuffleWriterExec``
over a ``TorchStageExec`` writes the same rows to the same partitions as
the JAX package's over ``TpuStageExec``.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu.catalog import MemoryTable as JMemoryTable
from arrow_ballista_tpu.exec import expressions as jpe
from arrow_ballista_tpu.exec.operators import Partitioning as JPartitioning
from arrow_ballista_tpu.exec.operators import TaskContext as JTaskContext
from arrow_ballista_tpu.exec.operators import hash_partition_indices as j_host_ids
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu.ops.stage_compiler import TpuStageExec
from arrow_ballista_tpu.shuffle import ShuffleWriterExec as JShuffleWriterExec
from arrow_ballista_tpu_torch.exec import expressions as tpe
from arrow_ballista_tpu_torch.exec.operators import Partitioning as TPartitioning
from arrow_ballista_tpu_torch.exec.operators import TaskContext as TTaskContext
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec
from arrow_ballista_tpu_torch.shuffle import ShuffleWriterExec as TShuffleWriterExec

CPU = torch.device("cpu")
N_ROWS = 1500
N_OUT = (1, 2, 3, 7, 200, 65536)


def _nulls(rng, n):
    return rng.random(n) < 0.1


def _float_values(rng, n, dtype):
    v = rng.standard_normal(n).astype(dtype) * 1e3
    special = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf], dtype=dtype)
    v[: 5 * 20] = np.tile(special, 20)
    rng.shuffle(v)
    return v


def _column(kind: str, rng, n: int) -> pa.Array:
    mask = _nulls(rng, n)
    if kind in ("int8", "int16", "int32", "int64"):
        info = np.iinfo(kind)
        v = rng.integers(info.min, info.max, n, dtype=kind, endpoint=True)
        v[:50] = rng.integers(-3, 3, 50)  # small keys repeat, negatives too
        return pa.array(v, mask=mask)
    if kind == "uint32":
        return pa.array(rng.integers(0, 2**32, n, dtype=np.uint32), mask=mask)
    if kind == "float32":
        return pa.array(_float_values(rng, n, np.float32), mask=mask)
    if kind == "float64":
        return pa.array(_float_values(rng, n, np.float64), mask=mask)
    if kind == "bool":
        return pa.array(rng.random(n) < 0.5, mask=mask)
    if kind == "date32":
        days = rng.integers(-40_000, 40_000, n).astype("datetime64[D]")
        return pa.array(days, pa.date32(), mask=mask)
    if kind == "date64":
        ms = rng.integers(-2**40, 2**40, n).astype("datetime64[ms]")
        return pa.array(ms, pa.date64(), mask=mask)
    if kind == "timestamp":
        us = rng.integers(-2**55, 2**55, n).astype("datetime64[us]")
        return pa.array(us, pa.timestamp("us"), mask=mask)
    raise AssertionError(kind)


KINDS = [
    "int8", "int16", "int32", "int64", "uint32", "float32", "float64",
    "bool", "date32", "date64", "timestamp",
]
COLUMN_SETS = [(k,) for k in KINDS] + [
    ("int64", "date32"),
    ("int64", "date32", "int32"),  # q3's partial-aggregate keys
    ("float64", "bool", "timestamp"),
    ("int8", "float32", "date64", "uint32"),
]


def _batch(kinds, seed: int) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    cols = [_column(k, rng, N_ROWS) for k in kinds]
    return pa.RecordBatch.from_arrays(cols, [f"c{i}" for i in range(len(cols))])


@pytest.mark.parametrize("n_out", N_OUT)
@pytest.mark.parametrize("kinds", COLUMN_SETS, ids="-".join)
def test_twin_equals_both_reference_partitioners(kinds, n_out):
    batch = _batch(kinds, seed=len(kinds) * 1000 + n_out)
    t_exprs = [tpe.Col(i, f"c{i}") for i in range(len(kinds))]
    j_exprs = [jpe.Col(i, f"c{i}") for i in range(len(kinds))]
    got = TK.device_partition_ids(batch, t_exprs, n_out, CPU)
    assert got is not None and got.dtype == np.int32
    host = j_host_ids(batch, j_exprs, n_out)
    jitted = JK.device_partition_ids(batch, j_exprs, n_out)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, jitted)
    assert got.min() >= 0 and got.max() < n_out


def test_gates_return_none_like_the_reference():
    rng = np.random.default_rng(3)
    batch = pa.RecordBatch.from_arrays(
        [pa.array(rng.integers(0, 100, 64)), pa.array([f"s{i}" for i in range(64)])],
        ["i", "s"],
    )
    i_col, s_col = tpe.Col(0, "i"), tpe.Col(1, "s")
    computed = tpe.Binary(i_col, "+", tpe.Lit(1, pa.int64()))
    cases = [
        ([s_col], 4),  # a string key hashes on the host
        ([i_col, s_col], 4),
        ([i_col], (1 << 16) + 1),  # past the device hash's partition bound
        ([i_col], 0),
        ([computed], 4),  # not a column
        ([tpe.Col(5, "x")], 4),  # out of the batch
        ([], 4),
    ]
    jmap = {id(i_col): jpe.Col(0, "i"), id(s_col): jpe.Col(1, "s")}
    for exprs, n in cases:
        assert TK.device_partition_ids(batch, exprs, n, CPU) is None, (exprs, n)
        j_exprs = [jmap.get(id(e), jpe.Col(5, "x")) for e in exprs]
        if all(id(e) in jmap for e in exprs):
            assert JK.device_partition_ids(batch, j_exprs, n) is None
    assert TK.device_partition_ids(batch.slice(0, 0), [i_col], 4, CPU) is None


def test_twin_on_raw_words():
    """The u64 corner cases the int64 arithmetic must wrap through: the
    extremes of the word, a hash with its top bit set, n_out of 1."""
    words = np.array(
        [0, 1, -1, 2**63 - 1, -(2**63), 0x5A5A5A5A5A5A5A5A, -0x1234567890ABCDEF],
        dtype=np.int64,
    )
    nulls = np.array([False, False, True, False, False, False, False])
    for n_out in (1, 2, 65535, 65536):
        got = TK.partition_ids_twin(
            torch.from_numpy(words[None]), torch.from_numpy(nulls[None]), n_out
        ).numpy()
        h = words.view(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        h ^= h >> np.uint64(32)
        h = np.where(nulls, np.uint64(0xA5A5A5A5DEADBEEF), h)
        np.testing.assert_array_equal(got, (h % np.uint64(n_out)).astype(np.int32))


def test_partition_ids_rejects_bad_input_before_the_kernel():
    bits = torch.zeros((2, 8), dtype=torch.int64)
    nulls = torch.zeros((2, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA int64"):
        TK.partition_ids_cuda(bits, nulls, 4)  # a CPU tensor never launches


def test_launch_counts_lose_no_update_across_threads():
    """Executor task threads share one card and one LAUNCHES dict."""
    import sys
    import threading

    n_threads, per_thread = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        TK.LAUNCHES["partition_ids"] = 0
        threads = [
            threading.Thread(
                target=lambda: [TK.count_launch("partition_ids") for _ in range(per_thread)]
            )
            for _ in range(n_threads)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert TK.LAUNCHES["partition_ids"] == n_threads * per_thread


# ------------------------------------------------------------ the writer
def _group_table(seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    n = 6000
    # non-negative keys: the reference re-runs negative ones on the CPU
    return pa.table({
        "k": pa.array(rng.integers(0, 40, n), pa.int64()),
        "d": pa.array(rng.integers(8000, 8010, n).astype("datetime64[D]"),
                      pa.date32(), mask=rng.random(n) < 0.05),
        "p": pa.array(rng.integers(0, 3, n), pa.int32()),
        "v": pa.array(rng.normal(size=n)),
    })


SQL = "select k, d, p, sum(v) as s, count(*) as c from t group by k, d, p"
CONFIG = {"ballista.tpu.min_rows": "0", "ballista.mesh.enable": "false"}


def _find(plan, cls):
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, cls):
            return node
        stack.extend(node.children())
    raise AssertionError(f"no {cls.__name__} in the plan")


def _written(stats) -> dict:
    """partition id -> rows written there, sorted."""
    out: dict = {}
    for s in stats:
        with pa.OSFile(s.path, "rb") as f:
            r = pa.ipc.open_file(f)
            tbl = pa.Table.from_batches([r.get_batch(i) for i in range(r.num_record_batches)])
        assert "__shuffle_pid__" not in tbl.schema.names
        out[s.partition_id] = sorted(tbl.to_pylist(), key=repr)
    return out


@pytest.mark.parametrize("n_out", [3, 8])
def test_writer_over_device_stage_matches_reference(tmp_path, n_out):
    tbl = _group_table(seed=n_out)

    tctx = tbt.SessionContext(tbt.BallistaConfig(dict(CONFIG)), device="cpu")
    tctx.register_arrow_table("t", tbl)
    stage = _find(tctx.sql(SQL).physical_plan(), TorchStageExec)
    keys = tuple(tpe.Col(i, n) for i, n in enumerate("kdp"))
    t_writer = TShuffleWriterExec(
        "jt", 1, stage, str(tmp_path / "port"), TPartitioning.hash(keys, n_out)
    )
    TK.LAUNCHES["partition_ids"] = 0
    t_stats = t_writer.execute_shuffle_write(0, TTaskContext(work_dir=str(tmp_path)))
    assert t_writer.metrics.to_dict().get("device_pid_batches", 0) > 0
    assert TK.LAUNCHES["partition_ids"] == 0  # the twin runs on the CPU

    jctx = jbt.SessionContext(jbt.BallistaConfig(dict(CONFIG, **{"ballista.tpu.enable": "true"})))
    jctx.register_table("t", JMemoryTable.from_table(tbl, 1))
    jstage = _find(jctx.sql(SQL).physical_plan(), TpuStageExec)
    jkeys = tuple(jpe.Col(i, n) for i, n in enumerate("kdp"))
    j_writer = JShuffleWriterExec(
        "jj", 1, jstage, str(tmp_path / "ref"), JPartitioning.hash(jkeys, n_out)
    )
    j_stats = j_writer.execute_shuffle_write(0, JTaskContext(work_dir=str(tmp_path)))
    assert j_writer.metrics.to_dict().get("device_pid_batches", 0) > 0

    got, want = _written(t_stats), _written(j_stats)
    assert sorted(got) == sorted(want)
    for p in got:
        assert len(got[p]) == len(want[p]), p
        for a, b in zip(got[p], want[p]):
            assert a.keys() == b.keys()
            for name in a:
                if isinstance(a[name], float):
                    assert a[name] == pytest.approx(b[name], rel=1e-9)
                else:
                    assert a[name] == b[name], (p, name)
    # every row sits where the host hash puts it
    for s in t_stats:
        with pa.OSFile(s.path, "rb") as f:
            r = pa.ipc.open_file(f)
            for i in range(r.num_record_batches):
                b = r.get_batch(i)
                ids = j_host_ids(b, list(jkeys), n_out)
                assert (ids == s.partition_id).all()
