"""The port's device join fold in x32 against the JAX package's, in the
reference's own mode for its join suites (``tests/test_device_join.py``
and ``tests/test_dense_join.py`` force x32).

Under ``set_precision("x32")`` the fold keeps its probe keys as int32
(a probe key outside int32 is masked, never a match), its build keys and
build columns go through ``coerce_host_values`` (int32 keys, f32/int32
columns), and a build key or value past them is the data rule
``_JoinIneligible``: the join runs on the CPU and the aggregate on the
device (``join_fallback``), as the reference's.  Each case runs the port
(``device="cpu"``), the JAX device stage in x32 and the CPU operators:
floats within rel 1e-6, everything else exact, both device stages
folded and routed alike (``test_torch_x32_routes.x32_three``).  The x64
runs of the same cases stay in ``tests/test_torch_join.py``.
"""

import numpy as np
import pyarrow as pa
import pytest
from test_torch_join import DENSE_CASES, DEVICE_JOIN_CASES, _dense_tables
from test_torch_x32_routes import tpch, x32_three, x32_both  # noqa: F401

from benchmarks.tpch.queries import QUERIES

# build keys past 2^31 cannot ship in x32: the reference's rule joins on
# the CPU (one fallback per probe partition) where x64 keeps the fold
X32_ROUTES = {"wide_build_keys_stay_on_the_device_join": {"join_fallback": 2}}


@pytest.mark.parametrize("name", sorted(DEVICE_JOIN_CASES))
def test_device_join_case_x32_matches_jax_and_cpu(name):
    make, sql, route = DEVICE_JOIN_CASES[name]
    route = X32_ROUTES.get(name, route)
    pm, _jm, got = x32_three(sql, make(), parts=2, **{"ballista.shuffle.partitions": 2})
    for k, v in route.items():
        if k != "dense_join":
            assert pm.get(k, 0) == v, (k, pm)
    if name == "empty_build_side":
        assert got.num_rows == 0


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_join_case_x32_matches_jax_and_cpu(name):
    keys, lo, hi, dense = DENSE_CASES[name]
    pm, jm, _ = x32_three(
        "select g, sum(v * dv) as s, count(*) as c from dim, fact where pk = fk group by g",
        _dense_tables(keys, lo, hi), **{"ballista.shuffle.partitions": 1})
    assert pm.get("dense_join", 0) == int(dense) == jm.get("dense_join", 0), (pm, jm)
    assert pm.get("join_fallback", 0) == 0 and pm.get("tpu_fallback", 0) == 0, pm


def test_x32_probe_keys_past_int32_are_masked_not_failed():
    """Probe keys outside int32 cannot meet an int32 build key: they drop
    out of the inner join on the device, the fold is kept."""
    rng = np.random.default_rng(3)
    n = 3000
    fk = rng.integers(1, 80, n).astype(np.int64)
    fk[::9] += 1 << 40
    tables = {
        "dim": pa.table({"dk": pa.array(np.arange(1, 70), pa.int64()),
                         "dv": pa.array(rng.uniform(0, 10, 69))}),
        "fact": pa.table({"fk": pa.array(fk), "g": pa.array(rng.integers(0, 5, n)),
                          "v": pa.array(rng.uniform(0, 100, n))}),
    }
    pm, _jm, _ = x32_three("select g, sum(v * dv) as s, count(*) as c from dim, fact "
                           "where dk = fk group by g", tables)
    assert pm.get("join_fallback", 0) == 0 and pm.get("tpu_fallback", 0) == 0, pm


def test_x32_q3_folds_as_the_reference():
    """TPC-H q3 in x32: the fold kept, as the reference's decision."""
    tables = {n: tpch(n) for n in ("lineitem", "orders", "customer")}
    pm, _jm, _ = x32_three(QUERIES[3], tables)
    assert pm.get("join_fallback", 0) == 0 and pm.get("dense_join", 0) >= 1, pm


def test_x32_probe_reads_int32_keys_and_f32_build_columns(monkeypatch):
    """The star shape's probe in x32: int32 probe and build keys, the
    build column as f32, the dense slot table."""
    from arrow_ballista_tpu_torch.ops import kernels as TK
    from test_torch_join import _dims

    seen = []
    probe = TK.join_probe

    def record(pkey, *args, **kw):
        seen.append((pkey.dtype, [v.dtype for v in args[2]], kw))
        return probe(pkey, *args, **kw)

    monkeypatch.setattr(TK, "join_probe", record)
    pm, _jm, _ = x32_three("select g, sum(v * dv) as s, count(*) as c from dim, fact "
                           "where dk = fk group by g", _dims(), routes=False)
    assert pm.get("dense_join", 0) >= 1 and pm.get("join_fallback", 0) == 0, pm
    assert seen and all(p == TK.I32 and cols == [TK.F32] and "table" in kw
                        for p, cols, kw in seen), seen
