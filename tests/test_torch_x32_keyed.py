"""The port's keyed route and keyed gang in x32 against the JAX package's.

Under ``set_precision("x32")`` the keyed route ships int32 key codes (the
port's zigzag identity codes must fit 32 bits; f32 keys as their bits;
f64 keys through the host dictionary, as the reference's
``device_key_encoder``), keeps its buffers in f32/int32 with double-float
sums and order-pair f64 extrema, and finishes into an x32 state.  Keys
past those codes leave the route at the first batch (the basic route
takes the stage) or, later in the stream, re-run the partition on the
CPU operators, as the reference's do.

Each case runs three ways (``test_torch_x32_routes.x32_three``): floats
within rel 1e-6, integers and f64 extrema exact, both device stages
routed alike.  Cases: the x32 parameters of ``tests/test_keyed_agg.py``
and ``tests/test_device_key_encode.py``, and the port's own keyed cases
(``test_torch_keyed.KEYED_CASES``) in x32.
"""

import numpy as np
import pyarrow as pa
import pytest
from test_torch_keyed import KEYED_CASES, _highcard_table
from test_torch_x32_routes import x32_three, x32_both  # noqa: F401 - the fixture

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
from arrow_ballista_tpu.ops.bridge import device_key_encoder as jax_encoder
from arrow_ballista_tpu_torch.ops import bridge as TB

DEVICE = {"ballista.tpu.highcard_mode": "device"}


def _keyed(pm, jm, fallback=0):
    for m in (pm, jm):
        assert m.get("keyed_path", 0) >= 1, m
        assert m.get("tpu_fallback", 0) == fallback, m
        assert m.get("highcard_fallback", 0) == 0, m


@pytest.mark.parametrize("case", sorted(KEYED_CASES))
def test_keyed_stage_x32_matches_jax_and_cpu(case):
    """The port's keyed cases (the x32 parameters of
    tests/test_keyed_agg.py among them) in x32."""
    sql, kw = KEYED_CASES[case]
    pm, jm, _ = x32_three(sql, {"t": _highcard_table(n=6000)},
                          **{"parts": 1, **kw}, **DEVICE)
    _keyed(pm, jm)


def test_keyed_with_device_join_x32():
    """Twin of test_keyed_with_device_join[x32]: the fold kept on the keyed
    route, int32 probe and build keys, f32 build columns."""
    rng = np.random.default_rng(11)
    m_dim, n = 600, 5000
    dim = pa.table({"dk": pa.array(np.arange(1, m_dim + 1).astype(np.int64)),
                    "dv": pa.array(rng.uniform(0.5, 1.5, m_dim)),
                    "dtag": pa.array(rng.integers(0, 3, m_dim).astype(np.int64))})
    fact = pa.table({"fk": pa.array(rng.integers(1, int(m_dim * 1.2), n).astype(np.int64)),
                     "v": pa.array(rng.uniform(0, 100, n))})
    sql = ("select fk, sum(v * dv) as s, count(*) as c "
           "from dim, fact where dk = fk and dtag < 2 group by fk")
    pm, jm, _ = x32_three(sql, {"dim": dim, "fact": fact}, **DEVICE)
    _keyed(pm, jm)
    assert pm.get("join_fallback", 0) == 0, pm


def test_keyed_x32_key_overflow_falls_back_correct():
    """Twin of test_keyed_x32_key_overflow_falls_back_correct: keys past
    int32 never take the keyed route in x32; the stage answers exactly."""
    rng = np.random.default_rng(9)
    n = 2000
    t = pa.table({"k": pa.array((rng.integers(0, 500, n) + (1 << 40)).astype(np.int64)),
                  "v": pa.array(np.ones(n))})
    pm, jm, _ = x32_three("select k, sum(v) as s, count(*) as c from t group by k",
                          {"t": t}, **DEVICE)
    assert not pm.get("keyed_path", 0) and not pm.get("device_encode_batches", 0), pm


def test_keyed_x32_late_key_past_int32_reruns_on_the_cpu():
    """A key past int32 after the first batch: the keyed stream cannot code
    it, so the partition re-runs on the CPU operators (``tpu_fallback``),
    exactly."""
    n = 3000
    k = np.arange(n, dtype=np.int64) * 3
    k[-5:] = (1 << 40) + np.arange(5)
    t = pa.table({"k": pa.array(k), "v": pa.array(np.linspace(1, 2, n))})
    pm, _jm, got = x32_three("select k, sum(v) as s from t group by k", {"t": t},
                             batches=1000, routes=False, **DEVICE)
    assert pm.get("keyed_path", 0) == 1 and pm.get("tpu_fallback", 0) == 1, pm
    assert got.num_rows == n


def test_keyed_budget_chunks_merge_x32():
    """The keyed buffer past its budget flushes chunks whose x32 states
    (double-float sums, order-pair extrema) merge by key on the host."""
    rng = np.random.default_rng(23)
    n = 40_000
    t = pa.table({"k": pa.array(rng.integers(0, 4000, n).astype(np.int64)),
                  "v": pa.array(rng.uniform(0, 100, n)),
                  "w": pa.array(rng.integers(-(2**40), 2**40, n).astype(np.int64))})
    pm, jm, _ = x32_three(
        "select k, sum(v) as s, count(*) as c, min(v) as mn, max(v) as mx, avg(w) as a "
        "from t group by k", {"t": t}, batches=5000, budget=100_000,
        exact=("mn", "mx"), **DEVICE)
    _keyed(pm, jm)
    assert pm.get("keyed_chunks", 0) >= 2, pm


# ------------------------------------------ tests/test_device_key_encode.py
@pytest.mark.parametrize("t", [pa.int64(), pa.int32(), pa.date32(), pa.bool_(),
                               pa.float32(), pa.float64(), pa.string()])
def test_device_key_encoder_x32_kinds_match_reference(t):
    """x32's kinds: integers, dates and bools ident/bool, f32 its bits, and
    f64 (whose 64-bit pattern cannot ship) the host dictionary."""
    _enc, kind = TB.device_key_encoder(t, "x32")
    _jenc, jkind = jax_encoder(t, "x32")
    assert kind == jkind


def test_e2e_float_and_bool_keys_device_encoded_x32():
    """Twin of test_e2e_float_and_bool_keys_device_encoded[x32]: f32 keys
    (-0.0 beside +0.0, nulls) and bools coded on the device in x32."""
    rng = np.random.default_rng(3)
    n = 4000
    f = rng.integers(0, 400, n).astype(np.float64) / 4.0
    f[: n // 16] = -0.0
    t = pa.table({"fk": pa.array(f.astype(np.float32), pa.float32(),
                                 mask=rng.uniform(size=n) < 0.05),
                  "b": pa.array(rng.uniform(size=n) > 0.5, pa.bool_()),
                  "v": pa.array(rng.uniform(0, 100, n))})
    pm, jm, _ = x32_three("select fk, b, sum(v) as s, count(*) as c from t group by fk, b",
                          {"t": t}, **DEVICE)
    _keyed(pm, jm)
    assert pm.get("device_encode_batches", 0) >= 1 and pm.get("key_encode_time_ns", 0) == 0


def test_e2e_f64_key_goes_to_the_host_dictionary_x32():
    rng = np.random.default_rng(4)
    n = 3000
    t = pa.table({"d": pa.array(rng.integers(0, 900, n) * 0.25),
                  "v": pa.array(rng.uniform(0, 10, n))})
    pm, jm, _ = x32_three("select d, sum(v) as s from t group by d", {"t": t}, **DEVICE)
    _keyed(pm, jm)
    assert not pm.get("device_encode_batches", 0) and pm.get("key_encode_time_ns", 0) > 0


def test_e2e_x32_key_overflow_falls_back_exact():
    """Twin of test_e2e_x32_key_overflow_falls_back_exact: the first
    batch's precheck refuses keys past int32 before any device encode."""
    rng = np.random.default_rng(13)
    n = 2000
    t = pa.table({"k": pa.array((rng.integers(0, 400, n) + (1 << 40)).astype(np.int64)),
                  "v": pa.array(np.ones(n))})
    pm, _jm, _ = x32_three("select k, sum(v) as s from t group by k", {"t": t}, **DEVICE)
    assert not pm.get("keyed_path", 0) and not pm.get("device_encode_batches", 0), pm


def test_negative_keys_stay_on_the_keyed_route_x32():
    """The port's standing divergence, in x32 too: its zigzag codes of
    negative keys fit 32 bits, so the port stays keyed where the
    reference (value + 1 codes) leaves the route; both answer exactly."""
    rng = np.random.default_rng(9)
    n = 3000
    t = pa.table({"k": pa.array((rng.integers(0, 500, n) - 250).astype(np.int64)),
                  "v": pa.array(rng.uniform(0, 10, n))})
    pm, jm, _ = x32_three("select k, sum(v) as s, count(*) as c from t group by k",
                          {"t": t}, routes=False, **DEVICE)
    assert pm.get("keyed_path", 0) >= 1 and pm.get("tpu_fallback", 0) == 0, pm
    assert not jm.get("keyed_path", 0), jm


# ------------------------------------------------------------ keyed gang
def _gang_run(mod, tbl, sql, extra, partitions=4):
    cfg = {"ballista.tpu.min_rows": "0", "ballista.shuffle.partitions": "2", **extra}
    ctx = (mod.SessionContext(mod.BallistaConfig(cfg), device="cpu") if mod is tbt
           else mod.SessionContext(mod.BallistaConfig(cfg)))
    ctx.register_arrow_table("t", tbl, partitions=partitions)
    plan = ctx.sql(sql).physical_plan()
    got = ctx.execute(plan)
    gangs, stack = [], [plan]
    while stack:
        nd = stack.pop()
        if type(nd).__name__ == "MeshGangExec":
            gangs.append(nd)
        stack.extend(nd.children())
    return got, gangs


@pytest.mark.parametrize("big_keys", [False, True])
def test_keyed_gang_x32_matches_reference(monkeypatch, big_keys):
    """The keyed gang in x32 on an 8-shard CPU mesh: each shard's keyed
    route with int32 codes, the shards' x32 states merged by key on the
    host (mesh_keyed); keys past 32-bit codes are the gang's data exit
    (mesh_fallback, the reference's "gang keys exceed i32"), answered by
    the sequential stages exactly."""
    from arrow_ballista_tpu_torch.parallel import mesh as TM

    monkeypatch.setattr(TM, "CPU_DEVICES", 8)
    rng = np.random.default_rng(31)
    n = 1 << 14
    g = (np.arange(n) % (n // 8)).astype(np.int64) + ((1 << 40) if big_keys else 0)
    tbl = pa.table({"g": pa.array(g), "v": pa.array(rng.uniform(0, 100, n)),
                    "w": pa.array(rng.integers(0, 1000, n).astype(np.int64))})
    sql = "select g, sum(v) as s, count(*) as c, min(w) as mn, max(w) as mx from t group by g"
    extra = {"ballista.tpu.max_capacity": str(1 << 17), **DEVICE}
    want, _ = _gang_run(jbt, tbl, sql, {"ballista.tpu.enable": "false",
                                        "ballista.mesh.enable": "false"})
    got, gangs = _gang_run(tbt, tbl, sql, extra)
    jgot, jgangs = _gang_run(jbt, tbl, sql, extra)
    key = [("g", "ascending")]
    for out in (got, jgot):
        assert out.sort_by(key).column("c").to_pylist() == want.sort_by(key).column(
            "c").to_pylist()
        assert out.sort_by(key).column("s").to_pylist() == pytest.approx(
            want.sort_by(key).column("s").to_pylist(), rel=1e-6)
    assert gangs and jgangs
    m = gangs[0].metrics.to_dict()
    jm = jgangs[0].metrics.to_dict()
    if big_keys:
        assert m.get("mesh_fallback", 0) >= 1 and not m.get("mesh_keyed", 0), m
        assert jm.get("mesh_fallback", 0) >= 1, jm
    else:
        assert m.get("mesh_keyed", 0) >= 1 and not m.get("mesh_fallback", 0), m
        assert jm.get("mesh_keyed", 0) >= 1, jm
