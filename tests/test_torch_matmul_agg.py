"""The PyTorch port's x32 "matmul" route against the JAX package's, on the
CPU.

Twins of the 5 cases of ``tests/test_matmul_agg.py``: both packages are
forced to x32 and to the matmul route (``set_agg_algorithm("matmul")``),
the port on ``device="cpu"``, where D's matmul form (the double-float
segment sum at 2^14-row blocks, ``ops/cuda/df32_agg.cu`` on the card)
runs its plain twin.  Held to the CPU operators at rel 1e-6, counts and
packed states exact.
"""

import numpy as np
import pytest
import torch

from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu_torch.ops import kernels as TK
from benchmarks.tpch.queries import QUERIES
from test_torch_precision_x32 import assert_close, assert_no_fallback, three, tpch

pytestmark = pytest.mark.usefixtures("x32_both")

from test_torch_precision_x32 import x32_both  # noqa: E402,F401  (the fixture)


@pytest.mark.parametrize("name, sql", [
    ("q1", QUERIES[1]),
    ("q6", QUERIES[6]),
    ("min_max_count_mixed",
     "select l_returnflag, min(l_discount), max(l_tax), count(*), "
     "count(l_quantity), sum(l_extendedprice) from lineitem group by l_returnflag"),
])
def test_matmul_route_matches_oracle(name, sql):
    """Twins of test_q1_matmul_matches_oracle, test_q6_global_agg_matmul and
    test_min_max_count_mixed."""
    want, jgot, got, m = three(sql, {"lineitem": tpch("lineitem")}, algo="matmul")
    assert_close(want, jgot, f"jax {name}")
    assert_close(want, got, f"port {name}")
    assert_no_fallback(m)


def test_blocked_onehot_agg_counts_exact():
    """Count columns EXACT through D's matmul form, and its sums equal to
    ``_blocked_onehot_agg``'s (70,000 rows: past one 2^14 block, padded)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n, cap = 70_000, 8
    seg = rng.integers(0, 5, size=n).astype(np.int32)
    vals = rng.uniform(1, 1e5, size=n).astype(np.float32)
    V = jnp.concatenate([jnp.asarray(vals)[:, None], jnp.ones((n, 1), jnp.float32)], axis=1)
    jhi, jlo, jcnt = JK._blocked_onehot_agg(V, jnp.asarray(seg), cap, 1)
    hi, lo, cnt = TK.df32_agg(torch.from_numpy(seg), None, None, None,
                              [torch.from_numpy(vals)], [None], [(0, -1)], [-1], cap,
                              TK.DF32_BLOCK)
    expect = np.bincount(seg, minlength=cap)
    assert np.array_equal(cnt[0].numpy(), expect)
    assert np.array_equal(np.asarray(jcnt)[:, 0], expect)
    oracle = np.zeros(cap)
    np.add.at(oracle, seg, vals.astype(np.float64))
    got = hi[0].double().numpy() + lo[0].double().numpy()
    nz = oracle > 0
    assert np.abs(got[nz] - oracle[nz]).max() / oracle[nz].max() < 1e-6
    want = np.asarray(jhi)[:, 0].astype(np.float64) + np.asarray(jlo)[:, 0]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_pack_unpack_roundtrip():
    """x32 states (the reference's pack layout: floats as int32 bits) cross
    ``states_from_numpy``/``fetch_states``/``unpack_host`` losslessly, as
    the reference's ``pack_for_fetch``/``unpack_host`` do."""
    jspecs = [JK.KernelAggSpec("sum", True), JK.KernelAggSpec("count_star", False),
              JK.KernelAggSpec("min", True)]
    states = (
        np.asarray([1.5, 2.5, 0.0, -3.25], np.float32),
        np.asarray([1e-9, 0.0, 0.0, 2e-8], np.float32),
        np.asarray([3, 0, 0, 2**30], np.int32),
        np.asarray([7, 0, 1, 2], np.int32),
        np.asarray([0.5, np.inf, -1.0, 9.0], np.float32),
        np.asarray([2, 0, 1, 1], np.int32),
        np.asarray([9, 0, 1, 2**31 - 1], np.int32),
    )
    packed = np.asarray(JK.pack_for_fetch(jspecs, states, "x32"))
    want = JK.unpack_host(jspecs, packed, "x32")
    dicts = [dict(func=s.func, has_arg=s.has_arg, pair=s.pair, int_minmax=s.int_minmax,
                  ord_pair=s.ord_pair) for s in jspecs]
    state = TK.states_from_numpy(dicts, states, "cpu", mode="x32")
    assert state.dtype == torch.int32
    got = TK.unpack_host(TK.specs_from_dicts(dicts), TK.fetch_states(state))
    assert np.array_equal(TK.fetch_states(state), packed)
    assert len(got) == len(states)
    for g, w, s in zip(got, want, states):
        assert g.dtype == s.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)
