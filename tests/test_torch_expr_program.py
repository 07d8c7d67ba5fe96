"""The expression program (kernel B3's plain twin) against the closures it
is compiled from and against the JAX package's ``JaxExprCompiler``.

The port compiles a stage's filter and aggregate arguments into one
register program (``ops/kernels.py:ExprProgram``); on the CPU
``expr_program_reference`` runs it, on the card ``ops/cuda/expr_eval.cu``
(``tests/test_torch_cuda_kernels.py`` holds the kernel to the twin).
Tolerances: the twin equals the closures bit for bit (NaN payloads, -0.0,
validity); against the reference floats agree within rel 1e-9 (NaN with
NaN; a subnormal result is compared as the zero XLA on the CPU flushes it
to), everything else exactly.
"""

import ast
import copy
import datetime
import inspect
import textwrap

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import arrow_ballista_tpu as jbt
import arrow_ballista_tpu_torch as tbt
import chip_smoke as SMOKE
from arrow_ballista_tpu.exec import expressions as jpe
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu_torch.exec import expressions as tpe
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec
from benchmarks.tpch.datagen import gen_table
from benchmarks.tpch.queries import QUERIES

REL = 1e-9
CPU = torch.device("cpu")
GRID_ROWS = 4096


@pytest.fixture(autouse=True)
def _jax_x64():
    """Pin the JAX reference to its x64 configuration."""
    old = JK._PRECISION["mode"]
    JK.set_precision("x64")
    try:
        yield
    finally:
        JK._PRECISION["mode"] = old


@pytest.fixture(scope="module")
def grid():
    return SMOKE.expr_grid_batch(GRID_ROWS, seed=3)


def _flushed_inputs(batch: pa.RecordBatch) -> pa.RecordBatch:
    """``batch`` with subnormal float inputs as signed zeros: XLA on the
    CPU flushes them, the port keeps them (ROADMAP, standing divergences),
    so the comparison with the reference runs on flushed inputs."""
    cols = []
    for c in batch.columns:
        if pa.types.is_floating(c.type):
            v = c.to_numpy(zero_copy_only=False)
            c = pa.array(_flush(v), c.type, mask=c.is_null().to_numpy(zero_copy_only=False))
        cols.append(c)
    return pa.RecordBatch.from_arrays(cols, names=batch.schema.names)


# ---------------------------------------------------------------- helpers
def _col(pe, schema):
    return lambda name: pe.Col(schema.get_field_index(name), name)


def _program(build, schema):
    """(program, leaves) of ``build``'s expression as one kernel column."""
    return SMOKE.expr_case(TK, tpe, schema, build)


def _twin_and_closures(program, leaves, batch):
    env = SMOKE.expr_env(TK, batch, leaves, CPU)
    n = batch.num_rows
    twin = TK.expr_program_reference(program, env, n, CPU)
    closures = TK.closures_layout(program, env, n, CPU)
    return twin, closures


def _jax_eval(build, batch):
    """The reference's value and validity of ``build`` over ``batch``."""
    comp = JK.JaxExprCompiler(batch.schema)
    closure = comp._lower_or_leaf(build(jpe, _col(jpe, batch.schema)))
    env = {k: jnp.asarray(a)
           for k, a in JK.build_env(batch, comp.leaves, batch.num_rows).items()}
    v, val = closure(env)
    n = batch.num_rows
    v = np.broadcast_to(np.asarray(v), (n,))
    val = np.ones(n, bool) if val is None else np.broadcast_to(np.asarray(val), (n,))
    return v, val


def _flush(x: np.ndarray) -> np.ndarray:
    """Subnormal floats as the signed zeros XLA on the CPU returns."""
    sub = (x != 0) & (np.abs(x) < np.finfo(np.float64).tiny)
    return np.where(sub, np.copysign(0.0, x), x)


def _assert_matches_jax(out, want_v, want_valid, what: str):
    _, _, values, valids = out
    got = values[0].numpy()
    got_valid = np.ones(len(got), bool) if valids[0] is None else valids[0].numpy()
    np.testing.assert_array_equal(got_valid, want_valid, err_msg=f"{what}: validity")
    # rows the reference leaves NULL carry no value to compare
    got, want = got[want_valid], np.asarray(want_v)[want_valid]
    if got.dtype.kind == "f" or want.dtype.kind == "f":
        g, w = _flush(got.astype(np.float64)), _flush(want.astype(np.float64))
        assert np.array_equal(np.isnan(g), np.isnan(w)), f"{what}: NaN rows"
        ok = ~np.isnan(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=REL, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=what)


# ---------------------------------------------------- every opcode (grid)
@pytest.mark.parametrize("name", sorted(SMOKE.expr_grid_cases()))
def test_grid_twin_equals_closures_and_jax(grid, name):
    """The smoke's opcode grid (nulls, NaN, ±0.0, ±inf, subnormals, int64
    past 2^53, INT64_MIN, zero and -1 divisors) at 4096 rows."""
    build = SMOKE.expr_grid_cases()[name]
    program, leaves = _program(build, grid.schema)
    twin, closures = _twin_and_closures(program, leaves, grid)
    assert SMOKE.expr_diff(twin, closures) is None, SMOKE.expr_diff(twin, closures)
    flushed = _flushed_inputs(grid)
    twin, _ = _twin_and_closures(program, leaves, flushed)
    _assert_matches_jax(twin, *_jax_eval(build, flushed), name)


def test_int64_min_divided_by_minus_one_is_int64_min_as_in_xla():
    """INT64_MIN / -1 and % -1 trap in the CPU's division; the lowering
    guards them and gives the reference's wrapped results."""
    batch = pa.RecordBatch.from_pydict({
        "i": pa.array([SMOKE.I64_MIN, SMOKE.I64_MIN, 7, -7, SMOKE.I64_MAX], pa.int64()),
        "j": pa.array([-1, 0, -1, -1, -1], pa.int64()),
    })
    for op in ("/", "%"):
        def build(pe, col, op=op):
            return pe.Binary(col("i"), op, col("j"))
        program, leaves = _program(build, batch.schema)
        twin, closures = _twin_and_closures(program, leaves, batch)
        assert SMOKE.expr_diff(twin, closures) is None
        _assert_matches_jax(twin, *_jax_eval(build, batch), op)
    want = [SMOKE.I64_MIN, 0, -7, 7, -SMOKE.I64_MAX]
    assert TK._trunc_div(torch.tensor([SMOKE.I64_MIN, 0, 7, -7, SMOKE.I64_MAX]),
                         torch.tensor([-1, 0, -1, -1, -1])).tolist() == want


def test_square_and_shared_subtrees(grid):
    """The variance family's square gets its own opcode, and equal
    subtrees (two closures of the same expression) share one register."""
    comp = TK.TorchExprCompiler(grid.schema)
    col = _col(tpe, grid.schema)
    x = comp._lower(col("x"))
    prod = [comp._lower(tpe.Binary(col("x"), "*", col("y"))) for _ in range(2)]
    program = TK.ExprProgram(
        None, [TK.square_closure(x), prod[0], prod[1], TK.square_closure(x)],
        [(0, torch.float64), (1, torch.float64), (2, torch.float64), (3, torch.float64)],
    )
    ops = [TK.EXPR_OPS[r[0]] for r in program.code[: program.n_regs]]
    assert ops.count("square") == 1 and ops.count("mul") == 1 and ops.count("leaf") == 2
    twin, closures = _twin_and_closures(program, comp.leaves, grid)
    assert SMOKE.expr_diff(twin, closures) is None
    assert twin[2][1] is twin[2][2]  # one output tensor for the shared product


def test_leaves_pass_through_without_a_copy(grid):
    """A bare leaf asked for in its own dtype is the env tensor itself, as
    ``_column`` returned it; a program of pass-throughs stores nothing."""
    comp = TK.TorchExprCompiler(grid.schema)
    col = _col(tpe, grid.schema)
    x, b = comp._lower(col("x")), comp._lower(col("b"))
    program = TK.ExprProgram(b, [x], [(0, torch.float64)])
    assert program.stores == []
    env = SMOKE.expr_env(TK, grid, comp.leaves, CPU)
    pred, pvalid, values, valids = TK.expr_eval(program, env, grid.num_rows, CPU)
    assert pred is env["col_4"] and pvalid is env["col_4__valid"]
    assert values[0] is env["col_2"] and valids[0] is env["col_2__valid"]


def test_operations_torch_refuses_raise_when_the_program_is_built(grid):
    """bool - bool raises in the closures when they run; the program
    raises the same error when it is built, before any batch."""
    comp = TK.TorchExprCompiler(grid.schema)
    col = _col(tpe, grid.schema)
    sub = comp._lower(tpe.Binary(col("b"), "-", col("b")))
    env = SMOKE.expr_env(TK, grid, comp.leaves, CPU)
    env[TK.DEVICE] = CPU
    with pytest.raises(RuntimeError, match="Subtraction"):
        sub(env)
    with pytest.raises(RuntimeError, match="Subtraction"):
        TK.ExprProgram(None, [sub], [(0, torch.int64)])


# ------------------------------------------------ the queries' own programs
def _star(n: int = 20_000, m: int = 500) -> dict:
    rng = np.random.default_rng(9)
    dim = pa.table({"dk": pa.array(np.arange(1, m + 1), pa.int64()),
                    "dv": pa.array(rng.uniform(0.5, 1.5, m))})
    fact = pa.table({"fk": pa.array(rng.integers(1, int(m * 1.2), n), pa.int64()),
                     "g": pa.array(rng.integers(0, 8, n), pa.int32()),
                     "v": pa.array(rng.uniform(0, 100, n))})
    return {"dim": dim, "fact": fact}


STAR_SQL = ("select g, sum(v * dv) as s, count(*) as c "
            "from dim, fact where dk = fk group by g order by g")
_TPCH = {}


def _tables(name: str) -> dict:
    if name not in _TPCH:
        if name == "star":
            _TPCH[name] = _star()
        else:
            _TPCH[name] = {t: gen_table(t, 0.01)
                           for t in ("lineitem", "orders", "customer")}
    return _TPCH[name]


def _stage(ctx_tables: dict, sql: str, package, **extra):
    """The device stages of ``sql`` planned by ``package``'s session."""
    cfg = {"ballista.tpu.min_rows": "0", "ballista.shuffle.partitions": "1", **extra}
    if package is tbt:
        ctx = tbt.SessionContext(tbt.BallistaConfig(cfg), device="cpu")
    else:
        ctx = package.SessionContext(package.BallistaConfig(cfg))
    for t, tbl in ctx_tables.items():
        ctx.register_arrow_table(t, tbl)
    plan = ctx.sql(sql).physical_plan()
    out, stack = [], [plan]
    while stack:
        node = stack.pop()
        if type(node).__name__ in ("TorchStageExec", "TpuStageExec"):
            out.append(node)
        stack.extend(node.children())
    return out


def _stage_env(stage, batch, seed: int) -> dict:
    """The stage's leaves over ``batch`` as numpy arrays; a build-side
    (join) leaf, which the probe gathers on the device, gets seeded values
    of its column's type with a tenth null."""
    rng = np.random.default_rng(seed)
    env = TK.build_env(batch, stage.leaves, batch.num_rows)
    n = batch.num_rows
    for name, spec in stage.leaves.items():
        if spec.kind == "join_col":
            f = stage.fused.join.build.schema.field(
                stage.fused.join.build_cols[spec.col_index - stage._probe_ncols])
            env[name] = (rng.uniform(0.5, 1.5, n) if pa.types.is_floating(f.type)
                         else rng.integers(-(10**6), 10**6, n))
            env[f"{name}__valid"] = rng.random(n) >= 0.1
    return env


QUERY_CASES = {
    "q1": ("tpch", QUERIES[1], "lineitem"),
    "q6": ("tpch", QUERIES[6], "lineitem"),
    "q3": ("tpch", QUERIES[3], "lineitem"),
    "star": ("star", STAR_SQL, "fact"),
}


@pytest.mark.parametrize("name", sorted(QUERY_CASES))
def test_query_programs_match_closures_and_jax(name):
    """q1's, q6's, q3's and the star join's filter and arguments: the twin
    equals the stage's closures bit for bit and the reference's closures
    (``TpuStageExec``, compiled by ``JaxExprCompiler`` over the same plan)
    on the same inputs."""
    kind, sql, probe = QUERY_CASES[name]
    tables = _tables(kind)
    (tst,) = [s for s in _stage(tables, sql, tbt) if s.fused.source is not None][:1]
    (jst,) = [s for s in _stage(tables, sql, jbt) if s.fused.source is not None][:1]
    batch = tables[probe].slice(0, 3000).combine_chunks().to_batches()[0]
    env_np = _stage_env(tst, batch, seed=len(name))
    n = batch.num_rows
    closures, columns, _, _ = TK._agg_layout(tst.specs, tst._arg_closures)
    program = TK.ExprProgram(tst._filter_closure, closures, columns)
    assert program.stores, f"{name} computes its filter or an argument"
    env = {k: torch.from_numpy(np.array(v)) for k, v in env_np.items()}
    twin = TK.expr_eval(program, env, n, CPU)
    assert SMOKE.expr_diff(twin, TK.closures_layout(program, env, n, CPU)) is None
    # the reference's closures over the same arrays
    jenv = {k: jnp.asarray(v) for k, v in env_np.items()}
    pairs = [(tst._filter_closure, jst._filter_closure, twin[0], twin[1])]
    pairs += [(tc, jc, None, None) for tc, jc in zip(tst._arg_closures, jst._arg_closures)]
    for k, (tc, jc, got_v, got_valid) in enumerate(pairs):
        if tc is None:
            continue
        jv, jval = jc(jenv)
        if got_v is None:  # an argument: its kernel column in the twin
            j = closures.index(tc)
            col = next(c for c, (idx, dt) in enumerate(columns) if idx == j)
            got_v, got_valid = twin[2][col], twin[3][col]
            if got_v is None:  # count(col): validity only
                got_v = torch.zeros(n, dtype=torch.bool)
                jv = np.zeros(n, bool)
        want_valid = np.ones(n, bool) if jval is None else np.broadcast_to(np.asarray(jval), (n,))
        out = (None, None, [got_v], [got_valid])
        _assert_matches_jax(out, np.broadcast_to(np.asarray(jv), (n,)), want_valid,
                            f"{name} closure {k}")


# ------------------------------------------------------------- property
_COLS5 = ("a", "b", "x", "y", "p")


def _five_columns() -> pa.RecordBatch:
    rng = np.random.default_rng(11)
    n = 257
    a = rng.choice(np.array([0, 1, -1, 7, -7, 2**40, -(2**53) - 1, SMOKE.I64_MAX, 3, 100]), n)
    b = rng.choice(np.array([0, -1, 1, 2, -3, 5, 2**31]), n)
    x = rng.choice(np.array([0.0, -0.0, 0.5, -2.5, 1.5, 3.25, -7.0, 1e6, float("nan"),
                             float("inf")]), n)
    y = rng.choice(np.array([0.0, 2.0, -0.5, 10.0, -1.0, float("nan"), 0.25]), n)

    def nulls():
        return rng.random(n) < 0.15

    return pa.RecordBatch.from_pydict({
        "a": pa.array(a, pa.int64(), mask=nulls()),
        "b": pa.array(b, pa.int64(), mask=nulls()),
        "x": pa.array(x, pa.float64(), mask=nulls()),
        "y": pa.array(y, pa.float64(), mask=nulls()),
        "p": pa.array(rng.random(n) < 0.5, pa.bool_(), mask=nulls()),
    })


_BATCH5 = _five_columns()
# correctly rounded (or exact) operations only: the reference's
# transcendentals may differ from torch's by an ulp, which later
# arithmetic can amplify past 1e-9; the grid holds each of them alone
_BIN_OPS = ("+", "-", "*", "/", "%", "=", "<>", "<", "<=", ">", ">=", "AND", "OR")
_FNS = ("abs", "sqrt", "ceil", "floor", "round", "signum")

_leaf = st.one_of(
    st.sampled_from(_COLS5),
    st.sampled_from([0, 1, -2, 3, 0.5, -1.5, True, False]).map(lambda v: ("lit", v)),
)


def _extend(children):
    return st.one_of(
        st.tuples(st.just("bin"), st.sampled_from(_BIN_OPS), children, children),
        st.tuples(st.just("not"), children),
        st.tuples(st.just("neg"), children),
        st.tuples(st.just("isnull"), children, st.booleans()),
        st.tuples(st.just("fn"), st.sampled_from(_FNS), children),
        st.tuples(st.just("cast"), st.sampled_from(["int64", "float64", "bool"]), children),
        st.tuples(st.just("case"), children, children, st.one_of(st.none(), children)),
        # over a column: both packages' IN closures index a row axis
        st.tuples(st.just("in"), st.sampled_from(_COLS5),
                  st.sampled_from([(0, 1, 7), (0.5, -1.5), (2, 2.0)]), st.booleans()),
    )


_TREES = st.recursive(_leaf, _extend, max_leaves=6)
_PA = {"int64": pa.int64(), "float64": pa.float64(), "bool": pa.bool_()}


def _build(tree):
    """The tree as ``build(pe, col)`` for either package's expressions."""
    def go(pe, col, t):
        if isinstance(t, str):
            return col(t)
        kind = t[0]
        if kind == "lit":
            return pe.Lit(t[1])
        if kind == "bin":
            return pe.Binary(go(pe, col, t[2]), t[1], go(pe, col, t[3]))
        if kind == "not":
            return pe.Not(go(pe, col, t[1]))
        if kind == "neg":
            return pe.Negative(go(pe, col, t[1]))
        if kind == "isnull":
            return pe.IsNull(go(pe, col, t[1]), t[2])
        if kind == "fn":
            return pe.ScalarFn(t[1], (go(pe, col, t[2]),))
        if kind == "cast":
            return pe.Cast(go(pe, col, t[2]), _PA[t[1]])
        if kind == "in":
            return pe.InList(go(pe, col, t[1]), t[2], t[3])
        whens = ((go(pe, col, t[1]), go(pe, col, t[2])),)
        other = None if t[3] is None else go(pe, col, t[3])
        return pe.Case(whens, other, pa.float64())

    return lambda pe, col: go(pe, col, tree)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(_TREES)
def test_random_trees_twin_equals_closures_and_jax(tree):
    """Random expression trees over five columns with nulls: the program
    twin equals the closures bit for bit, and the reference within the
    tolerance; where torch refuses an operation both raise."""
    build = _build(tree)
    comp = TK.TorchExprCompiler(_BATCH5.schema)
    closure = comp._lower_or_leaf(build(tpe, _col(tpe, _BATCH5.schema)))
    env = SMOKE.expr_env(TK, _BATCH5, comp.leaves, CPU)
    n = _BATCH5.num_rows
    node = closure.node
    if node.op == "error":
        with pytest.raises(RuntimeError):
            TK.ExprProgram(None, [closure], [(0, torch.int64)])
        with pytest.raises(RuntimeError):
            closure({**env, TK.DEVICE: CPU})
        return
    program = TK.ExprProgram(None, [closure], [(0, node.dtype)])
    twin = TK.expr_program_reference(program, env, n, CPU)
    assert SMOKE.expr_diff(twin, TK.closures_layout(program, env, n, CPU)) is None
    if not _bool_arithmetic(node):
        _assert_matches_jax(twin, *_jax_eval(build, _BATCH5), str(tree))


def _bool_arithmetic(node) -> bool:
    """Whether the tree does arithmetic on a boolean, where the two
    packages part (ROADMAP, standing divergences): ``%`` of a boolean
    divides in f64 in the port's closures (x % false is NaN) and in
    integers in the reference (0), and XLA rewrites ``x * b`` as a select
    (inf * false is 0, not NaN)."""
    arith = ("add", "mul", "div_f", "mod_f", "mod_int", "power")
    if node.op in arith and any(a.dtype == torch.bool for a in node.args):
        return True
    return any(_bool_arithmetic(a) for a in node.args)


# ------------------------------------------------------------- coverage
def _lower_tokens() -> set:
    """Every node class ``TorchExprCompiler._lower`` tests for and every
    operator or function name it maps (the keys of its tables and the
    strings it compares against)."""
    src = textwrap.dedent(inspect.getsource(TK.TorchExprCompiler._lower))
    tokens = set()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "isinstance"
                and isinstance(node.args[1], ast.Attribute)):
            tokens.add(node.args[1].attr)
        elif isinstance(node, ast.Dict):
            tokens.update(k.value for k in node.keys if isinstance(k, ast.Constant))
        elif isinstance(node, ast.Compare):
            for c in [node.left, *node.comparators]:
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    tokens.add(c.value)
                elif isinstance(c, ast.Tuple):
                    tokens.update(e.value for e in c.elts if isinstance(e, ast.Constant))
    return tokens


def _b(op):
    return lambda pe, col: pe.Binary(col("x"), op, col("y"))


# one expression per token of _lower: a branch without an entry fails
LOWER_EXAMPLES = {
    "Col": lambda pe, col: pe.Binary(col("i"), "+", col("k")),
    "Lit": lambda pe, col: pe.Binary(pe.Lit(2.5), "*", pe.Lit(datetime.date(2000, 1, 1))),
    "Binary": _b("+"), "AND": SMOKE.expr_grid_cases()["and"],
    "OR": SMOKE.expr_grid_cases()["or"], "=": _b("="), "<>": _b("<>"), "<": _b("<"),
    "<=": _b("<="), ">": _b(">"), ">=": _b(">="), "+": _b("+"), "-": _b("-"),
    "*": _b("*"), "/": _b("/"), "%": _b("%"),
    "Not": SMOKE.expr_grid_cases()["not"], "Negative": SMOKE.expr_grid_cases()["neg_int"],
    "IsNull": SMOKE.expr_grid_cases()["is_null"], "InList": SMOKE.expr_grid_cases()["in_int"],
    "Case": SMOKE.expr_grid_cases()["case_nested"],
    "Cast": SMOKE.expr_grid_cases()["cast_float_int"],
    "ScalarFn": SMOKE.expr_grid_cases()["fn_exp"],
    "power": SMOKE.expr_grid_cases()["power"], "round": SMOKE.expr_grid_cases()["round"],
    **{fn: (lambda fn: lambda pe, col: pe.ScalarFn(fn, (col("y"),)))(fn)
       for fn in ("abs", "sqrt", "exp", "ln", "log10", "log2", "ceil", "floor",
                  "sin", "cos", "tan", "signum")},
}


def test_every_lowering_branch_has_an_opcode(grid):
    """Each branch of ``_lower`` has an example here; each example lowers
    to a program of known opcodes whose twin equals its closures."""
    missing = _lower_tokens() - set(LOWER_EXAMPLES)
    assert not missing, f"_lower branches with no opcode example: {sorted(missing)}"
    seen = set()
    for token, build in LOWER_EXAMPLES.items():
        program, leaves = _program(build, grid.schema)
        seen.update(TK.EXPR_OPS[r[0]] for r in program.code)
        twin, closures = _twin_and_closures(program, leaves, grid)
        assert SMOKE.expr_diff(twin, closures) is None, token
    grid_ops = set()
    for build in SMOKE.expr_grid_cases().values():
        program, _ = _program(build, grid.schema)
        grid_ops.update(TK.EXPR_OPS[r[0]] for r in program.code)
    # every opcode but the square and x32's square-pair error word (a
    # stage's, not _lower's) is on the grid
    assert set(TK.EXPR_OPS) - grid_ops == {"square", "sqpair_lo"}, (
        set(TK.EXPR_OPS) - grid_ops)


# ----------------------------------------------------------- validation
def _parts(program):
    return dict(code=program.code.copy(), consts=program.consts.copy(),
                inputs=list(program.inputs), n_regs=program.n_regs,
                stores=list(program.stores), outputs=copy.deepcopy(program.outputs))


def _sample_program(grid):
    build = SMOKE.expr_grid_cases()["in_int"]
    comp = TK.TorchExprCompiler(grid.schema)
    col = _col(tpe, grid.schema)
    inside = comp._lower(build(tpe, col))
    charge = comp._lower(SMOKE.expr_grid_cases()["case_else"](tpe, col))
    return TK.ExprProgram(inside, [charge], [(0, torch.float64)]), comp


def _corrupt(parts, what: str) -> dict:
    code = parts["code"]
    n_regs = parts["n_regs"]
    rows = [i for i in range(n_regs)]
    find = {name: next(i for i in rows if TK.EXPR_OPS[code[i, 0]] == name)
            for name in ("leaf", "in", "select", "lit")}
    if what == "opcode":
        code[1, 0] = len(TK.EXPR_OPS) + 3
    elif what == "forward register":
        code[find["select"], 5] = find["select"]
    elif what == "table past the constants":
        code[find["in"], 5] = len(parts["consts"]) + 1
    elif what == "input slot":
        code[find["leaf"], 4] = len(parts["inputs"])
    elif what == "store out of place":
        parts["n_regs"] = n_regs + 1
    elif what == "store slot":
        code[n_regs, 4] = len(parts["stores"])
    elif what == "result dtype":
        code[find["in"], 1] = TK.DT_F64
    elif what == "bool subtraction":
        code[find["select"], 0] = TK.EXPR_OPS.index("sub")
        code[find["select"], 1] = code[find["select"], 2] = TK.DT_BOOL
    elif what == "select dtype":
        code[find["select"], 1] = TK.DT_I64
    elif what == "output register":
        parts["outputs"][2] = ("value", n_regs + 5, TK.DT_F64, -1)
    elif what == "pass-through of a computed register":
        out = parts["outputs"][0]
        parts["outputs"][0] = out[:3] + (-1,)
    return parts


_CORRUPTIONS = ("opcode", "forward register", "table past the constants", "input slot",
                "store out of place", "store slot", "result dtype", "bool subtraction",
                "select dtype", "output register", "pass-through of a computed register")


@pytest.mark.parametrize("what", _CORRUPTIONS)
def test_malformed_program_raises_before_any_launch(grid, what):
    program, comp = _sample_program(grid)
    TK.ExprProgram.from_parts(**_parts(program))  # the intact tables pass
    with pytest.raises(ValueError, match="expr program"):
        TK.ExprProgram.from_parts(**_corrupt(_parts(program), what))
    # a program whose tables were swapped after it was built is caught by
    # the evaluation itself, on either device, before the twin or a launch
    broken = copy.copy(program)
    broken.__dict__.update(_corrupt(_parts(program), what))
    env = SMOKE.expr_env(TK, grid, comp.leaves, CPU)
    before = dict(TK.LAUNCHES)
    with pytest.raises(ValueError, match="expr program"):
        TK.expr_eval(broken, env, grid.num_rows, CPU)
    with pytest.raises(ValueError, match="expr program"):
        TK.expr_eval_cuda(broken, env, grid.num_rows, torch.device("cuda"))
    assert TK.LAUNCHES == before


def test_kernel_inputs_checked_before_the_binding(grid):
    """The CUDA wrapper refuses a CPU device, a program too large for the
    kernel and inputs of the wrong dtype, all with ValueError, without a
    card and before the extension is loaded."""
    program, comp = _sample_program(grid)
    env = SMOKE.expr_env(TK, grid, comp.leaves, CPU)
    n = grid.num_rows
    with pytest.raises(ValueError, match="not CUDA"):
        TK.expr_eval_cuda(program, env, n, CPU)
    inputs = [env[name] for name in program.inputs]
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match="must be contiguous"):  # CPU tensors
        TK._check_expr_args(program, inputs, n, cuda)
    big = copy.copy(program)
    big.n_regs = TK.EXPR_SMEM_LIMIT // (32 * 9) + 1
    with pytest.raises(ValueError, match="exceed the kernel"):
        TK._check_expr_args(big, inputs, n, cuda)


def test_program_words_match_the_instruction_layout(grid):
    """The device copy's rows are expr_eval.h's 32-byte ExprInstr (six
    int32 fields, the operand registers' dtypes packed above the opcode,
    then the int64 immediate), the IN tables after them."""
    program, _ = _sample_program(grid)
    words = program.device_words(CPU).numpy()
    n = len(program.code)
    rows = words[: 4 * n].view(np.int32).reshape(n, 8)
    np.testing.assert_array_equal(rows[:, 1:6], program.code[:, 1:6])
    np.testing.assert_array_equal(rows[:, 0] & 0xFF, program.code[:, 0])
    for i, (op, *_rest) in enumerate(program.code.tolist()):
        regs = program.code[i, 3:6][: TK._ARITY[TK.EXPR_OPS[op]]]
        packed = [(int(rows[i, 0]) >> (8 * (j + 1))) & 0xFF for j in range(3)]
        assert packed[: len(regs)] == [int(program.code[r, 1]) for r in regs]
        assert not any(packed[len(regs):])
    np.testing.assert_array_equal(words[: 4 * n].reshape(n, 4)[:, 3], program.code[:, 6])
    np.testing.assert_array_equal(words[4 * n:], program.consts)
    assert program.device_words(CPU) is program.device_words(CPU)  # copied once


# ------------------------------------------------------------ the stages
# (tables, sql, settings, the stage metric names of each route, which
# the expression program leaves as they were: it adds none)
_METRICS = {
    "base": ["bridge_time_ns", "device_time_ns", "input_rows", "output_rows",
             "tpu_execute_ns", "tpu_stage_time_ns"],
}
# the TPC-H cases pin the stage's own routes: with the mesh on (the
# default) their two partitions would run as one gang
_NO_MESH = {"ballista.mesh.enable": "false"}
STAGE_CASES = {
    "q1_cache_off": ("tpch", QUERIES[1],
                     {"ballista.tpu.cache_columns": "false", **_NO_MESH},
                     _METRICS["base"] + ["key_encode_time_ns"]),
    "q1_fused": ("tpch", QUERIES[1], _NO_MESH,
                 _METRICS["base"] + ["fused_dispatches", "key_encode_time_ns"]),
    "q6_fused": ("tpch", QUERIES[6], _NO_MESH,
                 _METRICS["base"] + ["fused_dispatches"]),
    "star_join": ("star", STAR_SQL, {"ballista.shuffle.partitions": "1"},
                  _METRICS["base"] + ["dense_join", "join_build_time_ns",
                                      "key_encode_time_ns"]),
    "keyed": ("keyed", "select k, median(v) as md, stddev(v) as sd, sum(v * 2) as s "
              "from t where v > 0.1 group by k order by k",
              {"ballista.shuffle.partitions": "1"},
              ["bridge_time_ns", "device_encode_batches", "device_time_ns",
               "fused_keyed_dispatches", "input_rows", "keyed_path", "output_rows",
               "tpu_stage_time_ns"]),
}


def _stage_tables(kind: str) -> dict:
    if kind == "keyed":
        rng = np.random.default_rng(5)
        return {"t": pa.table({"k": pa.array(rng.integers(0, 3000, 6000)),
                               "v": pa.array(rng.uniform(0, 1, 6000),
                                             mask=rng.random(6000) < 0.1)})}
    return {"lineitem": _tables("tpch")["lineitem"]} if kind == "tpch" else _tables(kind)


@pytest.mark.parametrize("name", sorted(STAGE_CASES))
def test_stage_runs_the_program_twin_on_the_cpu(monkeypatch, name):
    """q1 (cache off and fused), q6, a folded join and a keyed query on
    ``device="cpu"``: every batch or entry goes through
    ``expr_program_reference``, the answers equal the CPU operators', and
    the routes report their metric names, none added."""
    kind, sql, extra, metric_names = STAGE_CASES[name]
    calls = []
    inner = TK.expr_program_reference

    def counted(program, env, n, device):
        calls.append(n)
        return inner(program, env, n, device)

    monkeypatch.setattr(TK, "expr_program_reference", counted)
    out = []
    stages = []
    for enable in ("false", "true"):
        cfg = {"ballista.tpu.enable": enable, "ballista.tpu.min_rows": "0", **extra}
        ctx = tbt.SessionContext(tbt.BallistaConfig(cfg), device="cpu")
        for t, tbl in _stage_tables(kind).items():
            ctx.register_arrow_table(t, tbl, partitions=2 if kind == "tpch" else 1)
        plan = ctx.sql(sql).physical_plan()
        before = len(calls)
        out.append(ctx.execute(plan))
        stack = [plan]
        while stack:
            node = stack.pop()
            if isinstance(node, TorchStageExec):
                stages.append(node)
            stack.extend(node.children())
        if enable == "false":
            assert len(calls) == before
    assert len(stages) == 1, [str(s) for s in stages]
    assert calls and sum(calls) >= stages[0].metrics.to_dict()["input_rows"] > 0
    assert sorted(stages[0].metrics.to_dict()) == sorted(metric_names)
    a, b = out
    assert a.schema.names == b.schema.names and a.num_rows == b.num_rows
    for col in a.schema.names:
        for x, y in zip(a.column(col).to_pylist(), b.column(col).to_pylist()):
            if isinstance(x, float) and y is not None:
                assert y == pytest.approx(x, rel=REL), col
            else:
                assert x == y, col
