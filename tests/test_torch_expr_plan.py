"""The expression kernel's tile rule (``ops/cuda/expr_eval.h:expr_plan``,
mirrored by ``ops/kernels.py:expr_launch_plan``) on the CPU.

Every program the admission rule takes (the code and 9 bytes a register
for 32 threads within a CTA's 232,448 bytes of shared memory, at most
1,024 rows of code, 96 inputs, 72 outputs) must get a plan that fits
those bytes: the smoke's opcode grid in x64 and x32, the TPC-H stage
programs the port builds (x64's q1, q3, q6 and q12, x32's 22 queries),
and synthetic programs up to the admission edge, past 64 registers and at
1,024 rows.  A program the admission rule refuses raises ValueError in
the wrapper's check, before any launch.  No card needed.
"""

import re
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_ballista_tpu_torch as tbt
import chip_smoke as SMOKE
from arrow_ballista_tpu_torch.exec import expressions as tpe
from arrow_ballista_tpu_torch.ops import kernels as TK
from benchmarks.tpch.datagen import gen_table
from benchmarks.tpch.queries import QUERIES

HEADER = Path(TK.__file__).parent / "cuda" / "expr_eval.h"
HUGE = 1 << 40  # rows enough that the small-batch rule never cuts the tile
OP = {name: i for i, name in enumerate(TK.EXPR_OPS)}
_PROGRAMS: dict = {}


def admitted(program, n_inputs: int) -> bool:
    """The admission rule as it stood before the tile rule."""
    n_instr = len(program.code)
    return (n_instr <= TK.EXPR_MAX_INSTR
            and n_instr * 32 + program.n_regs * 32 * 9 <= TK.EXPR_SMEM_LIMIT
            and n_inputs <= TK.EXPR_MAX_INPUTS and len(program.stores) <= TK.EXPR_MAX_OUTPUTS)


def widest(program) -> dict:
    return {s: TK._DT_BYTES[dt] for s, dt, _ in program._reads}


def assert_tiles_disjoint(program):
    """Two registers share a tile only when the first's last reader (a
    row, or a store) is no later than the row that writes the second."""
    rows = program.code.tolist()
    last = {}
    for i, (op, *_rest) in enumerate(rows):
        a, b, c = rows[i][3:6]
        k = TK._ARITY[TK.EXPR_OPS[op]]
        for r in (a, b, c)[:k]:
            last[r] = i
    owner: dict = {}
    for i, w in enumerate(program.reg_layout.tolist()):
        if w & 3 != TK.EXPR_REG_TILE:
            continue
        tile = (w & TK.EXPR_REG_WIDE, w >> 4)
        if tile in owner:
            assert last.get(owner[tile], owner[tile]) <= i, (tile, owner[tile], i)
        owner[tile] = i


def assert_plans_fit(program, widths=None):
    """At every batch size, the plan fits and is one the kernel takes."""
    widths = widest(program) if widths is None else widths
    assert admitted(program, len(program.inputs)) and TK.expr_fits(program, len(program.inputs))
    assert_tiles_disjoint(program)
    for n in (1, 1000, 8192, 1 << 20, 1 << 23, HUGE):
        threads, rows, stages, smem = TK.expr_program_plan(program, n, widths)
        assert smem <= TK.EXPR_SMEM_LIMIT, (n, threads, rows, stages, smem)
        assert threads in (32, 64, 128, 256) and rows in (1, 2, 4, 8) and stages in (1, 2)
        assert smem == TK.expr_smem_bytes(program.n_regs, program.reg_counts,
                                          TK._staged_widths(program, widths),
                                          threads, rows, stages)


def test_the_mirror_holds_the_header_constants():
    text = HEADER.read_text()

    def const(name):
        return int(re.search(rf"{name} = (\d+)", text).group(1))

    assert const("kExprMaxRows") == TK.EXPR_MAX_ROWS
    assert const("kExprPlanSms") == TK.EXPR_PLAN_SMS
    assert const("kExprSmemPerSm") == TK.EXPR_SMEM_PER_SM
    assert const("kExprSmemPerCta") == TK.EXPR_SMEM_PER_CTA
    assert const("kExprRegsPerSm") == TK.EXPR_REGS_PER_SM
    assert const("kExprMaxRegs") == TK.EXPR_MAX_REGS
    assert "kThreads[4] = {%s}" % ", ".join(map(str, TK._EXPR_THREADS)) in text
    assert const("kExprSmemLimit") == TK.EXPR_SMEM_LIMIT
    assert const("kExprMaxInstr") == TK.EXPR_MAX_INSTR
    assert const("kRegInvariant") == TK.EXPR_REG_INVARIANT
    assert const("kRegWide") == TK.EXPR_REG_WIDE
    kinds = re.search(r"enum ExprRegKind : int \{(.*?)\};", text, re.S).group(1)
    assert re.findall(r"(kReg\w+) = (\d)", kinds) == [
        ("kRegTile", str(TK.EXPR_REG_TILE)), ("kRegUniform", str(TK.EXPR_REG_UNIFORM)),
        ("kRegLeaf", str(TK.EXPR_REG_LEAF)), ("kRegMask", str(TK.EXPR_REG_MASK))]


@pytest.mark.parametrize("name", sorted(SMOKE.expr_grid_cases()))
def test_grid_programs_fit_in_both_modes(name):
    for mode in ("x64", "x32"):
        batch = SMOKE.expr_grid_batch(64, mode=mode)
        TK.set_precision(None if mode == "x64" else "x32")
        try:
            program, _ = SMOKE.expr_case(TK, tpe, batch.schema, SMOKE.expr_grid_cases()[name])
        finally:
            TK.set_precision(None)
        assert program.mode == mode
        assert_plans_fit(program)


def _tpch_programs(mode: str) -> list:
    """Every ExprProgram the port builds for TPC-H's queries at SF 0.002
    (x64: test_torch_stage.py's q1, q3, q6, q12; x32: all 22), run on
    the CPU."""
    if mode in _PROGRAMS:
        return _PROGRAMS[mode]
    tables = {n: gen_table(n, 0.002) for n in ("lineitem", "orders", "customer", "part",
                                                "partsupp", "supplier", "nation", "region")}
    queries = (1, 3, 6, 12) if mode == "x64" else sorted(QUERIES)
    seen = []
    init = TK.ExprProgram._init

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        seen.append(self)

    TK.ExprProgram._init = keep
    TK.set_precision(None if mode == "x64" else "x32")
    try:
        for q in queries:
            ctx = tbt.SessionContext(tbt.BallistaConfig({
                "ballista.tpu.enable": "true", "ballista.tpu.min_rows": "0",
                "ballista.mesh.enable": "false"}), device="cpu")
            for name, table in tables.items():
                ctx.register_arrow_table(name, table, partitions=2)
            ctx.sql(QUERIES[q]).collect()
    finally:
        TK.ExprProgram._init = init
        TK.set_precision(None)
    _PROGRAMS[mode] = [p for p in seen if p.n_regs]
    return _PROGRAMS[mode]


@pytest.mark.parametrize("mode", ["x64", "x32"])
def test_tpch_programs_fit(mode):
    programs = _tpch_programs(mode)
    assert len(programs) >= (4 if mode == "x64" else 15)
    assert all(p.mode == mode for p in programs)
    for program in programs:
        assert_plans_fit(program)


@pytest.mark.parametrize("mode", ["x64", "x32"])
def test_q1_and_q6_take_8_rows_a_thread_and_12_warps_an_sm(mode):
    """The main path's programs at full batches: 8 rows a thread and at
    least 12 warps an SM (two staging buffers where they still allow as
    many); at distributed q1's 8,192 rows, one row a thread and the
    threads cut to 64 to spread the tiles over the SMs."""
    shapes = {(len(p.code), p.n_regs) for p in _tpch_programs(mode)}
    assert {(17, 11), (22, 19)} <= shapes
    for program in _tpch_programs(mode):
        if (len(program.code), program.n_regs) not in ((17, 11), (22, 19)):
            continue
        widths = {s: 4 if mode == "x32" else 8 for s, dt, opt in program._reads if not opt}
        threads, rows, stages, smem = TK.expr_program_plan(program, 1 << 23, widths)
        assert rows == 8 and TK.expr_resident_warps(threads, smem) >= 12
        for other in (2, 1):
            if other > stages:
                s2 = TK.expr_smem_bytes(program.n_regs, program.reg_counts,
                                        TK._staged_widths(program, widths), threads, 8, other)
                assert TK.expr_resident_warps(threads, s2) < TK.expr_resident_warps(threads, smem)
        threads, rows, stages, _ = TK.expr_program_plan(program, 8192, widths)
        assert (threads, rows) == (64, 1)  # 128 CTAs of two warps


def synthetic(n_leaves: int, n_regs: int, mix: str = "f64") -> "TK.ExprProgram":
    """A program of ``n_leaves`` f64 leaves (each with a validity slot)
    then registers up to ``n_regs``: ``f64`` a chain of adds (every one a
    tile), ``mixed`` a cycle of a literal, an add, a compare and a select,
    ``bool`` a chain of compares and ANDs.  Two stores: the last
    register's value and validity."""
    inputs = [f"c{i}" for i in range(n_leaves)] + [f"c{i}__valid" for i in range(n_leaves)]
    rows = [[OP["leaf"], TK.DT_F64, -1, i, n_leaves + i, -1, 0] for i in range(n_leaves)]
    last_f64 = n_leaves - 1
    while len(rows) < n_regs:
        i, leaf = len(rows), len(rows) % n_leaves
        if mix == "f64" or (mix == "mixed" and i % 4 == 1):
            rows.append([OP["add"], TK.DT_F64, TK.DT_F64, last_f64, leaf, -1, 0])
            last_f64 = i
        elif mix == "mixed" and i % 4 == 0:
            rows.append([OP["lit"], TK.DT_F64, -1, -1, -1, -1, 4607182418800017408])
        elif mix == "mixed" and i % 4 == 2:
            rows.append([OP["lt"], TK.DT_BOOL, TK.DT_F64, last_f64, leaf, -1, 0])
        elif mix == "mixed":
            rows.append([OP["select"], TK.DT_F64, -1, i - 1, leaf, last_f64, 0])
            last_f64 = i
        elif i % 2:
            rows.append([OP["lt"], TK.DT_BOOL, TK.DT_F64, leaf, last_f64, -1, 0])
        else:
            rows.append([OP["and"], TK.DT_BOOL, -1, i - 1, i - 1, -1, 0])
    top = len(rows) - 1
    dt = rows[top][1]
    rows += [[OP["store_value"], dt, -1, top, 0, -1, 0],
             [OP["store_valid"], TK.DT_BOOL, -1, top, 1, -1, 0]]
    return TK.ExprProgram.from_parts(
        code=rows, consts=[], inputs=inputs, n_regs=n_regs,
        stores=[("value", top, dt), ("valid", top, TK.DT_BOOL)],
        outputs=[None, None, ("value", top, dt, 0), ("valid", top, 1)])


def _edge(n_leaves: int, mix: str) -> int:
    """The most registers the admission rule takes for this shape."""
    n = n_leaves + 1
    while admitted(synthetic(n_leaves, n + 1, mix), 2 * n_leaves):
        n += 1
    return n


@pytest.mark.parametrize("n_leaves, mix", [(1, "f64"), (8, "mixed"), (48, "f64"),
                                           (48, "mixed"), (48, "bool"), (3, "bool")])
def test_synthetic_programs_to_the_admission_edge(n_leaves, mix):
    """Past 64 registers up to the last one the admission rule takes,
    each plan fits; one register more raises ValueError before a launch."""
    edge = _edge(n_leaves, mix)
    assert edge > 64
    for n_regs in sorted({65, 100, edge // 2, edge - 1, edge}):
        if n_regs > n_leaves:
            assert_plans_fit(synthetic(n_leaves, n_regs, mix))
    refused = synthetic(n_leaves, edge + 1, mix)
    assert not TK.expr_fits(refused, len(refused.inputs))
    inputs = [None] * len(refused.inputs)
    with pytest.raises(ValueError, match="exceed the kernel"):
        TK._check_expr_args(refused, inputs, 10, torch.device("cuda"))


def test_a_thousand_and_twenty_four_rows_of_code():
    """1,024 rows of code pass the instruction limit but never the
    admission rule's shared memory (at least 952 registers), so such a
    program raises; 1,025 rows raise on the limit itself."""
    for n_regs in (1022, 1023):
        program = synthetic(2, n_regs, "f64")
        assert len(program.code) in (1024, 1025)
        assert not admitted(program, 4) and not TK.expr_fits(program, 4)
        with pytest.raises(ValueError, match="exceed the kernel"):
            TK._check_expr_args(program, [None] * 4, 10, torch.device("cuda"))


def _stored(n_outputs: int) -> "TK.ExprProgram":
    """One f64 leaf and ``n_outputs`` adds, each stored: ``n_outputs``
    output slots."""
    rows = [[OP["leaf"], TK.DT_F64, -1, 0, 1, -1, 0]]
    rows += [[OP["add"], TK.DT_F64, TK.DT_F64, i, 0, -1, 0] for i in range(n_outputs)]
    stores = [("value", i + 1, TK.DT_F64) for i in range(n_outputs)]
    rows += [[OP["store_value"], TK.DT_F64, -1, i + 1, i, -1, 0] for i in range(n_outputs)]
    return TK.ExprProgram.from_parts(
        code=rows, consts=[], inputs=["c0", "c0__valid"], n_regs=n_outputs + 1,
        stores=stores, outputs=[None, None] + [("value", i + 1, TK.DT_F64, i)
                                               for i in range(n_outputs)])


def test_ninety_six_inputs_and_seventy_two_outputs():
    """The slot limits: 96 inputs (48 leaves with validities) admitted
    and fitting, 97 refused; 72 outputs admitted and fitting, 73 refused."""
    program = synthetic(48, 200, "mixed")
    assert len(program.inputs) == 96
    assert_plans_fit(program)
    assert not TK.expr_fits(program, 97)
    assert_plans_fit(_stored(72))
    refused = _stored(73)
    with pytest.raises(ValueError, match="exceed the kernel"):
        TK._check_expr_args(refused, [None, None], 10, torch.device("cuda"))


def test_register_layout_of_q1():
    """q1's program (x64): each leaf is its staged column, each literal one
    invariant uniform value, the arithmetic 8-byte tiles, the filter's
    comparison a mask; no operand needs a scratch block (the one
    conversion, of the literal 1, is of an invariant value)."""
    (program,) = [p for p in _tpch_programs("x64") if (len(p.code), p.n_regs) == (17, 11)][:1]
    words = program.reg_layout.tolist()
    for (op, dt, _, a, *_), w in zip(program.code[: program.n_regs].tolist(), words):
        kind, flags, idx = w & 3, w & 12, w >> 4
        name = TK.EXPR_OPS[op]
        if name == "leaf":
            assert (kind, flags, idx) == (TK.EXPR_REG_LEAF, 0, a)
        elif name == "lit":
            assert (kind, flags) == (TK.EXPR_REG_UNIFORM, TK.EXPR_REG_INVARIANT)
        elif dt == TK.DT_BOOL:
            assert (kind, flags) == (TK.EXPR_REG_MASK, 0)
        else:
            assert (kind, flags) == (TK.EXPR_REG_TILE, TK.EXPR_REG_WIDE)
    # sub and add die in the muls that read them: two tiles, each shared
    assert program.reg_counts == (2, 1, 2, 0, 0)
    assert_tiles_disjoint(program)
