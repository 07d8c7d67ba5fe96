"""The keyed finish against the design it replaced, on one CUDA card.

The earlier finish is rebuilt from kernels the port keeps: every state slot
filled with its identity (PyTorch), K2 (``seg_scan.cu``) through
``gids["gid_in"]`` with its sorted-aggregate epilogue merging each segment's
totals into the state rows, then the key rows (``keyed_unfold`` after a
folded sort, else a PyTorch gather where the earlier design had a CUDA
one, so the split's "torch" share, the fill and that gather, overstates
the earlier design where the key rows are many, as at h2o q10; K2's
passes are as they were).  It stands in for the
finish wrappers while the keyed legs run end to end, in turns with the
finish itself (``--turns``, default new, parent, parent, new) in one
process: TPC-H q3 on the keyed route (drained, ``chip_smoke.py``'s
``q3_keyed_phase`` settings) and db-benchmark's h2o q6, q9 and q10, each
in x64 and x32.  Each run's stage ``device_time_ns`` and wall seconds are
kept, the two designs' answers held to each other (floats at rel 1e-9,
x32 at 1e-6), and the finish is then timed alone at each leg's first call
in both designs: the card's ms a call with the host ahead (``burst_ms``)
and torch.profiler's split by kernel; beside them the finish in column
groups (``column_groups``: passes whose gathered arrays fit in
GROUP_BYTES of the 50 MB L2, one more read of perm and s2 a pass,
bit-identical).  With ``--turns new`` the leg runs once and no answer is
compared.

    python3 dev/finish_ab.py [--sf 10] [--legs "q3 keyed,h2o q10"] [--out FILE]

Prints one JSON line a leg and, with ``--out``, writes them all to that
file.  Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEGS = ("h2o q6", "h2o q9", "h2o q10", "q3 keyed")
GROUP_BYTES = 40 << 20  # the column-group order: a pass's gathered arrays in L2


def finish_parent(TK, args, x32: bool):
    """The earlier finish at ``args`` (the finish wrappers' arguments)."""
    import torch

    specs, columns, field_col, ops, perm, gids, ng, cap = args[:8]
    fold = args[8] if len(args) > 8 else None
    n_state, device = len(ops), perm.device
    n_keys = len(gids["sk"]) if fold is None else len(fold)
    if x32:
        packed = torch.empty((n_state + n_keys, cap), dtype=torch.int32, device=device)
        packed[:n_state] = TK.init_states(specs, cap, device, "x32")
    else:
        packed, _ = TK._finish_packed(specs, ops, n_keys, cap, device)
    TK._scan_into_state_cuda(columns, field_col, ops, packed[:n_state], perm.numel(), perm,
                             gids["gid_in"])
    if fold is not None:
        TK.keyed_unfold_cuda(gids["sk"][0], gids["starts"], ng, fold, packed[n_state:])
    elif n_keys:
        TK.keyed_keys_reference(gids["sk"], gids["starts"], ng, packed[n_state:])
    return packed


def finish_groups(TK, new, args):
    """The finish at ``args`` with its columns in L2-sized groups."""
    def passes(columns: list) -> list:
        out, size = [], 0
        for i, c in enumerate(columns):
            b = sum(t.numel() * t.element_size() for t in (c.values, c.valid, c.values2)
                    if t is not None)
            if not out or len(out[-1]) == TK.FINISH_MAX_COLUMNS or size + b > GROUP_BYTES:
                out.append([])
                size = 0
            out[-1].append(i)
            size += b
        return out

    kept = TK._finish_passes
    TK._finish_passes = passes
    try:
        return new(*args), len(passes(args[1]))
    finally:
        TK._finish_passes = kept


def leg_sessions(S, tbt, sf: float, names: list, device) -> dict:
    """name -> (fresh session, sql) for each leg in ``names``, in LEGS
    order; each table is made at its first session."""
    from benchmarks.h2o.__main__ import QUESTIONS
    from benchmarks.tpch.datagen import gen_lineitem, gen_table
    from benchmarks.tpch.queries import QUERIES

    tables: dict = {}

    def g1():
        if "g1" not in tables:
            tables["g1"] = S.h2o_batches()
        return tables["g1"]

    def tpch():
        if "tpch" not in tables:
            t0 = time.perf_counter()
            tables["tpch"] = (S.lineitem_batches(gen_lineitem(sf)), gen_table("orders", sf),
                              gen_table("customer", sf))
            print(f"datagen: sf={sf} s={time.perf_counter() - t0!r}", flush=True)
        return tables["tpch"]

    out = {}
    sqls = {q: sql for q, _name, sql in QUESTIONS}
    settings = dict(S.H2O_LEGS)
    for q in settings:
        if "h2o " + q in names:
            def session(q=q):
                ctx = tbt.SessionContext(tbt.BallistaConfig(dict(S.SETTINGS, **settings[q])),
                                         device=device)
                ctx.register_record_batches("x", [g1()])
                return ctx

            out["h2o " + q] = (session, sqls[q])
    if "q3 keyed" in names:
        cfg = dict(S.SETTINGS, **{"ballista.tpu.highcard_mode": "device",
                                  "ballista.tpu.keyed_buffer_mb": str(S.Q3_KEYED_BUFFER_MB)})

        def q3_session():
            batches, orders, customer = tpch()
            ctx = tbt.SessionContext(tbt.BallistaConfig(cfg), device=device)
            ctx.register_record_batches("lineitem", [batches])
            ctx.register_arrow_table("orders", orders)
            ctx.register_arrow_table("customer", customer)
            return ctx

        out["q3 keyed"] = (q3_session, QUERIES[3])
    return out


def run_leg(S, TK, what: str, session, sql: str, x32: bool, turns: list) -> dict:
    """The leg in ``turns``, the finish wrapper swapped for the earlier
    design on "parent" turns; then the finish alone at its first call."""
    import torch

    from arrow_ballista_tpu_torch.ops.stage_compiler import TorchStageExec

    name = "keyed_finish_x32_cuda" if x32 else "keyed_finish_cuda"
    new = getattr(TK, name)
    first: list = []
    calls = [0]

    def new_kept(*args):
        if not first:
            first.append(args)
        calls[0] += 1
        return new(*args)

    def parent(*args):
        calls[0] += 1
        return finish_parent(TK, args, x32)

    runs = {"new": [], "parent": []}
    answers = {}
    for which in turns:
        ctx = session()
        plan = ctx.sql(sql).physical_plan()
        calls[0] = 0
        setattr(TK, name, new_kept if which == "new" else parent)
        try:
            t0 = time.perf_counter()
            got = ctx.execute(plan)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            setattr(TK, name, new)
        metrics = S._stage_metrics(S._stage_nodes(plan, TorchStageExec))
        runs[which].append(dict(device_time_ns=metrics.get("device_time_ns", 0), wall_s=wall,
                                finish_calls=calls[0]))
        answers[which] = got
        del ctx, plan
    if "parent" in answers:
        S._sorted_close(answers["parent"], answers["new"], f"finish A/B {what}",
                        S.X32_REL if x32 else S.REL,
                        S.X32_CORR_ATOL if x32 and "q9" in what else None)
    del answers
    args = first[0]
    grouped, n_passes = finish_groups(TK, new, args)
    if not torch.equal(grouped, new(*args)):
        raise AssertionError(f"{what}: the column-group order differs")
    del grouped
    alone = {}
    for which, fn in (("new", lambda: new(*args)),
                      ("parent", lambda: finish_parent(TK, args, x32)),
                      ("column_groups", lambda: finish_groups(TK, new, args))):
        burst = S._burst_ms(fn)
        alone[which] = dict(burst_ms=burst, split=S._finish_split(fn, burst))
    perm, ng, cap = args[4], args[6], args[7]
    return dict(turns=turns, runs=runs, finish=dict(
        rows=perm.numel(), groups=ng, capacity=cap, fields=len(args[3]),
        passes=len(TK._finish_passes(args[1])), group_passes=n_passes, **alone))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=10.0, help="TPC-H scale factor of q3 keyed")
    ap.add_argument("--legs", default=",".join(LEGS), help="comma-separated, of " + str(LEGS))
    ap.add_argument("--turns", default="new,parent,parent,new")
    ap.add_argument("--out", help="JSON file for every leg's results")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("finish_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import arrow_ballista_tpu_torch as tbt
    import chip_smoke as S
    from arrow_ballista_tpu_torch.ops import kernels as TK
    from arrow_ballista_tpu_torch.ops.cuda import build

    print(f"card: {S.card_line()}", flush=True)
    t0 = time.perf_counter()
    build.load()
    print(f"build: s={time.perf_counter() - t0!r}", flush=True)
    names = [n.strip() for n in opts.legs.split(",") if n.strip()]
    unknown = set(names) - set(LEGS)
    if unknown:
        raise SystemExit(f"finish_ab: unknown legs {sorted(unknown)}")
    turns = opts.turns.split(",")
    if set(turns) - {"new", "parent"}:
        raise SystemExit(f"finish_ab: turns {turns}")
    device = torch.device("cuda")
    out = {"card": S.card_line()}
    for leg, (session, sql) in leg_sessions(S, tbt, opts.sf, names, device).items():
        for x32 in (False, True):
            what = ("x32 " if x32 else "") + leg
            if x32:
                TK.set_precision("x32")
            try:
                out[what] = run_leg(S, TK, what, session, sql, x32, turns)
            finally:
                TK.set_precision(None)
            print(f"finish A/B {what}: {json.dumps(out[what])}", flush=True)
            torch.cuda.empty_cache()
    if opts.out:
        os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(out, f, indent=1)
    print(f"finish_ab: ok s={time.perf_counter() - t0!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
