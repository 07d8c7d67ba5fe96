"""Device window-function kernel (sort + segmented scans + gathers).

Counterpart of ``arrow_ballista_tpu/ops/window_kernel.py`` for one torch
device, x64 only.  One window signature runs as:

* ONE stable multi-key radix argsort (``kernels.radix_argsort``, K1) of
  the rows by (pad flag, PARTITION BY codes, per-ORDER-BY null rank and
  order-preserving integer key), encoded on the host so signed order is
  the SQL order;
* partition and peer start flags over the sorted keys (K4,
  ``window_flags``);
* segmented scans (``kernels.seg_scan``, K2): each row's segment and peer
  first/last row as a first/last-row scan of the row index, dense_rank as
  a count of peer starts, running RANGE aggregates and segment-reset
  ROWS-frame prefixes over the arguments gathered through the permutation;
* framed min/max by a sparse table (``range_extremum``, K3);
* the per-row arithmetic (ranking, ntile, values at the last peer, frame
  prefix differences, clamped lag/lead/first/last gathers) and the pack
  into ``[n_out_rows, n]`` int64 words in INPUT row order (K4,
  ``window_pack``).

Every step is a function on tensors: on CUDA tensors it launches its
hand-written kernel (``ops/cuda/``), on CPU tensors it runs its plain
PyTorch twin beside it.

Spec encoding (as the reference's, without the x32 pair flag):
  ("row_number",) | ("rank",) | ("dense_rank",) | ("ntile", k)
  | ("agg", fn, arg_slot)            # fn in sum|count|avg|min|max, RANGE
  | ("aggf", fn, arg_slot, a, b)     # ROWS frame [i+a, i+b]; None=UNBOUNDED
  | ("val", fn, arg_slot, offset)    # fn in lag|lead|first_value|last_value
Per-spec packed layout (the reference's x64 layout; ``_unpack`` reads it):
  ranking/ntile → 1 int row; agg count → 1 int row; agg sum/avg → val, cnt;
  agg min/max → val, cnt; aggf count(*)/count → 1 int row; aggf sum/avg →
  P@hi, P@lo-1, cnt; aggf min/max → val, cnt; val fns → val, ok flag.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import kernels as K

I64 = K.I64
F64 = K.F64

# packed-row kinds (ops/cuda/window_epilogue.h: PackKind)
WP_ROW_NUMBER = 0
WP_RANK = 1
WP_AT_ROW = 2
WP_NTILE = 3
WP_AT_PEER_LAST = 4
WP_RANGE_COUNT = 5
WP_FRAME_COUNT = 6
WP_FRAME_HI = 7
WP_FRAME_LO = 8
WP_FRAME_DIFF = 9
WP_VALUE = 10
WP_VALUE_OK = 11
_VALUE_FN = {"first_value": 0, "last_value": 1, "lag": 2, "lead": 3}
MAX_KEYS = 32


# ---------------------------------------------------------- K4: flags
def window_flags_reference(keys: list, perm: torch.Tensor, n_part: int):
    """Plain twin of ``window_flags``: (segment start, peer start) as uint8
    in sorted order (``_change_flag`` over the partition keys and over all
    keys; row 0 starts both)."""
    n = perm.shape[0]
    p = perm.long()
    seg = torch.zeros(n, dtype=torch.bool, device=perm.device)
    peer = torch.zeros_like(seg)
    for i, k in enumerate(keys):
        s = k[p]
        diff = s[1:] != s[:-1]
        peer[1:] |= diff
        if i < n_part:
            seg[1:] |= diff
    if n:
        seg[0] = peer[0] = True
    return seg.to(torch.uint8), peer.to(torch.uint8)


def window_flags_cuda(keys: list, perm: torch.Tensor, n_part: int):
    """Launch the change-flag kernel (ops/cuda/window_epilogue.cu), the
    ``_change_flag`` part of ``arrow_ballista_tpu/ops/window_kernel.py:
    make_window_kernel``."""
    from .cuda.build import load

    device = perm.device
    n = perm.shape[0]
    if device.type != "cuda" or not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError("window_flags: 1-32 CUDA key columns")
    K._check_cuda_tensor(perm, "perm", (torch.int32,), n, device)
    for i, k in enumerate(keys):
        K._check_cuda_tensor(k, f"key {i}", (torch.int32, I64), n, device)
    seg = torch.empty(n, dtype=torch.uint8, device=device)
    peer = torch.empty(n, dtype=torch.uint8, device=device)
    load().window_flags(perm, list(keys), n_part, seg, peer)
    K.count_launch("window_epilogue")
    return seg, peer


def window_flags(keys: list, perm: torch.Tensor, n_part: int):
    if perm.device.type == "cpu":
        return window_flags_reference(keys, perm, n_part)
    return window_flags_cuda(keys, perm, n_part)


# --------------------------------------------------------- K3: extremum
def _frame(sf, sl, a: Optional[int], b: Optional[int], n: int):
    """(lo, hi) of each sorted row's ROWS frame, clipped to its segment."""
    idx = torch.arange(n, dtype=I64, device=sf.device)
    lo = sf if a is None else torch.maximum(sf, idx + a)
    hi = sl if b is None else torch.minimum(sl, idx + b)
    return lo, hi


def _table_depth(a: Optional[int], b: Optional[int], n: int) -> int:
    """Sparse-table levels: finite frames need ceil(log2(len)) levels."""
    max_len = b - a + 1 if a is not None and b is not None else n
    return max(1, int(max_len - 1).bit_length())


def range_extremum_reference(
    values, valid, perm, sf, sl, a, b, op: int
) -> torch.Tensor:
    """Plain twin of ``range_extremum``: the reference's
    ``_range_extremum`` written in torch, in sorted order as int64 words;
    empty frames hold the identity."""
    n = perm.shape[0]
    is_int = K._OP_ROLE[op][1]
    dtype = I64 if is_int else F64
    ident = K._ident_value(op, dtype)
    p = perm.long()
    v = values[p].to(dtype)
    if valid is not None:
        v = torch.where(valid[p], v, torch.full_like(v, ident))
    levels = [v]
    cur = v
    depth = _table_depth(a, b, n)
    for k in range(1, depth + 1):
        s = 1 << (k - 1)
        pad = torch.full((min(s, n),), ident, dtype=dtype, device=v.device)
        shifted = torch.cat([cur[s:], pad]) if s < n else pad
        cur = K._fold(op, cur, shifted)
        levels.append(cur)
    lo, hi = _frame(sf, sl, a, b, n)
    length = torch.clamp(hi - lo + 1, min=1)
    kq = torch.zeros_like(length)
    for k in range(1, depth + 1):
        kq += (length >= (1 << k)).to(I64)
    flat = torch.stack(levels).reshape(-1)
    aidx = torch.clamp(lo, 0, n - 1)
    bidx = torch.clamp(hi - (1 << kq) + 1, 0, n - 1)
    res = K._fold(op, flat[kq * n + aidx], flat[kq * n + bidx])
    res = torch.where(hi < lo, torch.full_like(res, ident), res)
    return res.view(I64) if dtype == F64 else res


def range_extremum_cuda(values, valid, perm, sf, sl, a, b, op: int) -> torch.Tensor:
    """Launch the sparse-table range extremum (ops/cuda/range_extremum.cu),
    ``arrow_ballista_tpu/ops/window_kernel.py:_range_extremum``."""
    from .cuda.build import load

    device = perm.device
    n = perm.shape[0]
    if device.type != "cuda" or op not in (
        K.OP_MIN_F64, K.OP_MAX_F64, K.OP_MIN_I64, K.OP_MAX_I64
    ):
        raise ValueError(f"range_extremum: op {op} on {device}")
    K._check_cuda_tensor(perm, "perm", (torch.int32,), n, device)
    dtypes = (I64,) if K._OP_ROLE[op][1] else (F64, I64)
    K._check_cuda_tensor(values, "values", dtypes, n, device)
    if valid is not None:
        K._check_cuda_tensor(valid, "validity", (torch.bool,), n, device)
    K._check_cuda_tensor(sf, "seg_first", (I64,), n, device)
    K._check_cuda_tensor(sl, "seg_last", (I64,), n, device)
    depth = _table_depth(a, b, n)
    out = torch.empty(n, dtype=I64, device=device)
    load().range_extremum(
        op, depth, perm, values,
        torch.empty(0, dtype=torch.bool, device=device) if valid is None else valid,
        values.dtype == I64, sf, sl,
        a is not None, 0 if a is None else a, b is not None, 0 if b is None else b,
        torch.empty((depth + 1) * n, dtype=I64, device=device), out,
    )
    K.count_launch("range_extremum")
    return out


def range_extremum(values, valid, perm, sf, sl, a, b, op: int) -> torch.Tensor:
    """Per sorted row, the min/max (``op``) of the argument over its ROWS
    frame [i+a, i+b] clipped to its segment [sf, sl] (``None`` =
    unbounded), as int64 words; the identity where the frame is empty."""
    if perm.device.type == "cpu":
        return range_extremum_reference(values, valid, perm, sf, sl, a, b, op)
    return range_extremum_cuda(values, valid, perm, sf, sl, a, b, op)


# ------------------------------------------------------------- K4: pack
@dataclass(frozen=True, eq=False)
class PackRow:
    """One packed output row (ops/cuda/window_epilogue.h: PackKind).
    Frame kinds read ``a``/``b`` with ``has_a``/``has_b``; value kinds
    keep their function code in ``has_a`` and offset in ``a``."""

    kind: int
    a: int = 0
    b: int = 0
    has_a: int = 0
    has_b: int = 0
    x: Optional[torch.Tensor] = None       # [n] words, sorted order
    values: Optional[torch.Tensor] = None  # [n] f64/i64, input order
    valid: Optional[torch.Tensor] = None   # [n] bool, input order


def _pack_row_reference(row: PackRow, perm, sf, sl, pf, pl, n: int):
    """One packed row in sorted order (torch, int64 words)."""
    i = torch.arange(n, dtype=I64, device=perm.device)
    kind = row.kind
    if kind == WP_ROW_NUMBER:
        return i - sf + 1
    if kind == WP_RANK:
        return pf - sf + 1
    if kind == WP_AT_ROW:
        return row.x
    if kind == WP_NTILE:
        k = row.a
        size, pos = sl - sf + 1, i - sf
        q, r = size // k, size % k
        big = r * (q + 1)
        return torch.where(
            pos < big, pos // (q + 1) + 1,
            r + (pos - big) // torch.clamp(q, min=1) + 1,
        )
    if kind == WP_AT_PEER_LAST:
        return row.x[pl]
    if kind == WP_RANGE_COUNT:
        return pl - sf + 1
    if kind in (WP_VALUE, WP_VALUE_OK):
        fn = row.has_a
        ok = torch.ones(n, dtype=torch.bool, device=perm.device)
        if fn == _VALUE_FN["first_value"]:
            src = sf
        elif fn == _VALUE_FN["last_value"]:
            src = pl
        else:
            src = i - row.a if fn == _VALUE_FN["lag"] else i + row.a
            ok = (src >= sf) & (src <= sl)
        at = perm.long()[torch.clamp(src, 0, n - 1)]
        if kind == WP_VALUE:
            v = row.values[at]
            return v.view(I64) if v.dtype == F64 else v
        if row.valid is not None:
            ok = ok & row.valid[at]
        return ok.to(I64)
    lo, hi = _frame(sf, sl, row.a if row.has_a else None,
                    row.b if row.has_b else None, n)
    empty = hi < lo
    lo_open = lo > sf
    zero = torch.zeros(n, dtype=I64, device=perm.device)
    if kind == WP_FRAME_COUNT:
        return torch.where(empty, zero, hi - lo + 1)
    at_hi = row.x[torch.clamp(hi, 0, n - 1)]
    at_lom1 = torch.where(lo_open, row.x[torch.clamp(lo - 1, 0, n - 1)], zero)
    if kind == WP_FRAME_HI:
        return at_hi
    if kind == WP_FRAME_LO:
        return at_lom1
    return torch.where(empty, zero, at_hi - at_lom1)  # WP_FRAME_DIFF


def window_pack_reference(rows: list, perm, sf, sl, pf, pl) -> torch.Tensor:
    """Plain twin of ``window_pack``: every row computed in sorted order,
    then gathered back to input order through the inverse permutation."""
    n = perm.shape[0]
    p = perm.long()
    inv = torch.empty_like(p)
    inv[p] = torch.arange(n, dtype=I64, device=perm.device)
    out = torch.empty((len(rows), n), dtype=I64, device=perm.device)
    for r, row in enumerate(rows):
        out[r] = _pack_row_reference(row, perm, sf, sl, pf, pl, n)[inv]
    return out


def _needs(row: PackRow) -> str:
    """The index arrays a packed row reads (the kernel reads no other)."""
    if WP_FRAME_COUNT <= row.kind <= WP_FRAME_DIFF:
        return "sf sl"
    if row.kind in (WP_VALUE, WP_VALUE_OK):
        if row.has_a == _VALUE_FN["last_value"]:
            return "sf pl"
        return "sf" if row.has_a == _VALUE_FN["first_value"] else "sf sl"
    return {
        WP_ROW_NUMBER: "sf", WP_RANK: "sf pf", WP_NTILE: "sf sl",
        WP_AT_PEER_LAST: "pl", WP_RANGE_COUNT: "sf pl",
    }.get(row.kind, "")


def window_pack_cuda(rows: list, perm, sf, sl, pf, pl) -> torch.Tensor:
    """Launch the pack kernel (ops/cuda/window_epilogue.cu): the per-row
    arithmetic, gathers, inverse permutation and packed output of
    ``arrow_ballista_tpu/ops/window_kernel.py:make_window_kernel``."""
    from .cuda.build import load

    device = perm.device
    n = perm.shape[0]
    if device.type != "cuda":
        raise ValueError("window_pack runs on CUDA tensors")
    K._check_cuda_tensor(perm, "perm", (torch.int32,), n, device)
    for name, t in (("seg_first", sf), ("seg_last", sl),
                    ("peer_first", pf), ("peer_last", pl)):
        if t is not None:
            K._check_cuda_tensor(t, name, (I64,), n, device)
    have = {"sf": sf, "sl": sl, "pf": pf, "pl": pl}
    desc = []
    for r, row in enumerate(rows):
        need = _needs(row)
        if any(have[x] is None for x in need.split()):
            raise ValueError(f"pack row {r} needs {need}")
        if row.kind == WP_NTILE and row.a < 1:
            raise ValueError(f"pack row {r}: ntile({row.a})")
        if row.x is not None:
            K._check_cuda_tensor(row.x, f"pack row {r}", (I64,), n, device)
        elif row.kind in (WP_AT_ROW, WP_AT_PEER_LAST) or (
            WP_FRAME_HI <= row.kind <= WP_FRAME_DIFF
        ):
            raise ValueError(f"pack row {r} needs its column")
        if row.kind == WP_VALUE:
            K._check_cuda_tensor(row.values, f"pack row {r} values", (F64, I64), n, device)
        if row.valid is not None:
            K._check_cuda_tensor(row.valid, f"pack row {r} validity", (torch.bool,), n, device)
        ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
        desc.append([row.kind, row.a, row.b, row.has_a, row.has_b,
                     ptr(row.x), ptr(row.values), ptr(row.valid)])
    out = torch.empty((len(rows), n), dtype=I64, device=device)
    if not rows:
        return out
    empty = torch.empty(0, dtype=I64, device=device)
    opt = lambda t: empty if t is None else t  # noqa: E731
    load().window_pack(
        perm, torch.empty(n, dtype=torch.int32, device=device),
        opt(sf), opt(sl), opt(pf), opt(pl),
        torch.tensor(desc, dtype=I64).to(device), out,
    )
    K.count_launch("window_epilogue")
    return out


def window_pack(rows: list, perm, sf, sl, pf, pl) -> torch.Tensor:
    """``[len(rows), n]`` int64 words in input row order."""
    if perm.device.type == "cpu":
        return window_pack_reference(rows, perm, sf, sl, pf, pl)
    return window_pack_cuda(rows, perm, sf, sl, pf, pl)


# ------------------------------------------------------------ the kernel
def _iota_col(op: int) -> K.ScanColumn:
    return K.ScanColumn(K.SS_IOTA, op)


def make_window_kernel(specs: tuple, n_part_keys: int, n_order_keys: int,
                       n_args: int):
    """``fn(part_keys, order_keys, args) -> packed`` on the arrays' device.

    ``part_keys``/``order_keys`` are int32/int64 tensors (the pad flag is
    part_keys[0]); ``args`` are (value f64/i64, validity bool) pairs.
    ``packed`` is an [n_out_rows, n] int64 tensor in INPUT row order,
    floats as their bits, laid out as the module docstring says.
    """

    def kernel(part_keys, order_keys, args):
        keys = list(part_keys) + list(order_keys)
        if len(part_keys) != n_part_keys or len(order_keys) != n_order_keys:
            raise ValueError("window kernel: key count")
        if len(args) != n_args:
            raise ValueError("window kernel: argument count")
        n = keys[0].shape[0]
        perm = K.radix_argsort(keys)
        seg_flag, peer_flag = window_flags(keys, perm, n_part_keys)
        kinds = {s[0] for s in specs}
        fns = {s[1] for s in specs if s[0] == "val"}
        need_pf = "rank" in kinds
        need_pl = "agg" in kinds or "last_value" in fns
        need_sl = bool(kinds & {"ntile", "aggf", "val"})

        # one forward scan over the partition flags carries every column
        # that resets with the partition
        cols: list = [_iota_col(K.OP_MIN_I64)]  # seg_first
        if "dense_rank" in kinds:
            cols.append(K.ScanColumn(K.SS_AUX, K.OP_ADD_I64))
        col_of: dict = {}

        def column(key, make) -> int:
            if key not in col_of:
                col_of[key] = len(cols)
                cols.append(make())
            return col_of[key]

        def count_col(slot) -> int:
            return column(("count", slot), lambda: K.ScanColumn(
                K.SS_COUNT, K.OP_ADD_I64, valid=args[slot][1]))

        def value_col(slot, op) -> int:
            return column(("value", slot, op), lambda: K.ScanColumn(
                K.SS_VALUES, op, values=args[slot][0], valid=args[slot][1]))

        def extremum_op(slot, fn) -> int:
            is_int = not args[slot][0].is_floating_point()
            if fn == "min":
                return K.OP_MIN_I64 if is_int else K.OP_MIN_F64
            return K.OP_MAX_I64 if is_int else K.OP_MAX_F64

        plan: list = []  # per spec: the (kind, ...) rows to pack
        for spec in specs:
            kind = spec[0]
            if kind in ("agg", "aggf") and spec[2] is not None:
                fn, slot = spec[1], spec[2]
                cnt = count_col(slot)
                if fn in ("sum", "avg"):
                    plan.append((spec, cnt, value_col(slot, K.OP_ADD_F64)))
                elif fn in ("min", "max") and kind == "agg":
                    plan.append((spec, cnt, value_col(slot, extremum_op(slot, fn))))
                else:
                    plan.append((spec, cnt, None))
            else:
                plan.append((spec, None, None))

        scanned = K.seg_scan(cols, n, perm=perm, flag=seg_flag, aux=peer_flag)
        sf = scanned[0]
        dense = scanned[1] if "dense_rank" in kinds else None
        pf = pl = sl = None
        if need_pf:
            (pf,) = K.seg_scan([_iota_col(K.OP_MIN_I64)], n, flag=peer_flag)
        if need_sl:
            (sl,) = K.seg_scan([_iota_col(K.OP_MAX_I64)], n, flag=seg_flag,
                               reverse=True)
        if need_pl:
            (pl,) = K.seg_scan([_iota_col(K.OP_MAX_I64)], n, flag=peer_flag,
                               reverse=True)

        rows: list = []
        for spec, cnt, val in plan:
            kind = spec[0]
            if kind == "row_number":
                rows.append(PackRow(WP_ROW_NUMBER))
            elif kind == "rank":
                rows.append(PackRow(WP_RANK))
            elif kind == "dense_rank":
                rows.append(PackRow(WP_AT_ROW, x=dense))
            elif kind == "ntile":
                rows.append(PackRow(WP_NTILE, a=spec[1]))
            elif kind == "agg":
                if cnt is None:  # count(*): rows through the last peer
                    rows.append(PackRow(WP_RANGE_COUNT))
                    continue
                if val is not None:
                    rows.append(PackRow(WP_AT_PEER_LAST, x=scanned[val]))
                rows.append(PackRow(WP_AT_PEER_LAST, x=scanned[cnt]))
            elif kind == "aggf":
                fn, slot, a, b = spec[1], spec[2], spec[3], spec[4]
                frame = dict(a=a or 0, b=b or 0, has_a=int(a is not None),
                             has_b=int(b is not None))
                if cnt is None:  # count(*)
                    rows.append(PackRow(WP_FRAME_COUNT, **frame))
                    continue
                cnt_row = PackRow(WP_FRAME_DIFF, x=scanned[cnt], **frame)
                if fn == "count":
                    rows.append(cnt_row)
                elif fn in ("min", "max"):
                    v, m = args[slot]
                    res = range_extremum(v, m, perm, sf, sl, a, b,
                                         extremum_op(slot, fn))
                    rows.extend([PackRow(WP_AT_ROW, x=res), cnt_row])
                else:
                    rows.extend([
                        PackRow(WP_FRAME_HI, x=scanned[val], **frame),
                        PackRow(WP_FRAME_LO, x=scanned[val], **frame),
                        cnt_row,
                    ])
            elif kind == "val":
                fn, slot, offset = spec[1], spec[2], spec[3]
                v, m = args[slot]
                code = _VALUE_FN[fn]
                rows.append(PackRow(WP_VALUE, a=offset, has_a=code, values=v))
                rows.append(PackRow(WP_VALUE_OK, a=offset, has_a=code, valid=m))
            else:
                raise ValueError(f"window spec {spec}")
        return window_pack(rows, perm, sf, sl, pf, pl)

    return kernel
