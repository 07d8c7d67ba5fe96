"""Device lowering of WindowExec on one torch device.

Counterpart of ``arrow_ballista_tpu/ops/window_compiler.py``, in both
dtype modes: each eligible window stage evaluates as ONE device program
per window signature (``ops/window_kernel.py``): multi-key radix sort,
boundary flags, segmented scans, gathers, packed fetch.

Host responsibilities here:
* eligibility (plan time): supported function set, default RANGE or
  ROWS frames (incl. framed min/max via a sparse-table range extremum),
  numeric/date/STRING ORDER BY (strings order-encode as ranks among the
  sorted uniques), numeric arguments — anything else stays on the
  vectorized CPU path (``exec/window.py``), which remains the oracle;
* ORDER-preserving integer key encoding: every ORDER BY key becomes a
  null-rank flag plus an i64 key whose SIGNED order equals the SQL order
  (x32: an (hi, lo) i32 pair in that order; integer sum/avg arguments
  cross as exact 48-bit (hi, lo) f32 pairs, NotLowerable past 2^48);
* PARTITION BY keys ride the group-key encoders (identity / dict codes —
  equality-only, which is all partitioning needs);
* output materialization: bitcast unpack, empty-frame NULL masks, dtype
  casts mirroring the CPU operator.

Unlike the reference, a device, bridge or kernel failure raises: only a
partition under ``ballista.tpu.min_rows``, a ``NotLowerable`` from the
host encoding of this partition's data and (x32) a value past int32 run
on the CPU operator.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import pyarrow as pa
import torch

from ..config import BallistaConfig
from ..exec.operators import ExecutionPlan, Partitioning, TaskContext
from ..exec.window import RANKING, VALUE_FNS, WindowExec, WindowSpec
from . import kernels as K
from .bridge import (
    DeviceStaging,
    arrow_to_numpy,
    make_key_encoder,
    split_u64_i32,
    to_u64_order,
)

_AGG_FNS = {"sum", "avg", "min", "max", "count"}


def _is_string_like(t: pa.DataType) -> bool:
    return (
        pa.types.is_string(t)
        or pa.types.is_large_string(t)
        or (pa.types.is_dictionary(t) and pa.types.is_string(t.value_type))
    )


def _orderable_type(t: pa.DataType) -> bool:
    """Types the device window can ORDER BY (order-encodable)."""
    return (
        pa.types.is_integer(t)
        or pa.types.is_floating(t)
        or pa.types.is_date(t)
        or pa.types.is_boolean(t)
        or pa.types.is_timestamp(t)
        or pa.types.is_decimal(t)
        or _is_string_like(t)
    )


def _arg_type_ok(t: pa.DataType) -> bool:
    """Types a window function argument can ship to the device."""
    return (
        pa.types.is_integer(t)
        or pa.types.is_floating(t)
        or pa.types.is_date(t)
        or pa.types.is_boolean(t)
        or pa.types.is_decimal(t)
    )


# ------------------------------------------------------- key encoding
def _split_u64(u: np.ndarray, mode: str = "x64") -> list:
    """Integer keys whose SIGNED order equals the unsigned order of ``u``:
    one i64 (x64) or an (hi, lo) i32 pair (x32), as the reference's."""
    if mode == "x64":
        return [(u ^ (np.uint64(1) << np.uint64(63))).view(np.int64)]
    return list(split_u64_i32(u))


def _string_order_ranks(arr: pa.Array):
    """(ranks int64, validity) — rank of each string among the SORTED
    unique strings: an order-preserving integer key.  Rank equality is
    string equality, so tie structure (rank/dense_rank peers) is exact.
    ``pc.sort_indices`` does the ordering — the same collation the CPU
    window operator sorts with, so the two paths cannot disagree."""
    import pyarrow.compute as pc

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    denc = arr.dictionary_encode() if not pa.types.is_dictionary(
        arr.type
    ) else arr
    d = denc.dictionary
    codes = denc.indices
    if len(d) == 0:  # every row is NULL: one rank, all rows invalid
        return (
            np.zeros(len(arr), dtype=np.int64),
            np.zeros(len(arr), dtype=bool),
        )
    code_vals = np.asarray(codes.fill_null(0), dtype=np.int64)
    validity = (
        np.asarray(pc.is_valid(codes)) if codes.null_count else None
    )
    if d.null_count:
        # pre-encoded dictionaries (e.g. from Parquet) may hold a null
        # SLOT: a valid index pointing at it is still a NULL row
        slot_valid = np.asarray(pc.is_valid(d))[code_vals]
        validity = (
            slot_valid if validity is None else validity & slot_valid
        )
    sort_idx = np.asarray(pc.sort_indices(d), dtype=np.int64)
    rank_of = np.empty(len(d), dtype=np.int64)
    rank_of[sort_idx] = np.arange(len(d), dtype=np.int64)
    return rank_of[code_vals], validity


def _order_keys(arr: pa.Array, asc: bool, nulls_first: Optional[bool],
                mode: str = "x64") -> list:
    """[null_rank, key] integer arrays for one ORDER BY expression."""
    if nulls_first is None:
        nulls_first = not asc  # SQL default: NULLS LAST for ASC
    t = arr.type
    if not _orderable_type(t):
        raise K.NotLowerable(f"window ORDER BY type {t}")
    if pa.types.is_decimal(t):
        import pyarrow.compute as pc

        arr = pc.cast(arr, pa.float64())
    if pa.types.is_boolean(t):
        import pyarrow.compute as pc

        arr = pc.cast(arr, pa.int32())
    if _is_string_like(t):
        values, validity = _string_order_ranks(arr)
    else:
        values, validity = arrow_to_numpy(arr)
    u = to_u64_order(values)
    if not asc:
        u = ~u
    if validity is None:
        null_rank = np.zeros(len(values), dtype=np.int32)
    else:
        is_null = ~validity
        null_rank = np.where(is_null, 0 if nulls_first else 1,
                             1 if nulls_first else 0).astype(np.int32)
        u = np.where(is_null, np.uint64(0), u)  # nulls are peers
    return [null_rank] + _split_u64(u, mode)


def _partition_codes(t: pa.DataType, arr: pa.Array) -> np.ndarray:
    """Equality codes of one PARTITION BY key (the group-key encoders).
    Keys those encoders cannot code (integer magnitudes past 61 bits, a
    float key holding the reserved null payload) are NotLowerable."""
    from ..errors import ExecutionError
    from .groups import RadixOverflow

    try:
        return make_key_encoder(t).encode(arr)
    except (RadixOverflow, ExecutionError) as e:
        raise K.NotLowerable(f"PARTITION BY key: {e}") from e


class TorchWindowExec(ExecutionPlan):
    """WindowExec evaluated on one torch device.  A partition under
    ``tpu.min_rows``, or one whose data the host encoding cannot lower,
    runs on the CPU operator (no source re-scan — windows buffer their
    input anyway); device failures raise."""

    def __init__(self, original: WindowExec, config: BallistaConfig, device):
        super().__init__()
        self.original = original
        self.input = original.input
        self.config = config
        self.device = torch.device(device)
        # group specs by window signature (like the CPU operator): one
        # kernel invocation per distinct (PARTITION BY, ORDER BY)
        self._groups: dict = {}
        schema = original.input.schema
        for pos, spec in enumerate(original.specs):
            self._check_spec(spec)
            for e, _a, _nf in spec.order_by:
                t = K._infer_pa_type(e, schema)
                if not _orderable_type(t):
                    raise K.NotLowerable(f"window ORDER BY type {t}")
            if spec.arg is not None:
                t = K._infer_pa_type(spec.arg, schema)
                if not _arg_type_ok(t):
                    raise K.NotLowerable(f"window argument type {t}")
            sig = (
                tuple(str(p) for p in spec.partition_by),
                tuple((str(e), a, nf) for e, a, nf in spec.order_by),
            )
            self._groups.setdefault(sig, []).append((pos, spec))
        # the dtype mode is pinned when the node is built, as for stages
        self._mode = K.precision_mode()

    def _check_spec(self, spec: WindowSpec) -> None:
        if spec.frame is not None and spec.func not in (
            "sum", "count", "avg", "min", "max",
        ):
            raise K.NotLowerable(f"window ROWS frame for {spec.func}")
        if spec.func == "ntile" and spec.offset < 1:
            raise K.NotLowerable(f"ntile({spec.offset})")
        if spec.func in RANKING:
            return
        if spec.func in VALUE_FNS:
            if spec.offset < 0:
                raise K.NotLowerable("negative lag/lead offset")
            return
        if spec.func not in _AGG_FNS:
            raise K.NotLowerable(f"window fn {spec.func}")
        if spec.arg is None and spec.func != "count":
            raise K.NotLowerable(f"window {spec.func} without argument")

    # ------------------------------------------------------------- plan
    @property
    def schema(self) -> pa.Schema:
        return self.original.schema

    def output_partitioning(self) -> Partitioning:
        return self.original.output_partitioning()

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def with_new_children(self, children):
        new_original = self.original.with_new_children(children)
        try:
            return TorchWindowExec(new_original, self.config, self.device)
        except K.NotLowerable:
            return new_original

    def __str__(self) -> str:
        return "TorchWindowExec: " + ", ".join(
            f"{s.func}->{s.name}" for s in self.original.specs
        ) + f", device={self.device}"

    # ---------------------------------------------------------- execute
    def execute(
        self, partition: int, ctx: TaskContext
    ) -> Iterator[pa.RecordBatch]:
        batches = list(self.input.execute(partition, ctx))
        if not batches:
            return
        n = sum(b.num_rows for b in batches)
        if n == 0 or n < self.config.tpu_min_rows:
            yield from self._cpu(batches, partition, ctx)
            return
        try:
            with self.metrics.timer("window_time_ns"):
                win_cols = self._device_eval(batches, n)
        except (K.NotLowerable, K.X32RangeError):
            # this partition's data has no device encoding (x32: a value
            # past int32); bridge, build and kernel errors are not caught
            self.metrics.add("tpu_fallback", 1)
            yield from self._cpu(batches, partition, ctx)
            return
        table = pa.Table.from_batches(batches, schema=self.input.schema)
        out = table
        for spec, col in zip(self.original.specs, win_cols):
            out = out.append_column(pa.field(spec.name, spec.out_type), col)
        self.metrics.add("output_rows", out.num_rows)
        self.metrics.add("tpu_window", 1)
        for b in out.to_batches(max_chunksize=ctx.batch_size):
            yield b

    def _cpu(self, batches, partition, ctx):
        from .stage_compiler import _BufferedExec

        cpu = self.original.with_new_children(
            [_BufferedExec(self.input, batches)]
        )
        cpu.metrics = self.metrics
        yield from cpu.execute(partition, ctx)

    # ------------------------------------------------------ device eval
    def _device_eval(self, batches, n: int) -> list:
        from .window_kernel import make_window_kernel

        def eval_col(e):
            parts = []
            for b in batches:
                v = e.evaluate(b)
                if isinstance(v, pa.Scalar):
                    v = pa.array([v.as_py()] * b.num_rows, type=v.type)
                parts.append(v)
            arr = (
                pa.chunked_array(parts).combine_chunks()
                if len(parts) > 1
                else parts[0]
            )
            return arr

        n_pad = K.bucket_rows(n)
        is_pad = np.zeros(n_pad, dtype=np.int32)
        is_pad[n:] = 1
        staging = DeviceStaging(self.device)

        win_cols: list = [None] * len(self.original.specs)
        for sig, members in self._groups.items():
            spec0 = members[0][1]
            # ---- keys
            part_keys: list = [is_pad]
            for p in spec0.partition_by:
                codes = _partition_codes(
                    K._infer_pa_type(p, self.input.schema), eval_col(p)
                )
                u = to_u64_order(codes.astype(np.int64))
                part_keys.extend(K._pad(k, n_pad) for k in _split_u64(u, self._mode))
            order_keys: list = []
            for e, asc, nf in spec0.order_by:
                for k in _order_keys(eval_col(e), asc, nf, self._mode):
                    order_keys.append(K._pad(k, n_pad))

            # ---- args (deduped per expression)
            slot_of: dict = {}
            args: list = []
            kspecs: list = []
            for _pos, spec in members:
                kspecs.append(self._kernel_spec(spec, slot_of, args,
                                                eval_col, n_pad))
            kernel = make_window_kernel(
                tuple(kspecs), len(part_keys), len(order_keys), len(args), self._mode
            )
            host = {f"k{i}": k for i, k in enumerate(part_keys + order_keys)}
            for i, (v, m) in enumerate(args):
                if isinstance(v, tuple):  # an x32 pair slot
                    host[f"v{i}h"], host[f"v{i}l"] = v
                else:
                    host[f"v{i}"] = v
                host[f"m{i}"] = m
            dev = staging.put(host)
            keys = [dev[f"k{i}"] for i in range(len(part_keys) + len(order_keys))]
            packed = kernel(
                keys[: len(part_keys)], keys[len(part_keys):],
                [((dev[f"v{i}h"], dev[f"v{i}l"]) if isinstance(v, tuple) else dev[f"v{i}"],
                  dev[f"m{i}"]) for i, (v, _m) in enumerate(args)],
            )
            host_packed = packed.cpu().numpy()
            del dev, keys, packed  # free the signature's device arrays
            self._unpack(host_packed, members, kspecs, n, win_cols)
        return win_cols

    def _kernel_spec(self, spec, slot_of, args, eval_col, n_pad):
        if spec.func == "ntile":
            return ("ntile", spec.offset)
        if spec.func in RANKING:
            return (spec.func,)
        if spec.func == "count" and spec.arg is None:
            if spec.frame is not None:
                return ("aggf", "count", None, spec.frame[0], spec.frame[1])
            return ("agg", "count", None)
        key = str(spec.arg)
        if (
            self._mode == "x32"
            and spec.func in ("sum", "avg")
            and pa.types.is_integer(K._infer_pa_type(spec.arg, self.input.schema))
        ):
            # x32 integer sum/avg: an f32 cast loses the low bits past
            # 2^24, so the argument crosses as an exact (hi, lo) f32 pair
            # (the aggregate's 48-bit pair discipline)
            pkey = (key, "pair")
            slot = slot_of.get(pkey)
            if slot is None:
                values, validity = arrow_to_numpy(eval_col(spec.arg))
                v = values.astype(np.float64)
                if len(v) and np.abs(v).max() >= float(1 << 48):
                    raise K.NotLowerable("int window sum exceeds 48-bit pair range in x32")
                hi = v.astype(np.float32)
                lo = (v - hi.astype(np.float64)).astype(np.float32)
                slot = len(args)
                args.append(((K._pad(hi, n_pad), K._pad(lo, n_pad)),
                             None if validity is None else K._pad(validity, n_pad)))
                slot_of[pkey] = slot
            if spec.frame is not None:
                return ("aggf", spec.func, slot, spec.frame[0], spec.frame[1])
            return ("agg", spec.func, slot)
        # plain argument slot (value + validity or None), padded & coerced
        slot = slot_of.get(key)
        if slot is None:
            arr = eval_col(spec.arg)
            t = arr.type
            if not _arg_type_ok(t):
                raise K.NotLowerable(f"window argument type {t}")
            if pa.types.is_decimal(t) or pa.types.is_boolean(t):
                import pyarrow.compute as pc

                arr = pc.cast(arr, pa.float64())
            values, validity = arrow_to_numpy(arr)
            values = K.coerce_host_values(values, self._mode)
            slot = len(args)
            args.append(
                (
                    K._pad(values, n_pad),
                    None if validity is None else K._pad(validity, n_pad),
                )
            )
            slot_of[key] = slot
        if spec.func in VALUE_FNS:
            return ("val", spec.func, slot, spec.offset)
        if spec.frame is not None:
            return ("aggf", spec.func, slot, spec.frame[0], spec.frame[1])
        return ("agg", spec.func, slot)

    # -------------------------------------------------------- unpack
    def _unpack(self, packed, members, kspecs, n, win_cols) -> None:
        x32 = self._mode == "x32"
        ri = 0

        def int_row():
            nonlocal ri
            r = packed[ri][:n]
            ri += 1
            return r

        def float_row():
            nonlocal ri
            r = packed[ri][:n].view(np.float32 if x32 else np.float64).astype(np.float64)
            ri += 1
            return r

        def sum_row():
            """A sum's row: x32's double-float total is two rows, hi + lo."""
            return float_row() + float_row() if x32 else float_row()

        for (pos, spec), kspec in zip(members, kspecs):
            kind = kspec[0]
            if kind in ("row_number", "rank", "dense_rank", "ntile"):
                col = pa.array(int_row().astype(np.int64), pa.int64())
            elif kind == "agg":
                fn = kspec[1]
                if fn == "count":
                    col = pa.array(int_row().astype(np.int64), pa.int64())
                elif fn in ("sum", "avg"):
                    v = sum_row()
                    cnt = int_row()
                    empty = cnt == 0
                    if fn == "avg":
                        denom = np.where(empty, 1, cnt)
                        col = pa.array(v / denom, pa.float64(), mask=empty)
                    elif pa.types.is_integer(spec.out_type):
                        vi = np.round(
                            np.where(np.isfinite(v), v, 0.0)
                        ).astype(np.int64)
                        col = pa.array(vi, pa.int64(), mask=empty)
                    else:
                        col = pa.array(v, pa.float64(), mask=empty)
                else:  # min / max
                    if pa.types.is_integer(spec.out_type) or pa.types.is_date(
                        spec.out_type
                    ):
                        v = int_row().astype(np.int64)
                        cnt = int_row()
                        empty = cnt == 0
                        col = pa.array(
                            np.where(empty, 0, v), pa.int64(), mask=empty
                        )
                    else:
                        v = float_row()
                        cnt = int_row()
                        empty = cnt == 0
                        col = pa.array(
                            np.where(empty, 0.0, v), pa.float64(),
                            mask=empty,
                        )
            elif kind == "aggf":
                fn = kspec[1]
                if kspec[2] is None or fn == "count":
                    col = pa.array(int_row().astype(np.int64), pa.int64())
                elif fn in ("min", "max"):
                    if pa.types.is_integer(spec.out_type) or pa.types.is_date(
                        spec.out_type
                    ):
                        v = int_row().astype(np.int64)
                        empty = int_row() == 0
                        col = pa.array(
                            np.where(empty, 0, v), pa.int64(), mask=empty
                        )
                    else:
                        v = float_row()
                        empty = int_row() == 0
                        col = pa.array(
                            np.where(empty, 0.0, v), pa.float64(),
                            mask=empty,
                        )
                else:
                    hi_v = sum_row()
                    lo_v = sum_row()
                    cnt = int_row()
                    v = hi_v - lo_v
                    emptym = cnt == 0
                    if fn == "avg":
                        col = pa.array(
                            v / np.where(emptym, 1, cnt), pa.float64(),
                            mask=emptym,
                        )
                    elif pa.types.is_integer(spec.out_type):
                        vi = np.round(
                            np.where(np.isfinite(v), v, 0.0)
                        ).astype(np.int64)
                        col = pa.array(vi, pa.int64(), mask=emptym)
                    else:
                        col = pa.array(v, pa.float64(), mask=emptym)
            else:  # val fns
                int_arg = pa.types.is_integer(spec.out_type) or (
                    pa.types.is_date(spec.out_type)
                )
                v = (
                    int_row().astype(np.int64)
                    if int_arg
                    else float_row()
                )
                ok = int_row() != 0
                col = pa.array(
                    np.where(ok, v, 0),
                    pa.int64() if int_arg else pa.float64(),
                    mask=~ok,
                )
            if not col.type.equals(spec.out_type):
                import pyarrow.compute as pc

                col = pc.cast(col, spec.out_type, safe=False)
            win_cols[pos] = col
