"""Arrow ⇄ device (HBM) column bridge.

The reference keeps data in Arrow RecordBatches end-to-end; the TPU path
(BASELINE.json north star) moves columns across an Arrow → numpy → jax
bridge into HBM.  Design rules, per the TPU memory model:

* numeric / date columns transfer zero-copy where Arrow's buffer layout
  allows (no nulls → plain numpy view);
* validity bitmaps become separate float/bool masks — downstream kernels
  use masking, never compaction, so shapes stay static for XLA;
* strings never cross to the device raw: they are dictionary-encoded on
  host and only the int32 codes transfer (group keys / comparisons work on
  codes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..errors import ExecutionError


def _is_device_friendly(t: pa.DataType) -> bool:
    return (
        pa.types.is_integer(t)
        or pa.types.is_floating(t)
        or pa.types.is_boolean(t)
        or pa.types.is_date(t)
        or pa.types.is_timestamp(t)
    )


def arrow_to_numpy(arr: pa.Array) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Arrow array → (values ndarray, validity bool ndarray or None).

    Nulls are filled with 0 in the value buffer; the validity mask carries
    the null information to the device.
    """
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = arr.type
    validity = None
    if arr.null_count:
        validity = np.asarray(pc.is_valid(arr))
        arr = arr.fill_null(_zero_for(t))
    if pa.types.is_date32(t):
        values = np.asarray(arr.cast(pa.int32()))
    elif pa.types.is_date64(t) or pa.types.is_timestamp(t):
        values = np.asarray(arr.cast(pa.int64()))
    elif pa.types.is_boolean(t):
        values = np.asarray(arr)
    elif _is_device_friendly(t):
        values = np.asarray(arr)
    else:
        raise ExecutionError(f"type {t} cannot cross the device bridge directly")
    return values, validity


def _zero_for(t: pa.DataType):
    if pa.types.is_date32(t):
        import datetime

        return datetime.date(1970, 1, 1)
    if pa.types.is_timestamp(t):
        import datetime

        return datetime.datetime(1970, 1, 1)
    if pa.types.is_boolean(t):
        return False
    if pa.types.is_floating(t):
        return 0.0
    return 0


def to_u64_order(values: np.ndarray) -> np.ndarray:
    """uint64 whose unsigned order equals the values' natural order
    (IEEE-754 sign-flip trick for floats, bias flip for ints)."""
    if values.dtype.kind == "f":
        v = values.astype(np.float64)
        bits = v.view(np.uint64)
        neg = (bits >> np.uint64(63)) == 1
        mask = np.where(
            neg,
            np.uint64(0xFFFFFFFFFFFFFFFF),
            np.uint64(1) << np.uint64(63),
        )
        return bits ^ mask
    return values.astype(np.int64).view(np.uint64) ^ (
        np.uint64(1) << np.uint64(63)
    )


def split_u64_i32(u: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(hi, lo) i32 pair whose LEXICOGRAPHIC signed order equals the
    unsigned order of ``u`` — 64-bit order relations on a device without
    64-bit dtypes (sort keys, exact f64 min/max in x32 mode)."""
    hi = ((u >> np.uint64(32)).astype(np.int64) - (1 << 31)).astype(np.int32)
    lo = ((u & np.uint64(0xFFFFFFFF)).astype(np.int64) - (1 << 31)).astype(
        np.int32
    )
    return hi, lo


def join_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Inverse of ``split_u64_i32``: biased (hi, lo) i32 pair → u64
    whose unsigned order equals the pair's lexicographic signed order.
    MUST stay in uint64 — packing in int64 wraps negative for every
    biased hi >= 2^31 (all non-negative values), inverting the order."""
    return (
        ((hi.astype(np.int64) + (1 << 31)).astype(np.uint64) << np.uint64(32))
        | (lo.astype(np.int64) + (1 << 31)).astype(np.uint64)
    )


def order_decode_f64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Inverse of ``to_u64_order`` + ``split_u64_i32`` for f64 values."""
    u = join_u64(hi, lo)
    neg = (u >> np.uint64(63)) == 0  # sign bit was flipped on encode
    mask = np.where(
        neg, np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64(1) << np.uint64(63)
    )
    return (u ^ mask).view(np.float64)


@dataclass
class DictEncoder:
    """Stable host-side dictionary encoder shared across batches.

    Per-batch ``dictionary_encode`` yields batch-local codes; group keys
    must agree across every batch of a stage (and across partitions when
    the codes feed a device segment-sum), so this encoder owns the global
    value → code map: an ARROW array whose position IS the code, probed
    with ``pc.index_in`` (C++ hash).  The round-3 design round-tripped
    every batch's local dictionary through Python objects — seconds per
    batch at h2o id3 scale (~1e6 distinct strings); no Python value ever
    materializes here.  NULL keys get a real (null) slot in the array, so
    ``decode`` is a single ``take``.
    """

    _dict: Optional[pa.Array] = None  # position == code; may hold 1 null

    def encode(self, arr: pa.Array) -> np.ndarray:
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        enc = arr.dictionary_encode()
        local = enc.dictionary  # distinct NON-NULL values, arrow-native
        n_local = len(local)
        if self._dict is not None and not self._dict.type.equals(local.type):
            local = local.cast(self._dict.type)
        if self._dict is None or len(self._dict) == 0:
            got_np = np.full(n_local, -1, dtype=np.int64)
        else:
            got = pc.index_in(local, value_set=self._dict)
            got_np = np.asarray(got.fill_null(-1)).astype(np.int64)
        mapping = got_np
        miss = mapping < 0
        n_miss = int(miss.sum())
        if n_miss:
            new_vals = local.filter(pa.array(miss))
            base = len(self._dict) if self._dict is not None else 0
            self._dict = (
                pa.concat_arrays([self._dict, new_vals])
                if self._dict is not None
                else new_vals
            )
            mapping = mapping.copy()
            mapping[miss] = base + np.arange(n_miss)
        idx = enc.indices
        has_null = idx.null_count > 0 or arr.null_count > 0
        codes = np.asarray(idx.fill_null(0))
        out = mapping[codes] if n_local else np.zeros(len(arr), np.int64)
        if has_null:
            out = np.where(
                np.asarray(pc.is_null(arr)), self._null_code(local.type), out
            )
        return out.astype(np.int32)

    def _null_code(self, t: pa.DataType) -> int:
        """Code of the NULL key: a real null slot in the value array, so
        decode's take materializes it as null with no special case."""
        if self._dict is not None:
            nulls = np.asarray(pc.is_null(self._dict))
            hit = np.nonzero(nulls)[0]
            if len(hit):
                return int(hit[0])
        code = len(self._dict) if self._dict is not None else 0
        null1 = pa.nulls(1, self._dict.type if self._dict is not None else t)
        self._dict = (
            pa.concat_arrays([self._dict, null1])
            if self._dict is not None
            else null1
        )
        return code

    @property
    def size(self) -> int:
        return len(self._dict) if self._dict is not None else 0

    def to_arrow(self, dtype: pa.DataType) -> pa.Array:
        if self._dict is None:
            return pa.nulls(0, dtype)
        return (
            self._dict
            if self._dict.type.equals(dtype)
            else self._dict.cast(dtype)
        )

    def decode(
        self, codes: np.ndarray, t: pa.DataType,
        mask: Optional[np.ndarray] = None,
    ) -> pa.Array:
        """codes → original values (one arrow ``take``); ``mask`` marks
        null rows (their codes may be garbage)."""
        if self._dict is None or len(self._dict) == 0:
            return pa.nulls(len(codes), t)
        safe = np.where(mask, 0, codes) if mask is not None else codes
        vals = self._dict.take(pa.array(safe.astype(np.int64)))
        if not vals.type.equals(t):
            vals = vals.cast(t)
        if mask is not None and mask.any():
            vals = pc.if_else(pa.array(mask), pa.scalar(None, t), vals)
        return vals


class IdentityKeyEncoder:
    """Group-key encoder for int/date32 columns: the code is the value's
    zigzag image, 2v+1 for v >= 0 and -2v for v < 0 (code 0 is the NULL
    key, so nullable key columns stay on device).

    Dictionary-hashing numeric keys costs a Python mapping loop per
    distinct value (2.8s of q3 SF10's stage time in round 3's first cut);
    identity codes cost one astype.  Negative keys and pre-1970 dates
    encode like any other.  A key of magnitude 2^61 or more needs a code
    wider than the group table's 62 bits and raises ``RadixOverflow``,
    which the stage counts as a capacity fallback.
    """

    _LIMIT = 1 << 61

    def encode(self, arr) -> np.ndarray:
        from .groups import RadixOverflow

        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        values, validity = arrow_to_numpy(arr)
        if len(values) and (
            values.max() >= self._LIMIT or values.min() <= -self._LIMIT
        ):
            raise RadixOverflow("group key magnitude needs more than 62 bits")
        v = values.astype(np.int64)
        codes = np.where(v >= 0, 2 * v + 1, -2 * v)
        if validity is not None:
            codes = np.where(validity, codes, 0)
        return codes

    def decode(self, codes: np.ndarray, t: pa.DataType) -> pa.Array:
        mask = codes == 0
        vals = np.where(codes & 1 == 1, codes >> 1, -(codes >> 1))
        vals = np.where(mask, 0, vals)
        if pa.types.is_date32(t):
            return pa.array(vals.astype("datetime64[D]"), t, mask=mask)
        return pa.array(vals, t, mask=mask)


class BoolKeyEncoder:
    """Group-key encoder for bool columns: null → 0, False → 1, True → 2.

    Identity-style (one astype, no dictionary hashing) and pure in the
    VALUE, so the device twin (``kernels.device_encode_key("bool", …)``)
    produces bit-identical codes and bool keys ride the fused keyed
    path."""

    def encode(self, arr) -> np.ndarray:
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        values, validity = arrow_to_numpy(arr)
        codes = values.astype(np.int64) + 1
        if validity is not None:
            codes = np.where(validity, codes, 0)
        return codes

    def decode(self, codes: np.ndarray, t: pa.DataType) -> pa.Array:
        mask = codes == 0
        return pa.array(np.maximum(codes - 1, 0).astype(bool), t, mask=mask)


class FloatKeyEncoder:
    """Group-key encoder for float columns: the code IS the raw bit
    pattern (f32 → i32 bits, f64 → i64 bits).  Pure bit-pattern
    grouping matches the CPU hash aggregate exactly — its
    ``dictionary_encode`` distinguishes ``-0.0`` from ``+0.0`` and NaN
    payloads from each other (measured), and the CPU-vs-TPU identity
    contract follows the engine, not IEEE equality.  NULL takes ONE
    reserved NaN pattern; data that contains that exact payload raises
    ``ExecutionError`` (→ host-route fallback), the same escape hatch
    the identity encoder uses for negative keys.  Pure in the value (no
    dictionary state), so the device twin produces bit-identical codes;
    codes can be negative, which the keyed sort handles but
    ``GroupTable`` radix-combining does not — the gid route keeps its
    dictionary encoder for floats, this encoder exists for the
    device-encoded keyed route."""

    def __init__(self, kind: str):  # "f32" | "f64"
        self.kind = kind

    def encode(self, arr) -> np.ndarray:
        from . import kernels as K

        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        values, validity = arrow_to_numpy(arr)
        if self.kind == "f32":
            v = values.astype(np.float32)
            bits = v.view(np.int32).astype(np.int64)
            null = K.FLOAT32_NULL_BITS
        else:
            v = values.astype(np.float64)
            bits = v.view(np.int64).copy()
            null = K.FLOAT64_NULL_BITS
        if validity is not None:
            hit = (bits == null) & validity
            bits = np.where(validity, bits, null)
        else:
            hit = bits == null
        if bool(np.any(hit)):
            raise ExecutionError(
                "float group key collides with the reserved null pattern"
            )
        return bits.astype(np.int64)

    def decode(self, codes: np.ndarray, t: pa.DataType) -> pa.Array:
        from . import kernels as K

        if self.kind == "f32":
            mask = codes == K.FLOAT32_NULL_BITS
            vals = (
                np.where(mask, 0, codes).astype(np.int32).view(np.float32)
            )
        else:
            mask = codes == K.FLOAT64_NULL_BITS
            vals = np.where(mask, 0, codes).astype(np.int64).view(np.float64)
        arr = pa.array(vals.astype(np.float64), pa.float64(), mask=mask)
        return arr if arr.type.equals(t) else arr.cast(t)


def make_key_encoder(t: pa.DataType):
    """Identity for int/date32 group keys, bool codes for booleans,
    dictionary otherwise."""
    if pa.types.is_integer(t) or pa.types.is_date32(t):
        return IdentityKeyEncoder()
    if pa.types.is_boolean(t):
        return BoolKeyEncoder()
    return DictEncoder()


def device_key_encoder(t: pa.DataType, mode: str):
    """(encoder, device-kind) for the device-encoded keyed route.

    The kind names a :func:`kernels.device_encode_key` branch whose
    device codes are bit-identical to ``encoder.encode``; ``None`` means
    the key stays on the host dictionary handoff (strings, decimals —
    and f64 in x32 mode, whose 64-bit pattern cannot ship).  Falls back
    to :func:`make_key_encoder` for the ``None`` kinds so decode
    behavior matches the host route exactly."""
    if pa.types.is_integer(t) or pa.types.is_date32(t):
        return IdentityKeyEncoder(), "ident"
    if pa.types.is_boolean(t):
        return BoolKeyEncoder(), "bool"
    if pa.types.is_float32(t):
        return FloatKeyEncoder("f32"), "f32"
    if pa.types.is_float64(t) and mode != "x32":
        return FloatKeyEncoder("f64"), "f64"
    return make_key_encoder(t), None


def coalesce_batches(source, target_rows: int, metrics=None):
    """Host-side batch coalescer feeding the device bridge.

    Shuffle readers yield one fragment per map task — with 16 map tasks an
    8192-row batch arrives as ~512-row slivers, and each sliver would pay
    a full key-encode + host→HBM dispatch.  Combine consecutive fragments
    up to ``target_rows`` before they cross the bridge; batches already at
    or above the target pass through untouched (no re-copy of big data).
    Row content and order of the combined stream are unchanged.
    """
    buf: list[pa.RecordBatch] = []
    rows = 0
    for b in source:
        if b.num_rows == 0:
            continue
        if b.num_rows >= target_rows:
            # big batch: flush pending fragments, then pass it through
            # untouched — never fold big data into a concat just to
            # prepend a sliver
            if buf:
                if metrics is not None:
                    metrics.add("coalesced_source_batches", len(buf))
                yield _concat_batches(buf)
                buf, rows = [], 0
            yield b
            continue
        if buf and rows + b.num_rows > target_rows:
            # flush BEFORE appending: an emitted batch never exceeds the
            # target, or it would land in a larger device padding bucket
            # than batch_size and trigger a fresh XLA compile
            if metrics is not None:
                metrics.add("coalesced_source_batches", len(buf))
            yield _concat_batches(buf)
            buf, rows = [], 0
        buf.append(b)
        rows += b.num_rows
        if rows >= target_rows:
            if metrics is not None:
                metrics.add("coalesced_source_batches", len(buf))
            yield _concat_batches(buf)
            buf, rows = [], 0
    if buf:
        if metrics is not None:
            metrics.add("coalesced_source_batches", len(buf))
        yield _concat_batches(buf)


def _concat_batches(parts: list) -> pa.RecordBatch:
    if len(parts) == 1:
        return parts[0]
    tbl = pa.Table.from_batches(parts).combine_chunks()
    batches = tbl.to_batches()
    return batches[0] if batches else parts[0]



class DeviceStaging:
    """Moves one batch's leaf arrays (``kernels.build_env`` output) into
    tensors on the stage's device.

    On a CUDA device each array is copied into a reusable page-locked host
    buffer (sized to ``kernels.bucket_rows`` so batches of similar size
    share it) and then sent with a ``non_blocking`` copy; the next batch
    waits for those copies to finish before it overwrites the buffers.  On
    the CPU the arrays become tensors directly (read-only pyarrow-backed
    arrays are copied first, since torch cannot alias them).  A ``None``
    entry (an all-valid companion) stays ``None``.
    """

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        self._pinned: dict = {}
        self._done = None  # CUDA event recorded after the last copies

    def put(self, env: dict) -> dict:
        import torch

        from . import kernels as K

        out: dict = {}
        if self.device.type != "cuda":
            for name, arr in env.items():
                if arr is None:
                    out[name] = None
                    continue
                if not arr.flags.writeable:
                    arr = arr.copy()
                out[name] = torch.from_numpy(arr).to(self.device)
            return out
        if self._done is not None:
            self._done.synchronize()  # pinned buffers free again
        for name, arr in env.items():
            if arr is None:
                out[name] = None
                continue
            n = len(arr)
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            buf = self._pinned.get(name)
            if buf is None or buf.dtype != dtype or buf.numel() < n:
                buf = torch.empty(
                    K.bucket_rows(n), dtype=dtype, pin_memory=True
                )
                self._pinned[name] = buf
            buf.numpy()[:n] = arr
            out[name] = buf[:n].to(self.device, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record(torch.cuda.current_stream(self.device))
        return out
