"""Avro object-container-file reader (pure python → Arrow).

The reference reads Avro through DataFusion's avro support
(``BallistaContext::read_avro`` / ``register_avro``,
``client/src/context.rs:212-311``).  No Avro library ships in this
environment, so this is a small self-contained decoder for the format's
common subset:

* primitive types: null, boolean, int, long, float, double, bytes, string
* records (flattened to columns), unions of [null, T] (→ nullable column)
* logical types date (int) and timestamp-millis/micros (long)
* codecs: null and deflate (zlib raw)

Avro spec: https://avro.apache.org/docs/current/specification/ — varint
zigzag encoding, file header with JSON schema + 16-byte sync marker,
then blocks of (row count, byte size, data, sync).
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Iterator, Optional

import pyarrow as pa

from .errors import BallistaError

MAGIC = b"Obj\x01"


class AvroError(BallistaError):
    pass


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise AvroError("truncated avro data")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def read_long(self) -> int:
        """Zigzag varint (bounds-checked: a truncated or corrupt file must
        raise AvroError, not IndexError / an unbounded shift loop)."""
        shift = 0
        accum = 0
        while True:
            if self.pos >= len(self.data):
                raise AvroError("truncated avro varint")
            if shift > 63:
                raise AvroError("avro varint exceeds 64 bits")
            b = self.data[self.pos]
            self.pos += 1
            accum |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (accum >> 1) ^ -(accum & 1)

    def read_bytes(self) -> bytes:
        return self.read(self.read_long())

    def at_end(self) -> bool:
        return self.pos >= len(self.data)


def _arrow_type(schema) -> pa.DataType:
    """Avro schema node → Arrow type (nullable handled by caller)."""
    if isinstance(schema, str):
        return {
            "null": pa.null(),
            "boolean": pa.bool_(),
            "int": pa.int32(),
            "long": pa.int64(),
            "float": pa.float32(),
            "double": pa.float64(),
            "bytes": pa.binary(),
            "string": pa.string(),
        }[schema]
    if isinstance(schema, dict):
        t = schema["type"]
        logical = schema.get("logicalType")
        if logical == "date":
            return pa.date32()
        if logical == "timestamp-millis":
            return pa.timestamp("ms")
        if logical == "timestamp-micros":
            return pa.timestamp("us")
        if logical == "time-millis":
            return pa.time32("ms")
        if logical == "decimal":
            return pa.decimal128(schema.get("precision", 38), schema.get("scale", 0))
        return _arrow_type(t)
    raise AvroError(f"unsupported avro schema node {schema!r}")


def _field_schema(schema) -> tuple[pa.DataType, bool, object]:
    """→ (arrow type, nullable, decode-schema) for one record field."""
    if isinstance(schema, list):  # union
        non_null = [s for s in schema if s != "null"]
        if len(non_null) != 1:
            raise AvroError(f"only [null, T] unions supported, got {schema}")
        t, _, dec = _field_schema(non_null[0])
        return t, True, schema
    return _arrow_type(schema), False, schema


def _decode_value(r: _Reader, schema) -> object:
    if isinstance(schema, list):  # union: branch index then value
        idx = r.read_long()
        branch = schema[idx]
        if branch == "null":
            return None
        return _decode_value(r, branch)
    if isinstance(schema, dict):
        logical = schema.get("logicalType")
        base = schema["type"]
        v = _decode_value(r, base)
        # date/timestamp remain ints; Arrow interprets via column type
        _ = logical
        return v
    if schema == "null":
        return None
    if schema == "boolean":
        return r.read(1) != b"\x00"
    if schema in ("int", "long"):
        return r.read_long()
    if schema == "float":
        return struct.unpack("<f", r.read(4))[0]
    if schema == "double":
        return struct.unpack("<d", r.read(8))[0]
    if schema == "bytes":
        return r.read_bytes()
    if schema == "string":
        return r.read_bytes().decode("utf-8")
    raise AvroError(f"unsupported avro type {schema!r}")


class AvroFile:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._raw = f.read()
        r = _Reader(self._raw)
        if r.read(4) != MAGIC:
            raise AvroError(f"{path}: not an avro object container file")
        meta: dict[str, bytes] = {}
        n = r.read_long()
        while n != 0:
            if n < 0:  # negative count: byte size follows
                n = -n
                r.read_long()
            for _ in range(n):
                key = r.read_bytes().decode()
                meta[key] = r.read_bytes()
            n = r.read_long()
        self.codec = meta.get("avro.codec", b"null").decode()
        if self.codec not in ("null", "deflate"):
            raise AvroError(f"unsupported avro codec {self.codec!r}")
        self.avro_schema = json.loads(meta["avro.schema"])
        if self.avro_schema.get("type") != "record":
            raise AvroError("top-level avro schema must be a record")
        self.sync = r.read(16)
        self._body_pos = r.pos

        fields = []
        self._decoders = []
        for f_schema in self.avro_schema["fields"]:
            t, nullable, dec = _field_schema(f_schema["type"])
            fields.append(pa.field(f_schema["name"], t, nullable))
            self._decoders.append(dec)
        self.schema = pa.schema(fields)

    def blocks(self) -> Iterator[tuple[int, bytes]]:
        r = _Reader(self._raw)
        r.pos = self._body_pos
        while not r.at_end():
            count = r.read_long()
            data = r.read_bytes()
            if r.read(16) != self.sync:
                raise AvroError(f"{self.path}: sync marker mismatch")
            if self.codec == "deflate":
                data = zlib.decompress(data, -15)
            yield count, data

    def read_batches(
        self, projection: Optional[list[str]] = None, batch_size: int = 8192
    ) -> Iterator[pa.RecordBatch]:
        names = self.schema.names
        proj_idx = (
            [names.index(p) for p in projection] if projection is not None else None
        )
        out_schema = (
            pa.schema([self.schema.field(i) for i in proj_idx])
            if proj_idx is not None
            else self.schema
        )
        cols: list[list] = [[] for _ in range(len(names))]
        rows = 0

        def flush():
            nonlocal cols, rows
            take = proj_idx if proj_idx is not None else range(len(names))
            arrays = [
                pa.array(cols[i], type=self.schema.field(i).type) for i in take
            ]
            batch = pa.RecordBatch.from_arrays(arrays, schema=out_schema)
            cols = [[] for _ in range(len(names))]
            rows = 0
            return batch

        for count, data in self.blocks():
            r = _Reader(data)
            for _ in range(count):
                for i, dec in enumerate(self._decoders):
                    v = _decode_value(r, dec)
                    cols[i].append(v)
                rows += 1
                if rows >= batch_size:
                    yield flush()
        if rows:
            yield flush()


def write_avro(path: str, table: pa.Table) -> None:
    """Minimal Avro writer (null codec) — test/tooling counterpart so the
    reader can be exercised without an external avro library."""
    import io

    def zigzag(n: int) -> bytes:
        u = (n << 1) ^ (n >> 63)
        out = bytearray()
        while True:
            b = u & 0x7F
            u >>= 7
            if u:
                out.append(b | 0x80)
            else:
                out.append(b)
                return bytes(out)

    def enc_bytes(b: bytes) -> bytes:
        return zigzag(len(b)) + b

    def avro_of(t: pa.DataType):
        if pa.types.is_int32(t):
            return "int"
        if pa.types.is_int64(t):
            return "long"
        if pa.types.is_float32(t):
            return "float"
        if pa.types.is_float64(t):
            return "double"
        if pa.types.is_boolean(t):
            return "boolean"
        if pa.types.is_string(t):
            return "string"
        if pa.types.is_binary(t):
            return "bytes"
        if pa.types.is_date32(t):
            return {"type": "int", "logicalType": "date"}
        if pa.types.is_timestamp(t):
            unit = {"ms": "timestamp-millis", "us": "timestamp-micros"}[t.unit]
            return {"type": "long", "logicalType": unit}
        raise AvroError(f"cannot write arrow type {t} to avro")

    schema = {
        "type": "record",
        "name": "row",
        "fields": [
            {
                "name": f.name,
                "type": ["null", avro_of(f.type)] if f.nullable else avro_of(f.type),
            }
            for f in table.schema
        ],
    }

    def enc_value(v, f: pa.Field) -> bytes:
        t = f.type
        if f.nullable:
            if v is None:
                return zigzag(0)
            prefix = zigzag(1)
        else:
            prefix = b""
        if pa.types.is_boolean(t):
            return prefix + (b"\x01" if v else b"\x00")
        if pa.types.is_integer(t):
            return prefix + zigzag(int(v))
        if pa.types.is_float32(t):
            return prefix + struct.pack("<f", v)
        if pa.types.is_float64(t):
            return prefix + struct.pack("<d", v)
        if pa.types.is_string(t):
            return prefix + enc_bytes(v.encode())
        if pa.types.is_binary(t):
            return prefix + enc_bytes(v)
        if pa.types.is_date32(t):
            import datetime

            return prefix + zigzag((v - datetime.date(1970, 1, 1)).days)
        if pa.types.is_timestamp(t):
            import datetime

            epoch = datetime.datetime(1970, 1, 1)
            delta = v - epoch
            us = int(delta.total_seconds() * 1_000_000)
            return prefix + zigzag(us if t.unit == "us" else us // 1000)
        raise AvroError(f"cannot encode {t}")

    body = io.BytesIO()
    pylists = [c.to_pylist() for c in table.columns]
    for row in range(table.num_rows):
        for i, f in enumerate(table.schema):
            body.write(enc_value(pylists[i][row], f))
    data = body.getvalue()

    sync = b"0123456789abcdef"
    with open(path, "wb") as f:
        f.write(MAGIC)
        meta = {
            "avro.schema": json.dumps(schema).encode(),
            "avro.codec": b"null",
        }
        f.write(zigzag(len(meta)))
        for k, v in meta.items():
            f.write(enc_bytes(k.encode()))
            f.write(enc_bytes(v))
        f.write(zigzag(0))
        f.write(sync)
        if table.num_rows:
            f.write(zigzag(table.num_rows))
            f.write(zigzag(len(data)))
            f.write(data)
            f.write(sync)
