"""Arrow ⇄ bytes helpers for the wire format.

Schemas, data types and literal values travel as Arrow IPC bytes — exact
round-tripping without re-modelling the Arrow type system in protobuf.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import pyarrow as pa


def schema_to_bytes(schema: pa.Schema) -> bytes:
    return schema.serialize().to_pybytes()


def schema_from_bytes(b: bytes) -> pa.Schema:
    return pa.ipc.read_schema(pa.py_buffer(b))


def dtype_to_bytes(dtype: pa.DataType) -> bytes:
    return schema_to_bytes(pa.schema([pa.field("t", dtype)]))


def dtype_from_bytes(b: bytes) -> pa.DataType:
    return schema_from_bytes(b).field(0).type


def value_to_ipc(value: Any, dtype: Optional[pa.DataType] = None) -> bytes:
    """Encode one value (+ its exact type) as a single-row IPC stream."""
    arr = pa.array([value], type=dtype)
    batch = pa.record_batch([arr], names=["v"])
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, batch.schema) as w:
        w.write_batch(batch)
    return sink.getvalue().to_pybytes()


def value_from_ipc(b: bytes) -> Tuple[Any, pa.DataType]:
    with pa.ipc.open_stream(pa.py_buffer(b)) as r:
        batch = r.read_next_batch()
    col = batch.column(0)
    return col[0].as_py(), col.type


def array_to_ipc(values, dtype: Optional[pa.DataType] = None) -> bytes:
    arr = pa.array(list(values), type=dtype)
    batch = pa.record_batch([arr], names=["v"])
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, batch.schema) as w:
        w.write_batch(batch)
    return sink.getvalue().to_pybytes()


def array_from_ipc(b: bytes) -> pa.Array:
    with pa.ipc.open_stream(pa.py_buffer(b)) as r:
        batch = r.read_next_batch()
    return batch.column(0)


def table_to_ipc(table: pa.Table) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()


def table_from_ipc(b: bytes) -> pa.Table:
    with pa.ipc.open_stream(pa.py_buffer(b)) as r:
        return r.read_all()
