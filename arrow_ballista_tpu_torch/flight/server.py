"""Executor-side Arrow Flight service serving shuffle partitions.

Counterpart of the reference's ``executor/src/flight_service.rs``: DoGet
only — the ticket is a protobuf ``FetchPartitionTicket`` whose ``path``
points at an Arrow IPC file under this executor's work_dir; the file is
streamed schema-first then batch-by-batch.  All other Flight methods are
unimplemented, exactly like the reference.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import pyarrow as pa
import pyarrow.flight as flight

from ..obs import trace
from ..proto import pb


class _TraceMiddleware(flight.ServerMiddleware):
    """Carries the caller's trace context for the duration of one call."""

    def __init__(self, trace_id: str, parent_span_id: str):
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id


def _header_value(headers, key: str) -> str:
    vals = headers.get(key) or headers.get(key.encode(), ())
    for v in vals:
        return v.decode() if isinstance(v, bytes) else v
    return ""


class _TraceMiddlewareFactory(flight.ServerMiddlewareFactory):
    def start_call(self, info, headers):
        tid = _header_value(headers, trace.TRACE_HEADER.decode())
        if not tid:
            return None
        return _TraceMiddleware(
            tid, _header_value(headers, trace.PARENT_HEADER.decode())
        )


class ShuffleFlightService(flight.FlightServerBase):
    def __init__(self, work_dir: str, host: str = "0.0.0.0", port: int = 0):
        location = f"grpc://{host}:{port}"
        super().__init__(
            location, middleware={"trace": _TraceMiddlewareFactory()}
        )
        self.work_dir = os.path.abspath(work_dir)

    @staticmethod
    def _trace_ctx(context) -> tuple:
        """(trace_id, parent_span_id) from call metadata, or ("", "")."""
        try:
            mw = context.get_middleware("trace")
        except Exception:  # noqa: BLE001 - tracing never fails a fetch
            mw = None
        if mw is None:
            return "", ""
        return mw.trace_id, mw.parent_span_id

    @staticmethod
    def _traced_stream(batches, trace_id: str, parent: str, path: str):
        """Wrap a batch stream so the serving window is one span in the
        CALLER's trace (closed when the stream drains or breaks).
        Items may be bare RecordBatches or ``(batch, app_metadata)``
        tuples (the multi-partition stream tags each batch with its
        partition index)."""
        t0_unix, t0_mono = time.time_ns(), time.monotonic_ns()
        nbytes = 0
        error = ""
        try:
            for b in batches:
                data = b[0] if isinstance(b, tuple) else b
                nbytes += int(getattr(data, "nbytes", 0) or 0)
                yield b
        except BaseException as e:
            error = f"{type(e).__name__}: {e}"
            raise
        finally:
            attrs = {"path": path, "bytes": nbytes}
            if error:
                attrs["error"] = error
            trace.record_raw(
                "flight.do_get",
                trace_id,
                trace.new_id(),
                parent or trace_id,
                t0_unix,
                time.monotonic_ns() - t0_mono,
                **attrs,
            )

    # ------------------------------------------------------------ sources
    def _open_file_reader(self, raw_path: str):
        """(mmap source, IPC file reader) for one on-disk partition —
        path-validated against the work dir, memory-mapped so served
        batches are zero-copy views of the page cache (Zerrow property:
        the Arrow data plane never copies on the serving side); OSFile
        fallback for filesystems without mmap."""
        path = os.path.abspath(raw_path)
        # only serve files inside the work dir (the ticket's path originates
        # from this executor's own shuffle-write stats, but never trust it)
        if not path.startswith(self.work_dir + os.sep):
            raise flight.FlightServerError(f"path {path!r} outside work dir")
        if not os.path.exists(path):
            raise flight.FlightServerError(f"no such partition file {path!r}")
        try:
            source = pa.memory_map(path, "rb")
        except Exception:
            source = pa.OSFile(path, "rb")
        try:
            reader = pa.ipc.open_file(source)
        except Exception as e:
            # truncated/corrupt partition file: close the handle before
            # raising, or every reduce-side retry leaks an mmap/fd here
            source.close()
            raise flight.FlightServerError(
                f"unreadable partition file {path!r}: {e}"
            )
        return source, reader

    @staticmethod
    def _mem_buffer(path: str):
        """The already-serialized IPC stream buffer of one memory-store
        partition: the slab writer's bytes go to the wire as zero-copy
        views, never re-materialized as a batch list first."""
        from ..shuffle import memory_store

        buf = memory_store.get_buffer(path)
        if buf is None:
            raise flight.FlightServerError(
                f"no such memory partition {path!r}"
            )
        return buf

    def _source_schema(self, path: str) -> pa.Schema:
        from ..shuffle import memory_store

        if path.startswith(memory_store.SCHEME):
            with pa.ipc.open_stream(self._mem_buffer(path)) as r:
                return r.schema
        source, reader = self._open_file_reader(path)
        try:
            return reader.schema
        finally:
            source.close()

    def _iter_source(self, path: str):
        """Lazily stream one partition's batches (mem buffer or mmap)."""
        from ..shuffle import memory_store

        if path.startswith(memory_store.SCHEME):
            with pa.ipc.open_stream(self._mem_buffer(path)) as r:
                yield from r
            return
        source, reader = self._open_file_reader(path)
        try:
            for i in range(reader.num_record_batches):
                yield reader.get_batch(i)
        finally:
            source.close()

    # -------------------------------------------------------------- serve
    def do_get(self, context, ticket: flight.Ticket):
        msg = pb.FetchPartitionTicket()
        try:
            msg.ParseFromString(ticket.ticket)
        except Exception as e:
            raise flight.FlightServerError(f"invalid ticket: {e}")
        trace_id, parent = self._trace_ctx(context)
        if msg.paths:
            return self._do_get_multi(list(msg.paths), trace_id, parent)
        from ..shuffle import memory_store

        if msg.path.startswith(memory_store.SCHEME):
            buf = self._mem_buffer(msg.path)
            with pa.ipc.open_stream(buf) as r:
                schema = r.schema

            def mem_gen():
                # reopen lazily: batches are zero-copy views of the
                # stored buffer, emitted straight onto the wire
                with pa.ipc.open_stream(buf) as reader:
                    yield from reader

            stream = mem_gen()
            if trace_id and trace.is_enabled():
                stream = self._traced_stream(
                    stream, trace_id, parent, msg.path
                )
            return flight.GeneratorStream(schema, stream)
        source, reader = self._open_file_reader(msg.path)

        def gen():
            try:
                for i in range(reader.num_record_batches):
                    yield reader.get_batch(i)
            finally:
                source.close()

        stream = gen()
        if trace_id and trace.is_enabled():
            stream = self._traced_stream(stream, trace_id, parent, msg.path)
        return flight.GeneratorStream(reader.schema, stream)

    def _do_get_multi(self, paths, trace_id: str, parent: str):
        """Multi-partition ticket (``FetchPartitionTicket.paths``): ONE
        stream interleaving every requested partition in ticket order,
        each batch tagged with its partition index as ``app_metadata``
        so the client tracks per-partition delivery for mid-stream
        resume.  Replaces N per-partition DoGet round trips per
        (stage, host) pair."""
        if not paths:
            raise flight.FlightServerError("empty multi-partition ticket")
        # schema up front (from the first partition — one stage, one
        # schema) so zero-batch partitions still stream cleanly
        schema = self._source_schema(paths[0])

        def gen():
            for i, path in enumerate(paths):
                tag = str(i).encode()
                for batch in self._iter_source(path):
                    yield batch, tag

        stream = gen()
        if trace_id and trace.is_enabled():
            stream = self._traced_stream(
                stream, trace_id, parent, f"[{len(paths)} partitions]"
            )
        return flight.GeneratorStream(schema, stream)


class FlightServerHandle:
    """Owns a running Flight service on its own thread."""

    def __init__(self, work_dir: str, host: str = "0.0.0.0", port: int = 0):
        self.service = ShuffleFlightService(work_dir, host, port)
        self.port = self.service.port  # resolved if port was 0
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FlightServerHandle":
        self._thread = threading.Thread(
            target=self.service.serve, name="flight-server", daemon=True
        )
        self._thread.start()
        return self

    def shutdown(self) -> None:
        try:
            self.service.shutdown()
        except Exception:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
