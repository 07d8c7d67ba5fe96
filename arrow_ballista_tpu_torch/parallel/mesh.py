"""Multi-device execution: the device mesh and its two collectives.

Counterpart of ``arrow_ballista_tpu/parallel/mesh.py``.  The reference
runs a stage as ONE ``shard_map`` program over its mesh's data axis: each
device reduces its shard, then the states meet in ``psum``/``pmin``/
``pmax`` (B13b-reduce), and a hash repartition is a stable routing of rows
into ``[n_dev, capacity]`` staging followed by one ``all_to_all``
(B13b-route).  The port keeps that single-controller model: one process
drives every shard of a :class:`TorchMesh`, an ordered list of torch
devices (shards may share a device).  Per shard it runs the port's own
stage function, then

* :func:`mesh_reduce` folds the shards' ``[n_fields, capacity]`` states in
  shard order with B1's merge (``ops/cuda/mesh_reduce.cu``);
* :func:`mesh_route` stages each shard's rows by destination
  (``ops/cuda/mesh_route.cu``), and the all-to-all is block copies:
  destination ``d`` receives ``concat_s(stage[s][d])``.

No ``torch.distributed``: a process group wants one process per rank,
which would break the executor's one-task-per-stage contract.  When shards
span more than one card, states and staged blocks move to their card with
``Tensor.to``.

In x32 the reduce folds int32 state words with the reference's
collective semantics: a sum's hi and lo words each added (its ``psum``,
no 2Sum), order pairs by the lexicographic extremum, in shard order.  The
exchange's x32 ``i64pair`` layout waits for ROADMAP A7b and raises
``ExecutionError`` where the reference would take it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..errors import ExecutionError
from ..ops import kernels as K

# Shards of a CPU mesh: the CPU is one device, and tests that hold the port
# against the reference's 8 virtual CPU devices set this to 8.
CPU_DEVICES = 1

# The kernels' limits: shards one reduce folds, destinations one route
# stages (the route's per-warp counters live in shared memory).
MESH_MAX_SHARDS = 64
MESH_MAX_DEVICES = 256


class TorchMesh:
    """An ordered list of shard devices; shard ``s`` runs on ``devices[s]``."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = [torch.device(d) for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)


def visible_devices(device) -> int:
    """Devices a mesh over ``device``'s type may span."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.device_count()
    return CPU_DEVICES


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> TorchMesh:
    """``n_devices`` shards (all visible devices when None), round-robin
    over the visible devices of ``device``'s type."""
    dev = torch.device(device)
    n_vis = max(1, visible_devices(dev))
    n = n_vis if n_devices is None else int(n_devices)
    if dev.type == "cuda":
        return TorchMesh([torch.device("cuda", i % n_vis) for i in range(n)])
    return TorchMesh([dev] * n)


# ------------------------------------------------------- B13b-reduce kernel
def _reduce_ops(specs: list, mode: str = "x64") -> list[int]:
    """The kernel's per-field merge codes from the state layout: OP_* codes
    in x64, :func:`..ops.kernels.x32_merge_ops`' XM_* codes in x32."""
    if mode == "x32":
        return K.x32_merge_ops(specs)
    for spec in specs:
        if getattr(spec, "ord_pair", False) or getattr(spec, "pair", False):
            raise ExecutionError("pair states exist only in x32 mode")
    codes = {
        ("add", True): K.OP_ADD_I64, ("add", False): K.OP_ADD_F64,
        ("min", True): K.OP_MIN_I64, ("min", False): K.OP_MIN_F64,
        ("max", True): K.OP_MAX_I64, ("max", False): K.OP_MAX_F64,
    }
    return [codes[f] for f in K._field_flags(specs)]


def _mesh_merge_x32(ops: list[int], acc: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Two x32 shard states folded with the reference's collectives: hi and
    lo words of a sum each added in float32 (``psum``), order pairs
    lexicographically (``pmin``/``pmax`` of hi, then of lo among the
    ties), the rest as the state merge does."""
    out = acc.clone()
    for f, op in enumerate(ops):
        if op in (K.XM_SUM_HI, K.XM_SUM_LO):
            out[f] = (acc[f].view(K.F32) + new[f].view(K.F32)).view(K.I32)
        elif op in (K.XM_OMIN_HI, K.XM_OMAX_HI):
            out[f], out[f + 1] = K._lex_merge(acc[f], acc[f + 1], new[f], new[f + 1],
                                              op == K.XM_OMIN_HI)
        elif op != K.XM_PAIR_LO:
            out[f] = K._x32_merge_row(op, acc[f], new[f])
    return out


def mesh_reduce_reference(specs: list, states: list) -> torch.Tensor:
    """Plain PyTorch twin of the reduce kernel: ``combine_states`` folded
    over the shards in order (x32: :func:`_mesh_merge_x32`), on the first
    shard's device."""
    out = None
    dev = states[0].device
    x32 = K._state_mode(states[0]) == "x32"
    ops = _reduce_ops(specs, "x32") if x32 else None
    for s in states:
        s = s.to(dev)
        if out is None:
            out = s
        elif x32:
            out = _mesh_merge_x32(ops, out, s)
        else:
            out = K.combine_states(specs, out, s)
    return out.clone() if len(states) == 1 else out


def _check_reduce_args(states: list, n_fields: int) -> None:
    """ValueError unless the kernel takes these states (checked before the
    binding: an exception inside the extension may end the process)."""
    if not 1 <= len(states) <= MESH_MAX_SHARDS:
        raise ValueError(f"{len(states)} shard states outside 1..{MESH_MAX_SHARDS}")
    first = states[0]
    for s in states:
        if not (
            isinstance(s, torch.Tensor) and s.device == first.device
            and s.device.type == "cuda" and s.dtype in (torch.int64, torch.int32)
            and s.dtype == first.dtype
            and s.dim() == 2 and s.shape == first.shape and s.is_contiguous()
        ):
            raise ValueError(
                "shard states must be contiguous CUDA int64 (x32: int32) "
                f"[n_fields, capacity] tensors of one shape and dtype on {first.device}"
            )
    if first.shape[0] != n_fields or n_fields > K.MAX_FIELDS:
        raise ValueError(f"{first.shape[0]} state rows for {n_fields} fields")


def mesh_reduce_cuda(specs: list, states: list) -> torch.Tensor:
    """Launch the hand-written cross-shard reduce (ops/cuda/mesh_reduce.cu).

    Replaces the ``psum``/``pmin``/``pmax`` of
    ``arrow_ballista_tpu/parallel/mesh.py:make_distributed_agg_step``, its
    x32 form (int32 states) included.  States on other cards move to the
    first shard's card first.  Inputs are checked (ValueError); a failed
    build or launch raises."""
    from ..ops.cuda.build import load

    x32 = states[0].dtype == torch.int32
    ops = _reduce_ops(specs, "x32" if x32 else "x64")
    dev = states[0].device
    states = [s.to(dev) for s in states]
    _check_reduce_args(states, len(ops))
    ext = load()
    out = torch.empty_like(states[0])
    ext.mesh_reduce(states, ops, out, x32)
    K.count_launch("mesh_reduce")
    return out


def mesh_reduce(specs: list, states: list) -> torch.Tensor:
    """One ``[n_fields, capacity]`` state from the shards' states, each
    field folded over shards ``0..S-1`` by its role: the CUDA kernel for
    CUDA tensors, its plain twin for tensors on the CPU."""
    if not states:
        raise ValueError("mesh_reduce: no shard states")
    if states[0].device.type == "cpu":
        _reduce_ops(specs, K._state_mode(states[0]))
        return mesh_reduce_reference(specs, states)
    return mesh_reduce_cuda(specs, states)


# -------------------------------------------------------- B13b-route kernel
def mesh_route_reference(
    dest: torch.Tensor, valid: torch.Tensor, cols: list, n_dev: int, capacity: int
) -> tuple:
    """Plain PyTorch twin of the route kernel, ``local_exchange``'s
    arithmetic: a stable argsort by destination (invalid rows, and any
    destination outside ``0..n_dev-1``, to the sentinel ``n_dev``), each
    row's rank within its destination's run, and ``index_put_`` into zeroed
    ``[n_dev, capacity]`` staging.  Rows past ``capacity`` are counted in
    ``n_dropped``, as are valid rows with an out-of-range destination.

    Returns ``(staged columns, staged validity, n_dropped int64 [1])``."""
    device = dest.device
    rows = dest.shape[0]
    in_range = (dest >= 0) & (dest < n_dev)
    dest_m = torch.where(valid & in_range, dest.to(torch.int64), n_dev)
    order = torch.argsort(dest_m, stable=True)
    dest_s = dest_m[order]
    counts = torch.bincount(dest_s, minlength=n_dev + 1)[:n_dev]
    offsets = torch.cumsum(counts, 0) - counts
    real = dest_s < n_dev
    safe = torch.clamp(dest_s, max=n_dev - 1)
    idx = torch.arange(rows, dtype=torch.int64, device=device) - offsets[safe]
    ok = real & (idx < capacity)
    n_dropped = (real & (idx >= capacity)).sum() + (valid & ~in_range).sum()
    at = (safe[ok], idx[ok])
    src = order[ok]
    staged = []
    for c in cols:
        stage = torch.zeros((n_dev, capacity), dtype=c.dtype, device=device)
        stage.index_put_(at, c[src])
        staged.append(stage)
    staged_valid = torch.zeros((n_dev, capacity), dtype=torch.bool, device=device)
    staged_valid.index_put_(at, torch.ones(src.shape[0], dtype=torch.bool, device=device))
    return staged, staged_valid, n_dropped.reshape(1).to(torch.int64)


def _check_route_args(dest, valid, cols: list, n_dev: int, capacity: int) -> None:
    """ValueError unless the kernel takes these inputs."""
    if not (
        isinstance(dest, torch.Tensor) and dest.device.type == "cuda"
        and dest.dtype == torch.int32 and dest.dim() == 1 and dest.is_contiguous()
    ):
        raise ValueError("dest must be a contiguous CUDA int32 [rows] tensor")
    n = dest.shape[0]
    for name, t in [("valid", valid)] + [(f"column {i}", c) for i, c in enumerate(cols)]:
        if not (
            isinstance(t, torch.Tensor) and t.device == dest.device
            and t.dim() == 1 and t.shape[0] == n and t.is_contiguous()
            and t.element_size() in (1, 2, 4, 8)
        ):
            raise ValueError(f"{name} must be a contiguous [{n}] tensor on {dest.device}")
    if valid.dtype != torch.bool:
        raise ValueError("valid must be bool")
    if not 1 <= n_dev <= MESH_MAX_DEVICES:
        raise ValueError(f"n_dev {n_dev} outside 1..{MESH_MAX_DEVICES}")
    if capacity < 1 or n_dev * capacity >= 1 << 62:
        raise ValueError(f"capacity {capacity}")


def mesh_route_cuda(
    dest: torch.Tensor, valid: torch.Tensor, cols: list, n_dev: int, capacity: int
) -> tuple:
    """Launch the hand-written route (ops/cuda/mesh_route.cu).

    Replaces ``local_exchange`` of
    ``arrow_ballista_tpu/parallel/mesh.py:ici_batch_exchange`` and
    ``ici_all_to_all_repartition`` (their sort, counts, ranks and staging
    scatter).  Inputs are checked (ValueError); a failed build or launch
    raises."""
    from ..ops.cuda.build import load

    n_dev, capacity = int(n_dev), int(capacity)
    _check_route_args(dest, valid, cols, n_dev, capacity)
    ext = load()
    device = dest.device
    staged = [torch.zeros((n_dev, capacity), dtype=c.dtype, device=device) for c in cols]
    staged_valid = torch.zeros((n_dev, capacity), dtype=torch.bool, device=device)
    n_dropped = torch.zeros(1, dtype=torch.int64, device=device)
    ext.mesh_route(dest, valid, list(cols), n_dev, capacity, staged, staged_valid,
                   n_dropped)
    K.count_launch("mesh_route")
    return staged, staged_valid, n_dropped


def mesh_route(dest, valid, cols: list, n_dev: int, capacity: int) -> tuple:
    """Stable routing of one shard's rows into ``[n_dev, capacity]``
    staging by destination: the CUDA kernel for CUDA tensors, its plain
    twin for tensors on the CPU."""
    if dest.device.type == "cpu":
        return mesh_route_reference(dest, valid, list(cols), int(n_dev), int(capacity))
    return mesh_route_cuda(dest, valid, cols, n_dev, capacity)


# ------------------------------------------------------- distributed agg
def make_distributed_agg_step(
    kernel: Callable,
    specs,
    mesh: TorchMesh,
    capacity: int,
    mode: str = "x64",
):
    """Wrap a partial-agg stage function so it runs over the mesh.

    ``kernel`` is ``fn(gid, tail, *leaf tensors, state=None) -> state``
    (``ops/kernels.py:make_partial_agg_kernel``).  The returned
    ``step(shards)`` takes one entry per shard, ``[gid, tail, *leaf
    tensors]`` on that shard's device (``tail`` the row mask, None when
    every row is live) or None for a shard with no rows; each shard
    reduces its rows to a fresh ``[n_fields, capacity]`` state (an empty
    shard holds the identity, as the reference's padded shard does), then
    :func:`mesh_reduce` folds them, even for one shard, as ``shard_map``'s
    program always holds the psum.  The reduced state lies on the first
    shard's device.  ``mode`` is the one the stage function was built
    under (x32: int32 states, the reference's x32 collectives)."""
    _reduce_ops(specs, mode)

    def step(shards: list) -> torch.Tensor:
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
        states = []
        for dev, shard in zip(mesh.devices, shards):
            if shard is None:
                states.append(K.init_states(specs, capacity, dev, mode))
                continue
            gid, tail, *arrays = shard
            states.append(kernel(gid, tail, *arrays, state=None))
        return mesh_reduce(specs, states)

    return step


# ------------------------------------------------- on-device repartition
def _all_to_all(mesh: TorchMesh, staged: list) -> list:
    """Destination ``d`` receives ``concat_s(staged[s][d])`` on its device:
    ``staged[s]`` is shard ``s``'s ``[n_dev, capacity]`` block."""
    out = []
    for d, dev in enumerate(mesh.devices):
        out.append(torch.cat([blk[d].to(dev) for blk in staged]))
    return out


def ici_batch_exchange(mesh: TorchMesh, n_cols: int, capacity: int):
    """Multi-column hash-repartition exchange over the mesh.

    Returns ``fn(shards) -> (recv_cols, recv_valid, n_dropped)``:
    ``shards[s]`` is ``(dest int32, valid bool, *cols)`` on shard ``s``'s
    device (:func:`shard_batch`); each shard routes its rows
    (:func:`mesh_route`) and the blocks swap so destination ``d`` holds
    every source's bucket ``d``.  ``recv_cols[c][d]`` and ``recv_valid[d]``
    are ``[n_dev * capacity]`` on device ``d``.  ``n_dropped`` is the
    global count of valid rows that overflowed a (source, destination)
    bucket: callers MUST re-run with a larger capacity (or fall back to the
    Flight shuffle) when it is not zero."""
    n_dev = mesh.size

    def fn(shards: list):
        stages: list = []
        valids: list = []
        dropped = []
        for shard in shards:
            dest, valid, *cols = shard
            if len(cols) != n_cols:
                raise ValueError(f"{len(cols)} columns for an exchange of {n_cols}")
            st, sv, nd = mesh_route(dest, valid, cols, n_dev, capacity)
            stages.append(st)
            valids.append(sv)
            dropped.append(nd)
        recv_cols = [
            _all_to_all(mesh, [st[c] for st in stages]) for c in range(n_cols)
        ]
        recv_valid = _all_to_all(mesh, valids)
        n_dropped = sum(int(nd) for nd in dropped)
        return recv_cols, recv_valid, n_dropped

    return fn


class BatchExchanger:
    """Schema-aware host bridge around :func:`ici_batch_exchange`.

    Turns RecordBatches into device columns (value + validity per field;
    strings as shared dictionary codes; in x32, int64, uint64, date64,
    timestamp and f64 fields as exact (lo, hi) int32 words, f64 by its
    bits: the reference's "i64pair" layout, which the 4-byte words of
    ``mesh_route`` move unchanged), runs the mesh exchange, and
    reassembles per-destination RecordBatches.
    """

    def __init__(self, mesh: TorchMesh, schema, capacity: int, share_from=None):
        import pyarrow as pa

        from ..ops.bridge import DictEncoder

        self.mesh = mesh
        self.schema = schema
        self.capacity = capacity
        if share_from is not None:
            # capacity retry: the layout and encoders (and any columns
            # already produced by to_columns) are schema properties
            self.layout = share_from.layout
            self.encoders = share_from.encoders
            self.n_cols = share_from.n_cols
            self._fn = ici_batch_exchange(mesh, self.n_cols, capacity)
            return
        # per-field device layout: "num" (one array) or "dict" (codes)
        self.layout: list[tuple] = []
        self.encoders: dict[int, DictEncoder] = {}
        x32 = K.precision_mode() == "x32"
        for i, f in enumerate(schema):
            t = f.type
            if pa.types.is_string(t) or pa.types.is_large_string(t):
                self.encoders[i] = DictEncoder()
                self.layout.append(("dict", i))
            elif x32 and (
                pa.types.is_int64(t) or pa.types.is_uint64(t) or pa.types.is_date64(t)
                or pa.types.is_timestamp(t) or pa.types.is_float64(t)
            ):
                # the exchange only moves data, so a 64-bit value crosses
                # as its two 32-bit words and comes back bit for bit
                self.layout.append(("i64pair", i))
            else:
                self.layout.append(("num", i))
        # value (two words for a pair) + validity per field
        self.n_cols = sum(2 if kind == "i64pair" else 1 for kind, _ in self.layout) + len(
            self.layout
        )
        self._fn = ici_batch_exchange(mesh, self.n_cols, capacity)

    # ------------------------------------------------------------- host →
    def to_columns(self, batch) -> list[np.ndarray]:
        """Flatten one RecordBatch into the exchange's column list."""
        import pyarrow.compute as pc

        from ..ops.bridge import arrow_to_numpy

        cols: list[np.ndarray] = []
        for kind, i in self.layout:
            arr = batch.column(i)
            if kind == "dict":
                codes = self.encoders[i].encode(arr)
                validity = (
                    np.asarray(pc.is_valid(arr))
                    if arr.null_count
                    else np.ones(len(arr), bool)
                )
                cols.append(codes)
            elif kind in ("num", "i64pair"):
                values, validity = arrow_to_numpy(
                    arr.combine_chunks() if hasattr(arr, "combine_chunks") else arr
                )
                if validity is None:
                    validity = np.ones(len(values), bool)
                if kind == "i64pair":
                    v = (values.view(np.int64) if values.dtype == np.float64
                         else values.astype(np.int64))
                    cols.append((v & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
                    cols.append((v >> 32).astype(np.int32))
                else:
                    cols.append(values)
            else:
                raise ExecutionError(f"exchange layout {kind}")
            cols.append(validity)
        return cols

    # ------------------------------------------------------------ exchange
    def exchange(self, dest: np.ndarray, valid: np.ndarray, cols):
        """Run the mesh exchange; returns (recv_cols, recv_valid,
        n_dropped) as host arrays, each column's destinations one after
        another (``[n_dev * n_dev * capacity]``)."""
        shards = shard_batch(self.mesh, [dest, valid] + list(cols))
        recv_cols, recv_valid, n_dropped = self._fn(shards)
        host = [
            torch.cat([r.cpu() for r in per_dev]).numpy()
            for per_dev in recv_cols + [recv_valid]
        ]
        return host[:-1], host[-1], n_dropped

    # ------------------------------------------------------------- → host
    def to_batches(self, recv_cols, recv_valid) -> list:
        """Reassemble one RecordBatch per destination device."""
        import pyarrow as pa

        n_dev = self.mesh.size
        per_dev = len(recv_valid) // n_dev
        out = []
        for d in range(n_dev):
            sl = slice(d * per_dev, (d + 1) * per_dev)
            mask = recv_valid[sl]
            arrays = []
            ci = 0
            for kind, i in self.layout:
                f = self.schema.field(i)
                if kind == "i64pair":
                    lo = recv_cols[ci][sl][mask].view(np.uint32).astype(np.int64)
                    hi = recv_cols[ci + 1][sl][mask].astype(np.int64)
                    values = (hi << 32) | lo
                    if pa.types.is_float64(f.type):
                        values = values.view(np.float64)
                    elif pa.types.is_uint64(f.type):
                        values = values.view(np.uint64)
                    ci += 1
                else:
                    values = recv_cols[ci][sl][mask]
                validity = recv_cols[ci + 1][sl][mask]
                ci += 2
                if kind == "dict":
                    arrays.append(
                        self.encoders[i].decode(values, f.type, mask=~validity)
                    )
                else:
                    arrays.append(
                        pa.array(
                            _cast_back(values, f.type),
                            f.type,
                            mask=~validity,
                        )
                    )
            out.append(pa.RecordBatch.from_arrays(arrays, schema=self.schema))
        return out


def _cast_back(values: np.ndarray, t) -> np.ndarray:
    import pyarrow as pa

    if pa.types.is_date32(t):
        return values.astype("datetime64[D]")
    if pa.types.is_date64(t):
        return values.astype("int64").view("datetime64[ms]")
    if pa.types.is_timestamp(t):
        return values.astype("int64").view(f"datetime64[{t.unit}]")
    return values


def ici_all_to_all_repartition(mesh: TorchMesh, capacity: int):
    """Single-column hash-repartition exchange over the mesh.

    Returns ``fn(shards) -> (recv_values, recv_valid, n_dropped)`` with
    ``shards[s] = (values, dest int32, valid bool)`` on shard ``s``'s
    device; ``recv_values[d]`` and ``recv_valid[d]`` are
    ``[n_dev * capacity]`` on device ``d``, holding every row whose
    ``dest == d``.  ``n_dropped`` is the GLOBAL count of valid rows past a
    (source, destination) bucket's capacity, which callers MUST check."""
    exchange = ici_batch_exchange(mesh, 1, capacity)

    def fn(shards: list):
        recv_cols, recv_valid, n_dropped = exchange(
            [(dest, valid, values) for values, dest, valid in shards]
        )
        return recv_cols[0], recv_valid, n_dropped

    return fn


def assemble_shards(mesh: TorchMesh, per_dev_chunks: list, n_cols: int) -> list:
    """Device-resident chunks → one column list per shard, no host concat.

    ``per_dev_chunks[d]`` lists the chunks already on shard ``d``'s device,
    each chunk ``n_cols`` equal-length 1-D tensors (a validity may be None:
    all valid).  Each shard concatenates ITS chunks in arrival order, so
    its row order is the reference's; shards need no padding to one length.
    A shard with no chunks is None."""
    from ..ops.stage_compiler import _concat

    if len(per_dev_chunks) != mesh.size:
        raise ValueError(f"{len(per_dev_chunks)} chunk lists for {mesh.size} shards")
    out: list = []
    for chunks in per_dev_chunks:
        if not chunks:
            out.append(None)
            continue
        lengths = [int(ch[0].shape[0]) for ch in chunks]
        out.append([_concat([ch[c] for ch in chunks], lengths) for c in range(n_cols)])
    return out


def shard_batch(mesh: TorchMesh, arrays: Sequence[np.ndarray]) -> list:
    """Host arrays → one contiguous row range per shard, on its device.

    Shard ``s`` takes rows ``[s * per, (s + 1) * per)`` with
    ``per = ceil(rows / n_dev)``, the reference's split; the reference's
    zero padding of the last shard is left out, since a padded row is
    invalid and routes nowhere.  Returns ``shards[s] = [tensor, ...]``."""
    n_dev = mesh.size
    n = len(arrays[0]) if arrays else 0
    per = -(-n // n_dev) if n else 0
    out = []
    for s, dev in enumerate(mesh.devices):
        lo, hi = min(s * per, n), min((s + 1) * per, n)
        out.append([_to_device(a[lo:hi], dev) for a in arrays])
    return out


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A tensor of its own on ``dev`` (torch cannot alias a read-only or
    strided array, and a CPU tensor must not alias the caller's)."""
    if dev.type == "cpu" or not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, copy=True)
    return torch.from_numpy(a).to(dev)
