"""Native (C++) data-plane kernels, bound via ctypes.

``partitioner.cc`` is compiled lazily to ``build/libabt_native.so`` on
first import (g++ is part of the baked toolchain); if compilation is
impossible the pure-Python fallbacks take over transparently.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np
import pyarrow as pa

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "partitioner.cc")
_BUILD_DIR = os.path.join(_HERE, "build")
_SO = os.path.join(_BUILD_DIR, "libabt_native.so")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_failed = False


def _compile() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    try:
        subprocess.run(
            [
                "g++",
                "-O3",
                "-march=native",
                "-shared",
                "-fPIC",
                "-std=c++17",
                "-o",
                _SO,
                _SRC,
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _compile():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _build_failed = True
            return None
        u8p = ctypes.c_void_p
        lib.abt_hash_int.argtypes = [
            u8p,
            ctypes.c_int32,
            ctypes.c_int32,
            u8p,
            ctypes.c_int64,
            u8p,
        ]
        lib.abt_hash_f64.argtypes = [u8p, u8p, ctypes.c_int64, u8p]
        lib.abt_hash_f32.argtypes = [u8p, u8p, ctypes.c_int64, u8p]
        lib.abt_hash_bool.argtypes = [u8p, u8p, ctypes.c_int64, u8p]
        lib.abt_hash_str32.argtypes = [u8p, u8p, u8p, ctypes.c_int64, u8p]
        lib.abt_hash_str64.argtypes = [u8p, u8p, u8p, ctypes.c_int64, u8p]
        lib.abt_finish_mod.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u8p]
        _lib = lib
        return _lib


# arrow type -> (byte width, is_signed); mirrors the python fallback's
# astype(int64) sign/zero extension semantics
_INT_SPECS = {
    pa.int8(): (1, 1),
    pa.int16(): (2, 1),
    pa.int32(): (4, 1),
    pa.int64(): (8, 1),
    pa.uint8(): (1, 0),
    pa.uint16(): (2, 0),
    pa.uint32(): (4, 0),
    pa.date32(): (4, 1),
    pa.date64(): (8, 1),
}


def _np_ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def native_hash_partition_indices(
    batch: pa.RecordBatch, exprs, n: int
) -> Optional[np.ndarray]:
    """Partition ids via the C++ kernel; None → caller falls back to Python.

    Bit-identical to exec.operators.hash_partition_indices by construction
    (see partitioner.cc header).
    """
    lib = get_lib()
    if lib is None:
        return None

    n_rows = batch.num_rows
    h = np.zeros(n_rows, dtype=np.uint64)
    hp = _np_ptr(h)

    cols = []
    for e in exprs:
        v = e.evaluate(batch)
        if isinstance(v, pa.ChunkedArray):
            v = v.combine_chunks()
        if isinstance(v, pa.Scalar):
            return None  # constant keys: let the python path handle it
        if v.offset != 0:
            v = pa.concat_arrays([v])  # re-materialize at offset 0
            if v.offset != 0:
                return None
        cols.append(v)

    for v in cols:
        t = v.type
        bufs = v.buffers()
        validity = bufs[0].address if bufs[0] is not None and v.null_count else None
        vp = ctypes.c_void_p(validity) if validity else None
        if pa.types.is_string(t):
            lib.abt_hash_str32(
                ctypes.c_void_p(bufs[1].address),
                ctypes.c_void_p(bufs[2].address),
                vp,
                n_rows,
                hp,
            )
        elif pa.types.is_large_string(t):
            lib.abt_hash_str64(
                ctypes.c_void_p(bufs[1].address),
                ctypes.c_void_p(bufs[2].address),
                vp,
                n_rows,
                hp,
            )
        elif pa.types.is_boolean(t):
            lib.abt_hash_bool(ctypes.c_void_p(bufs[1].address), vp, n_rows, hp)
        elif pa.types.is_float64(t):
            lib.abt_hash_f64(ctypes.c_void_p(bufs[1].address), vp, n_rows, hp)
        elif pa.types.is_float32(t):
            lib.abt_hash_f32(ctypes.c_void_p(bufs[1].address), vp, n_rows, hp)
        elif pa.types.is_timestamp(t):
            lib.abt_hash_int(ctypes.c_void_p(bufs[1].address), 8, 1, vp, n_rows, hp)
        elif t in _INT_SPECS:
            size, signed = _INT_SPECS[t]
            lib.abt_hash_int(
                ctypes.c_void_p(bufs[1].address), size, signed, vp, n_rows, hp
            )
        else:
            return None  # unsupported key type → python fallback

    out = np.empty(n_rows, dtype=np.int64)
    lib.abt_finish_mod(hp, n_rows, n, _np_ptr(out))
    return out
