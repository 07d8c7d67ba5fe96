"""Build and load the port's CUDA kernels at first use.

All sources go to one ``torch.utils.cpp_extension.load`` call, compiled
for ``sm_90a`` into ``build/torch_kernels/`` under the repository root
(listed in ``.gitignore``).  A failed build raises; nothing falls back.

The extension is compiled and linked by the system's ``c++`` (and nvcc's
default host compiler), never by a ``CXX``/``CC`` override: it must use
the C++ runtime torch links, the system's shared ``libstdc++``.  Another
GCC links its own ``libstdc++`` statically, and that copy's iostreams
misread the process's locale, so formatting an integer (as a
``TORCH_CHECK`` message does) ended the process with SIGSEGV.
"""

from __future__ import annotations

import contextlib
import os
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [
    os.path.join(_HERE, "expr_eval.cu"),
    os.path.join(_HERE, "segment_agg.cu"),
    os.path.join(_HERE, "segment_agg_entries.cu"),
    os.path.join(_HERE, "radix_sort.cu"),
    os.path.join(_HERE, "seg_scan.cu"),
    os.path.join(_HERE, "range_extremum.cu"),
    os.path.join(_HERE, "window_epilogue.cu"),
    os.path.join(_HERE, "partition_id.cu"),
    os.path.join(_HERE, "join_probe.cu"),
    os.path.join(_HERE, "keyed_gids.cu"),
    os.path.join(_HERE, "keyed_fold.cu"),
    os.path.join(_HERE, "keyed_finish.cu"),
    os.path.join(_HERE, "keyed_median.cu"),
    os.path.join(_HERE, "keyed_corr.cu"),
    os.path.join(_HERE, "mesh_reduce.cu"),
    os.path.join(_HERE, "mesh_route.cu"),
    os.path.join(_HERE, "df32_agg.cu"),
    os.path.join(_HERE, "ord_extremum.cu"),
    os.path.join(_HERE, "x32_merge.cu"),
    os.path.join(_HERE, "bindings.cpp"),
]
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_HERE))),
    "build", "torch_kernels",
)
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_ext = None


def is_loaded() -> bool:
    return _ext is not None


@contextlib.contextmanager
def _system_compilers():
    """``CXX`` and ``CC`` unset for the build, restored after it."""
    saved = {k: os.environ.pop(k) for k in ("CXX", "CC") if k in os.environ}
    try:
        yield
    finally:
        os.environ.update(saved)


def load(verbose: bool = False):
    """The compiled extension module (built on the first call)."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load as _load

            os.makedirs(BUILD_DIR, exist_ok=True)
            with _system_compilers():
                _ext = _load(
                    name="ballista_torch_kernels",
                    sources=SOURCES,
                    build_directory=BUILD_DIR,
                    extra_cflags=["-O2"],
                    extra_cuda_cflags=CUDA_FLAGS + (["-Xptxas=-v"] if verbose else []),
                    extra_include_paths=[_HERE],
                    verbose=verbose,
                )
        return _ext
