"""Build and load the port's CUDA kernels at first use.

All sources go to one ``torch.utils.cpp_extension.load`` call, compiled
for ``sm_90a`` into ``build/torch_kernels/`` under the repository root
(listed in ``.gitignore``).  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import os
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [
    os.path.join(_HERE, "segment_agg.cu"),
    os.path.join(_HERE, "radix_sort.cu"),
    os.path.join(_HERE, "seg_scan.cu"),
    os.path.join(_HERE, "range_extremum.cu"),
    os.path.join(_HERE, "window_epilogue.cu"),
    os.path.join(_HERE, "partition_id.cu"),
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


def load(verbose: bool = False):
    """The compiled extension module (built on the first call)."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load as _load

            os.makedirs(BUILD_DIR, exist_ok=True)
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
