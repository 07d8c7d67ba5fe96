"""Edge key sets of the radix sort (``ops/cuda/radix_sort.cu``), shared by
the CPU tests (its twin against ``lax.sort``) and the card tests (the
kernel against its twin).  Each is a list of int32/int64 numpy columns,
most significant first, made from a seed."""

import numpy as np

I32 = np.iinfo(np.int32)
I64 = np.iinfo(np.int64)

RADIX_EDGE_CASES = (
    "one digit but one row",
    "descending",
    "int32 extremes",
    "int64 extremes",
    "int64 high bytes skip",
    "32 keys",
)


def radix_edge_rows(tile: int, small_rows: int) -> tuple:
    """0 and 1 rows, then each -1, +0, +1: a pass's tile (under the one-CTA
    sort's bound), the bound, and three tiles (the tiled passes' edges)."""
    edges = (tile, small_rows, 3 * tile)
    return (0, 1) + tuple(e + d for e in edges for d in (-1, 0, 1))


def radix_edge_keys(case: str, n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    if case == "one digit but one row":
        # every pass that runs has one digit holding every row but one
        k = np.full(n, 0x0505, np.int32)
        if n:
            k[rng.integers(n)] = 0x0404
        return [k]
    if case == "descending":
        # both words of an int64 column run, values across zero
        return [((n - 1 - np.arange(n, dtype=np.int64)) * (1 << 33)) - (1 << 45),
                np.arange(n, 0, -1).astype(np.int32)]
    if case == "int32 extremes":  # sign bit flipped: min first, max last
        vals = np.array([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1, I32.max], np.int32)
        return [rng.choice(vals, n), rng.choice(vals, n)]
    if case == "int64 extremes":
        vals = np.array([I64.min, I64.min + 1, -(1 << 32), -1, 0, 1, 1 << 31, 1 << 32,
                         I64.max - 1, I64.max], np.int64)
        return [rng.choice(vals, n), rng.choice(vals[2:8], n)]
    if case == "int64 high bytes skip":  # the high word is never read
        return [rng.integers(0, 1 << 20, n, dtype=np.int64),
                rng.integers(-3, 3, n).astype(np.int32)]
    if case == "32 keys":
        return [rng.integers(-2, 3, n).astype(np.int32 if j % 2 else np.int64)
                for j in range(32)]
    raise ValueError(case)
