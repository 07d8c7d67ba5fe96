"""Vectorized multi-key group table for the fused aggregate path.

Round-2 assigned dense group ids with a Python loop over every NEW key
combination (``stage_compiler._encode_groups``) — ~3M loop iterations on
q3 SF10, 6 of the stage's 7.8 seconds.  This table keeps everything in
numpy/pandas hash land:

* per-key dictionary codes fold into ONE int64 via per-key bit radixes
  (bits grow with the observed code range; the stored table re-combines
  vectorized when a radix grows);
* known combinations resolve through a ``pandas.Index`` HASH lookup on
  the combined keys in gid order — ``get_indexer`` IS the gid, and at
  q3/h2o scale the hash probe is ~13x faster than the
  ``np.searchsorted`` binary search it replaced (1.0s vs 13.1s for 15M
  lookups into 2M groups: binary search is cache-hostile);
* new combinations batch-append: one hash-based ``pandas.factorize``
  over the misses only (the sort-based ``np.unique`` it replaced was
  10x slower at q3 SF10 scale: 9.6s vs 1.0s on 30M i64 keys).

Group ids are row indices of ``key_mat`` (assignment order), so device
states stay valid as the table grows — matching the adaptive-capacity
contract of the kernels.
"""

from __future__ import annotations

import numpy as np

# combined keys live in int64: total radix bits must stay under 63
_MAX_TOTAL_BITS = 62


class RadixOverflow(Exception):
    """Combined key space exceeds 62 bits — caller falls back."""


class GroupTable:
    def __init__(self, n_keys: int):
        self.n_keys = n_keys
        self.key_mat = np.empty((0, n_keys), dtype=np.int64)
        self._bits = [1] * n_keys
        # combined keys in GID ORDER (row g == combined key of gid g);
        # the pandas hash index over it is built lazily and invalidated
        # by appends and radix regrowth
        self._combined = np.empty(0, dtype=np.int64)
        self._index = None

    @property
    def n_groups(self) -> int:
        return len(self.key_mat)

    def codes_for(self, gids: np.ndarray, key: int) -> np.ndarray:
        """Per-key dictionary codes for the given group ids (vectorized)."""
        return self.key_mat[gids, key]

    # ------------------------------------------------------------ internal
    def _combine(self, code_cols: list[np.ndarray]) -> np.ndarray:
        combined = code_cols[0].astype(np.int64)
        for bits, c in zip(self._bits[1:], code_cols[1:]):
            combined = (combined << bits) | c.astype(np.int64)
        return combined

    def _grow_radix(self, code_arrays: list[np.ndarray]) -> None:
        changed = False
        for k, c in enumerate(code_arrays):
            if len(c) == 0:
                continue
            need = max(1, int(c.max()).bit_length())
            if need > self._bits[k]:
                self._bits[k] = need
                changed = True
        if sum(self._bits) > _MAX_TOTAL_BITS:
            raise RadixOverflow(
                f"combined group-key space needs {sum(self._bits)} bits"
            )
        if changed and self.n_groups:
            self._combined = self._combine(
                [self.key_mat[:, k] for k in range(self.n_keys)]
            )
            self._index = None

    def _lookup(self, combined: np.ndarray) -> np.ndarray:
        """gid per combined key, -1 for unknown combinations (hash probe)."""
        if self.n_groups == 0:
            return np.full(len(combined), -1, dtype=np.int64)
        if self._index is None:
            import pandas as pd

            self._index = pd.Index(self._combined)
        return self._index.get_indexer(combined)

    # ------------------------------------------------------------- encode
    def encode(self, code_arrays: list[np.ndarray]) -> np.ndarray:
        """Dense stable group ids for one batch of per-key code columns."""
        import pandas as pd

        self._grow_radix(code_arrays)
        combined = self._combine(code_arrays)
        gids = self._lookup(combined).astype(np.int32)

        miss_rows = np.nonzero(gids < 0)[0]
        if len(miss_rows):
            miss = combined[miss_rows]
            # hash-based dedup: codes are first-appearance ordinals, uniq
            # is in first-appearance order — new gids therefore keep the
            # assignment-order contract (gid = key_mat row index)
            codes, uniq = pd.factorize(miss, sort=False)
            codes = codes.astype(np.int32, copy=False)
            # first occurrence of code k is where the running code maximum
            # first reaches k (codes are assigned sequentially)
            cummax = np.maximum.accumulate(codes)
            first = np.empty(len(codes), dtype=bool)
            first[0] = True
            first[1:] = cummax[1:] > cummax[:-1]
            rep = miss_rows[first]
            base = self.n_groups
            new_mat = np.stack(
                [c[rep].astype(np.int64) for c in code_arrays], axis=1
            )
            self.key_mat = np.concatenate([self.key_mat, new_mat])
            self._combined = np.concatenate([self._combined, uniq])
            self._index = None
            gids[miss_rows] = base + codes
        return gids
