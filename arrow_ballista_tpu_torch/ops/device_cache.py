"""Device-resident column cache.

The reference re-reads Arrow batches from disk/Flight on every query; on
the card the dominant per-query cost is the host group encode plus the
host→device transfer.  This cache pins a scan's prepared kernel inputs
(leaf tensors, validity masks, group ids, group dictionaries) in device
memory keyed by (provider, partition, stage signature): repeated
analytical queries over registered tables then run entirely out of device
memory — a warehouse buffer pool on the card.

Bounded: entries are LRU-evicted once the pinned-byte budget (default
4 GiB) is exceeded, and dropped when the owning TableProvider is
garbage-collected.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Any, Optional

DEFAULT_BUDGET_BYTES = 4 << 30

_CACHE: "OrderedDict[tuple[int, int, str], tuple[Any, int]]" = OrderedDict()
_REGISTERED: set[int] = set()
_total_bytes = 0
_budget = DEFAULT_BUDGET_BYTES
# executor task threads share the cache; reentrant because a provider's
# finalizer may run (garbage collection) inside a locked section
_LOCK = threading.RLock()


def staging_bytes() -> int:
    """Bytes sitting in shuffle prefetch queues (fetched but not yet
    consumed / transferred).  Tracked in ``shuffle.fetcher``; surfaced
    here so stats() shows BOTH memory pressures of the data plane —
    pinned device memory and in-flight host staging — in one place."""
    from ..shuffle.fetcher import staging_bytes as _fetch_staging

    return _fetch_staging()


def set_budget(n_bytes: int) -> None:
    global _budget
    with _LOCK:
        _budget = n_bytes
        _evict_to_budget()


def _entry_bytes(value: Any) -> int:
    """Pinned bytes: the ``nbytes`` of every tensor of every entry (a
    ``None`` mask or column costs nothing)."""
    n = 0
    entries = value[0] if isinstance(value, tuple) and value else []
    for item in entries:
        seg, valid, args = item
        for a in (seg, valid, *args):
            n += getattr(a, "nbytes", 0)
    return n


def _evict_provider(pid: int) -> None:
    global _total_bytes
    with _LOCK:
        for k in [k for k in _CACHE if k[0] == pid]:
            _, nb = _CACHE.pop(k)
            _total_bytes -= nb
        _REGISTERED.discard(pid)


def _evict_to_budget() -> None:
    global _total_bytes
    while _total_bytes > _budget and _CACHE:
        _, (_, nb) = _CACHE.popitem(last=False)  # LRU
        _total_bytes -= nb


def get(provider: Any, partition: int, signature: str) -> Optional[Any]:
    k = (id(provider), partition, signature)
    with _LOCK:
        hit = _CACHE.get(k)
        if hit is None:
            return None
        _CACHE.move_to_end(k)
        return hit[0]


def put(provider: Any, partition: int, signature: str, value: Any) -> None:
    global _total_bytes
    pid = id(provider)
    nb = _entry_bytes(value)
    with _LOCK:
        if pid not in _REGISTERED:
            try:
                weakref.finalize(provider, _evict_provider, pid)
                _REGISTERED.add(pid)
            except TypeError:
                return  # provider not weakref-able: skip caching
        if nb > _budget:
            return  # larger than the whole budget: not worth pinning
        k = (pid, partition, signature)
        old = _CACHE.pop(k, None)
        if old is not None:
            _total_bytes -= old[1]
        _CACHE[k] = (value, nb)
        _total_bytes += nb
        _evict_to_budget()


def clear() -> None:
    global _total_bytes
    with _LOCK:
        _CACHE.clear()
        _REGISTERED.clear()
        _total_bytes = 0


def stats() -> dict:
    with _LOCK:
        out = {"entries": len(_CACHE), "bytes": _total_bytes, "budget": _budget}
    out["staging_bytes"] = staging_bytes()
    return out
