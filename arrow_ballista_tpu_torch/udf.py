"""User-defined function registry and plugin loading.

Counterpart of the reference's UDF plugin system
(``core/src/plugin/mod.rs:36-82`` trait + declare_plugin! dlopen machinery,
``core/src/plugin/udf.rs:29-55`` UDFPlugin trait + manager,
``core/src/plugin/plugin_manager.rs`` GlobalPluginManager singleton) and of
the Python bindings' UDF/UDAF wrappers (``python/src/udf.rs``, ``udaf.rs``).

Rust plugins are ``.so`` files exposing a registrar; the Python-native
equivalent here is a *plugin directory* of ``.py`` modules each exposing
``register_udfs(registry)``, loaded by :func:`load_udf_plugins` — the role
``ballista.plugin_dir`` plays in the reference (``core/src/config.rs:36``).

Resolution model (mirrors the reference): the client/scheduler session
resolves names at planning time from its session registry; executors
resolve at evaluation time from the process-global registry, which their
binary populates from the plugin dir.  Plans ship only the UDF *name*
(``UdfNode`` in ballista.proto), never code.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

import pyarrow as pa

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class ScalarUDF:
    """A vectorized scalar function: ``fn(*arrays) -> array``.

    ``fn`` receives one ``pa.Array`` per argument (full batch column) and
    must return a ``pa.Array`` of ``return_type`` with the same length.
    """

    name: str
    fn: Callable[..., pa.Array]
    input_types: tuple
    return_type: pa.DataType

    def __post_init__(self):
        object.__setattr__(self, "name", self.name.lower())


@dataclass(frozen=True)
class AggregateUDF:
    """A user aggregate: ``fn(values: pa.Array) -> python scalar`` applied
    to each group's values (nulls included; filter inside if undesired).

    Executed single-stage after a hash repartition on the group keys (the
    same strategy the engine uses for ``count_distinct``), so the function
    never needs a partial/merge decomposition.
    """

    name: str
    fn: Callable[[pa.Array], object]
    input_type: pa.DataType
    return_type: pa.DataType

    def __post_init__(self):
        object.__setattr__(self, "name", self.name.lower())


class UdfRegistry:
    def __init__(self, parent: Optional["UdfRegistry"] = None):
        self._scalar: dict[str, ScalarUDF] = {}
        self._aggregate: dict[str, AggregateUDF] = {}
        self._parent = parent
        self._lock = threading.Lock()

    # ---------------------------------------------------------- register
    # Last registration wins, like the reference's GlobalPluginManager
    # singleton; re-registering a name with a DIFFERENT callable is logged
    # because concurrent sessions would silently share the newest impl.
    def register_scalar(self, udf: ScalarUDF) -> None:
        with self._lock:
            old = self._scalar.get(udf.name)
            if old is not None and old.fn is not udf.fn:
                log.warning(
                    "scalar UDF %r re-registered with a different "
                    "implementation; all sessions now resolve the new one",
                    udf.name,
                )
            self._scalar[udf.name] = udf

    def register_aggregate(self, udaf: AggregateUDF) -> None:
        with self._lock:
            old = self._aggregate.get(udaf.name)
            if old is not None and old.fn is not udaf.fn:
                log.warning(
                    "aggregate UDF %r re-registered with a different "
                    "implementation; all sessions now resolve the new one",
                    udaf.name,
                )
            self._aggregate[udaf.name] = udaf

    # ------------------------------------------------------------ lookup
    def scalar(self, name: str) -> Optional[ScalarUDF]:
        with self._lock:
            u = self._scalar.get(name.lower())
        if u is None and self._parent is not None:
            return self._parent.scalar(name)
        return u

    def aggregate(self, name: str) -> Optional[AggregateUDF]:
        with self._lock:
            u = self._aggregate.get(name.lower())
        if u is None and self._parent is not None:
            return self._parent.aggregate(name)
        return u

    def scalar_names(self) -> list[str]:
        names = set(self._scalar)
        if self._parent is not None:
            names |= set(self._parent.scalar_names())
        return sorted(names)

    def aggregate_names(self) -> list[str]:
        names = set(self._aggregate)
        if self._parent is not None:
            names |= set(self._parent.aggregate_names())
        return sorted(names)


_GLOBAL = UdfRegistry()


def global_registry() -> UdfRegistry:
    """Process-wide registry (reference: GlobalPluginManager singleton)."""
    return _GLOBAL


_LOADED_DIRS: set = set()


def load_udf_plugins(plugin_dir: str, registry: Optional[UdfRegistry] = None) -> int:
    """Import every ``*.py`` in ``plugin_dir`` and call its
    ``register_udfs(registry)`` hook.  Returns the number of plugins loaded.

    Counterpart of UDFPluginManager scanning ``plugin_dir`` for ``.so``
    files (``core/src/plugin/udf.rs:45-55``).  When loading into the
    global registry, each directory is loaded at most once per process —
    sessions are created per query on the scheduler, and plugin modules
    must not re-execute on that path.
    """
    registry = registry or _GLOBAL
    if not plugin_dir or not os.path.isdir(plugin_dir):
        return 0
    if registry is _GLOBAL:
        real = os.path.realpath(plugin_dir)
        if real in _LOADED_DIRS:
            return 0
        _LOADED_DIRS.add(real)
    count = 0
    for fname in sorted(os.listdir(plugin_dir)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        path = os.path.join(plugin_dir, fname)
        mod_name = f"ballista_udf_plugin_{fname[:-3]}"
        try:
            spec = importlib.util.spec_from_file_location(mod_name, path)
            assert spec is not None and spec.loader is not None
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            hook = getattr(mod, "register_udfs", None)
            if hook is None:
                log.warning("plugin %s has no register_udfs(registry) hook", path)
                continue
            hook(registry)
            count += 1
            log.info("loaded UDF plugin %s", path)
        except Exception as e:
            log.error("failed to load UDF plugin %s: %s", path, e)
    return count
