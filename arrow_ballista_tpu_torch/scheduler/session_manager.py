"""Session lifecycle on the scheduler.

Counterpart of the reference's ``scheduler/src/state/session_manager.rs`` +
``session_registry.rs``: per-session config settings persisted in the
Sessions keyspace, an in-memory registry of live ``SessionContext``s, and a
``session_builder`` injection point so embedders can customize context
construction (the reference's Python bindings use that hook to install
custom planners).
"""

from __future__ import annotations

import threading
import uuid
from typing import Callable, Dict, Optional

from ..config import BallistaConfig
from ..context import SessionContext
from ..proto import pb
from .backend import Keyspace, StateBackend

SessionBuilder = Callable[[BallistaConfig], SessionContext]


def default_session_builder(config: BallistaConfig) -> SessionContext:
    # the scheduler's sessions parse and plan; no device stage runs here
    # (each executor accelerates its stages on its own device), so they
    # need no CUDA device
    return SessionContext(config, device="cpu")


class SessionManager:
    def __init__(
        self,
        backend: StateBackend,
        session_builder: SessionBuilder = default_session_builder,
    ):
        self.backend = backend
        self.session_builder = session_builder
        self._registry: Dict[str, SessionContext] = {}
        self._lock = threading.Lock()

    def create_session(self, settings: Dict[str, str]) -> SessionContext:
        config = BallistaConfig(dict(settings))
        ctx = self.session_builder(config)
        ctx.session_id = uuid.uuid4().hex[:16]
        self._persist(ctx.session_id, settings)
        with self._lock:
            self._registry[ctx.session_id] = ctx
        return ctx

    def update_session(
        self, session_id: str, settings: Dict[str, str]
    ) -> SessionContext:
        config = BallistaConfig(dict(settings))
        with self._lock:
            ctx = self._registry.get(session_id)
            if ctx is not None:
                ctx.config = config
            else:
                ctx = self.session_builder(config)
                ctx.session_id = session_id
                self._registry[session_id] = ctx
        self._persist(session_id, settings)
        return ctx

    def get_session(self, session_id: str) -> Optional[SessionContext]:
        with self._lock:
            ctx = self._registry.get(session_id)
        if ctx is not None:
            return ctx
        # rebuild from persisted settings (scheduler restart)
        raw = self.backend.get(Keyspace.Sessions, session_id)
        if raw is None:
            return None
        msg = pb.SessionSettings.FromString(raw)
        settings = {kv.key: kv.value for kv in msg.configs}
        ctx = self.session_builder(BallistaConfig(settings))
        ctx.session_id = session_id
        with self._lock:
            self._registry[session_id] = ctx
        return ctx

    def _persist(self, session_id: str, settings: Dict[str, str]) -> None:
        msg = pb.SessionSettings()
        for k, v in settings.items():
            msg.configs.add(key=k, value=v)
        self.backend.put(Keyspace.Sessions, session_id, msg.SerializeToString())
