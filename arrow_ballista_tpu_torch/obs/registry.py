"""Unified counter/gauge/histogram registry.

Replaces the ad-hoc metric dicts that grew (``shuffle/fetcher``
fetch counters, ``ExecutorManager.quarantines_total``,
``TaskManager.task_retries_total`` and the hand-assembled ``/api/metrics``
response): every process-level counter now lives in ONE place with a
Prometheus text exposition.

Two registry scopes:

* ``MetricsRegistry()`` instances — per scheduler (a test process may run
  several schedulers; their job/slot counters must not bleed into each
  other).  ``SchedulerState`` owns one.
* :func:`process_registry` — the process-wide singleton for data-plane
  counters (shuffle fetch bytes/retries, flight serving) where the
  process IS the natural scope.

Gauges take a callable so values are computed at scrape time (alive
executors, available slots) instead of being pushed on every change.

Labels: metrics may carry a label set — per-executor telemetry
gauges mirror into the scheduler registry as one family with an
``executor`` label.  The exposition groups a family's samples under ONE
``# HELP``/``# TYPE`` pair and escapes label values per the Prometheus
text format 0.0.4 (backslash, double-quote, newline).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple, Union

# go-style duration buckets (seconds) scaled to ns histograms' needs; for
# generic value histograms powers of 4 keep bucket counts small
DEFAULT_BUCKETS = tuple(4.0**i for i in range(-1, 12))

Labels = Optional[Dict[str, str]]


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def escape_label_value(v: str) -> str:
    """Prometheus text format 0.0.4 label-value escaping."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _label_suffix(labels: Labels, extra: str = "") -> str:
    """``{k="v",...}`` rendering (sorted, escaped); "" when empty."""
    parts = [
        f'{k}="{escape_label_value(v)}"'
        for k, v in sorted((labels or {}).items())
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _labels_key(labels: Labels) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items())) if labels else ()


class Counter:
    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(self, name: str, help: str = "", labels: Labels = None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else {}
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> Union[int, float]:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value: either pushed via :meth:`set` or computed by a
    provider callable at read time."""

    __slots__ = ("name", "help", "labels", "_value", "_fn", "_lock")

    def __init__(
        self,
        name: str,
        help: str = "",
        fn: Optional[Callable[[], float]] = None,
        labels: Labels = None,
    ):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else {}
        self._value = 0
        self._fn = fn
        self._lock = threading.Lock()

    def set(self, v: Union[int, float]) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> Union[int, float]:
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:  # noqa: BLE001 - a dead provider reads as 0
                return 0
        with self._lock:
            return self._value


class Histogram:
    __slots__ = ("name", "help", "labels", "buckets", "_counts", "_sum", "_n", "_lock")

    def __init__(
        self, name: str, help: str = "", buckets=DEFAULT_BUCKETS,
        labels: Labels = None,
    ):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else {}
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, v: Union[int, float]) -> None:
        with self._lock:
            self._sum += v
            self._n += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "count": self._n,
                "sum": self._sum,
                "buckets": dict(
                    zip([_fmt(b) for b in self.buckets] + ["+Inf"], self._cumulative())
                ),
            }

    def _cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self._counts:
            acc += c
            out.append(acc)
        return out


class MetricsRegistry:
    def __init__(self, namespace: str = "ballista"):
        self.namespace = namespace
        self._lock = threading.Lock()
        # (name, sorted-label-items) -> metric; unlabeled metrics use ()
        self._metrics: Dict[tuple, Union[Counter, Gauge, Histogram]] = {}

    # ------------------------------------------------------- constructors
    def counter(
        self, name: str, help: str = "", labels: Labels = None
    ) -> Counter:
        return self._get_or_make(
            name, labels, lambda: Counter(name, help, labels), Counter
        )

    def gauge(
        self,
        name: str,
        help: str = "",
        fn: Optional[Callable[[], float]] = None,
        labels: Labels = None,
    ) -> Gauge:
        g = self._get_or_make(
            name, labels, lambda: Gauge(name, help, fn, labels), Gauge
        )
        if fn is not None:
            g._fn = fn  # re-registration rebinds the provider (tests)
        return g

    def histogram(
        self, name: str, help: str = "", buckets=DEFAULT_BUCKETS,
        labels: Labels = None,
    ) -> Histogram:
        return self._get_or_make(
            name, labels, lambda: Histogram(name, help, buckets, labels), Histogram
        )

    def _get_or_make(self, name: str, labels: Labels, make: Callable, kind: type):
        key = (name, _labels_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = make()
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}"
                )
            return m

    def get(self, name: str, labels: Labels = None):
        with self._lock:
            return self._metrics.get((name, _labels_key(labels)))

    def remove(self, name: str, labels: Labels = None) -> bool:
        """Drop one metric (e.g. a lost executor's labeled gauges)."""
        with self._lock:
            return self._metrics.pop((name, _labels_key(labels)), None) is not None

    def remove_by_label(self, label: str, value: str) -> int:
        """Drop every metric whose label set contains ``label == value``
        (the whole per-executor family when an executor leaves)."""
        with self._lock:
            doomed = [
                key
                for key, m in self._metrics.items()
                if m.labels.get(label) == value
            ]
            for key in doomed:
                del self._metrics[key]
            return len(doomed)

    def value(self, name: str, default: Union[int, float] = 0) -> Union[int, float]:
        m = self.get(name)
        return default if m is None or isinstance(m, Histogram) else m.value

    # ------------------------------------------------------------ exports
    def snapshot(self) -> dict:
        """{name: value} for counters/gauges, {name: {count,sum,buckets}}
        for histograms — the JSON shape behind /api/metrics.  Labeled
        metrics nest one level: {name: {'k="v"': value, ...}}."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict = {}
        for m in metrics:
            v = m.snapshot() if isinstance(m, Histogram) else m.value
            if m.labels:
                out.setdefault(m.name, {})[_label_suffix(m.labels)[1:-1]] = v
            else:
                out[m.name] = v
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4.  Samples of one family
        (same name, different labels) group under a single HELP/TYPE."""
        with self._lock:
            metrics = sorted(
                self._metrics.values(),
                key=lambda m: (m.name, _labels_key(m.labels)),
            )
        lines: List[str] = []
        seen_family: set = set()
        for m in metrics:
            full = f"{self.namespace}_{m.name}" if self.namespace else m.name
            if m.name not in seen_family:
                seen_family.add(m.name)
                if m.help:
                    lines.append(f"# HELP {full} {m.help}")
                kind = (
                    "counter"
                    if isinstance(m, Counter)
                    else "gauge" if isinstance(m, Gauge) else "histogram"
                )
                lines.append(f"# TYPE {full} {kind}")
            lbl = _label_suffix(m.labels)
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{full}{lbl} {_fmt(m.value)}")
            else:
                snap = m.snapshot()
                for le, c in snap["buckets"].items():
                    bucket_lbl = _label_suffix(m.labels, 'le="%s"' % le)
                    lines.append(f"{full}_bucket{bucket_lbl} {c}")
                lines.append(f"{full}_sum{lbl} {_fmt(snap['sum'])}")
                lines.append(f"{full}_count{lbl} {snap['count']}")
        return "\n".join(lines) + "\n" if lines else ""


_process_registry = MetricsRegistry()


def process_registry() -> MetricsRegistry:
    """The process-wide registry for data-plane counters (shuffle fetch,
    flight serving, span-buffer drops)."""
    return _process_registry
