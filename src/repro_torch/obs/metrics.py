"""Metrics registry: counters, gauges and histograms.

The numbers side of the observability layer — the span tracer answers
"where did the time go", this answers "how many / how big / what
distribution". One process-wide singleton (:func:`metrics`) shared by the
serving tier (request latencies, cache hit/miss/eviction) and the
autotuner (sweeps).

All instruments are thread-safe and always live; callers on hot paths gate
on ``obs.enabled()`` themselves. Histograms keep a bounded reservoir of the
most recent ``max_samples`` observations plus lifetime count/sum.
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "metrics"]


class Counter:
    """Monotone accumulator. ``inc(v)`` with v >= 0."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        assert v >= 0, (self.name, v)
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value: float = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Lifetime count/sum + a ring buffer of the most recent observations;
    percentiles come from the ring."""

    def __init__(self, name: str, max_samples: int = 8192):
        self.name = name
        self._lock = threading.Lock()
        self._ring = np.zeros(int(max_samples), np.float64)
        self._n = 0            # lifetime observation count
        self._sum = 0.0

    def observe(self, v: float) -> None:
        with self._lock:
            self._ring[self._n % len(self._ring)] = float(v)
            self._n += 1
            self._sum += float(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def percentile(self, q) -> float:
        """Percentile over the reservoir; 0.0 when empty."""
        with self._lock:
            n = min(self._n, len(self._ring))
            if n == 0:
                return 0.0
            return float(np.percentile(self._ring[:n], q))

    def summary(self) -> dict:
        with self._lock:
            n = min(self._n, len(self._ring))
            window = self._ring[:n].copy()
            out = dict(count=self._n, sum=self._sum,
                       mean=(self._sum / self._n) if self._n else 0.0)
        if n:
            out.update(p50=float(np.percentile(window, 50)),
                       p99=float(np.percentile(window, 99)),
                       max=float(window.max()))
        else:
            out.update(p50=0.0, p99=0.0, max=0.0)
        return out


class MetricsRegistry:
    """Name -> instrument, created on first touch. Re-requesting a name
    with a different instrument kind raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, **kw)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, max_samples: int = 8192) -> Histogram:
        return self._get(name, Histogram, max_samples=max_samples)

    def snapshot(self) -> dict:
        """{name: value-or-summary} for every instrument."""
        with self._lock:
            items = list(self._instruments.items())
        out: dict = {}
        for name, inst in items:
            if isinstance(inst, (Counter, Gauge)):
                out[name] = inst.value
            else:
                out[name] = inst.summary()
        return out

    def reset(self) -> None:
        with self._lock:
            self._instruments = {}


_REGISTRY = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-wide registry singleton."""
    return _REGISTRY

