"""Thread-safe nestable span tracer with a disabled no-op fast path.

1. **Near-zero disabled cost.** ``span()`` when tracing is off is one
   module-global check returning a shared no-op context manager.
2. **Thread safety.** The serving tier answers from a worker thread and
   client threads. Nesting state is ``threading.local``; finished spans
   are appended to one shared list under a lock.
3. **Monotonic clock.** Timestamps are ``time.perf_counter_ns`` relative
   to the tracer's epoch.

Kernel-dispatch records (:func:`op_record`) synchronize the device before
reading the clock when the output lies on a CUDA device, so an ``op.*``
span measures execution, not the asynchronous enqueue.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Iterator, Optional

__all__ = ["Span", "Tracer", "get_tracer", "span", "instant", "op_record",
           "op_t0", "profiled", "enable", "disable", "enabled", "reset",
           "op_profiling_enabled"]


@dataclasses.dataclass
class Span:
    """One finished (or instant) event on the shared timeline."""

    name: str
    t_start_ns: int          # relative to the tracer epoch
    dur_ns: int              # 0 for instant events
    tid: int                 # python thread ident
    tname: str               # thread name at record time
    depth: int               # nesting depth within the recording thread
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def t_end_ns(self) -> int:
        return self.t_start_ns + self.dur_ns

    @property
    def category(self) -> str:
        """Name prefix before the first dot — the layer convention."""
        return self.name.split(".", 1)[0]


class _OpenSpan:
    """Context manager for one live span; created only when enabled."""

    __slots__ = ("_tracer", "name", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_OpenSpan":
        self._tracer._stack().append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        tr = self._tracer
        stack = tr._stack()
        # tolerate a foreign unwind: pop down to and including this span
        while stack and stack.pop() is not self:
            pass
        tr._record(Span(
            name=self.name, t_start_ns=self._t0 - tr.epoch_ns,
            dur_ns=t1 - self._t0, tid=threading.get_ident(),
            tname=threading.current_thread().name, depth=len(stack),
            attrs=self.attrs))


class _NoopSpan:
    """The shared disabled-path context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NOOP = _NoopSpan()


class Tracer:
    """Collects finished spans; one process singleton via :func:`get_tracer`.

    ``enabled`` gates span creation; ``ops_enabled`` additionally gates
    the kernel-dispatch records. Past ``max_spans`` new spans are dropped
    and counted (``n_dropped``).
    """

    def __init__(self, max_spans: int = 1_000_000):
        self.enabled = False
        self.ops_enabled = False
        self.max_spans = int(max_spans)
        self.n_dropped = 0
        self.epoch_ns = time.perf_counter_ns()
        self.epoch_unix_s = time.time()
        self.spans: list[Span] = []
        self._lock = threading.Lock()
        self._tls = threading.local()

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _record(self, s: Span) -> None:
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.n_dropped += 1
                return
            self.spans.append(s)

    def span(self, name: str, **attrs):
        """Context manager timing a region; no-op when disabled."""
        if not self.enabled:
            return _NOOP
        return _OpenSpan(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        """Zero-duration marker event (decision logs, faults)."""
        if not self.enabled:
            return
        self._record(Span(
            name=name, t_start_ns=time.perf_counter_ns() - self.epoch_ns,
            dur_ns=0, tid=threading.get_ident(),
            tname=threading.current_thread().name,
            depth=len(self._stack()), attrs=attrs))

    def add_span(self, name: str, t_start_ns: int, dur_ns: int,
                 **attrs) -> None:
        """Record an externally-timed interval. ``t_start_ns`` is absolute
        ``time.perf_counter_ns``."""
        if not self.enabled:
            return
        self._record(Span(
            name=name, t_start_ns=int(t_start_ns) - self.epoch_ns,
            dur_ns=max(int(dur_ns), 0), tid=threading.get_ident(),
            tname=threading.current_thread().name, depth=0, attrs=attrs))

    def reset(self) -> None:
        """Drop collected spans (enable state unchanged)."""
        with self._lock:
            self.spans = []
            self.n_dropped = 0
            self.epoch_ns = time.perf_counter_ns()
            self.epoch_unix_s = time.time()

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self.spans)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer singleton."""
    return _TRACER


def enabled() -> bool:
    return _TRACER.enabled


def op_profiling_enabled() -> bool:
    return _TRACER.ops_enabled


def enable(*, ops: bool = True) -> None:
    """Turn tracing on (``ops`` additionally records kernel dispatches)."""
    _TRACER.enabled = True
    _TRACER.ops_enabled = bool(ops)


def disable() -> None:
    _TRACER.enabled = False
    _TRACER.ops_enabled = False


def reset() -> None:
    _TRACER.reset()


def span(name: str, **attrs):
    """``with obs.span("serve.flush", index=3):`` — the disabled path is
    one flag check + shared no-op."""
    if not _TRACER.enabled:
        return _NOOP
    return _OpenSpan(_TRACER, name, attrs)


def instant(name: str, **attrs) -> None:
    _TRACER.instant(name, **attrs)


@contextlib.contextmanager
def profiled(*, ops: bool = True, fresh: bool = True) -> Iterator[Tracer]:
    """Enable tracing for a ``with`` region, restoring the previous state
    after. ``fresh=True`` resets collected spans on entry."""
    prev = (_TRACER.enabled, _TRACER.ops_enabled)
    if fresh:
        _TRACER.reset()
    enable(ops=ops)
    try:
        yield _TRACER
    finally:
        _TRACER.enabled, _TRACER.ops_enabled = prev


# --------------------------------------------------------------------------
# Kernel-dispatch records (profile-ops mode)
# --------------------------------------------------------------------------

def _shape_of(x: Any):
    shp = getattr(x, "shape", None)
    return None if shp is None else tuple(int(d) for d in shp)


def op_record(name: str, out, *operands, plan: Optional[str] = None,
              t0_ns: Optional[int] = None, **attrs) -> None:
    """Record one kernel-dispatch event: op name, operand shapes, plan.

    With ``t0_ns`` the caller timed the call: a CUDA output is
    synchronized first (``torch.cuda.synchronize``), so the span is device
    wall time; without it an instant ``op.<name>.trace`` marker is
    recorded instead."""
    if not _TRACER.ops_enabled:
        return
    shapes = [s for s in (_shape_of(o) for o in operands) if s is not None]
    if plan is not None:
        attrs["plan"] = plan
    attrs["shapes"] = shapes
    if t0_ns is None:
        _TRACER.instant(f"op.{name}.trace", **attrs)
        return
    device = getattr(out, "device", None)
    if device is not None and device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
    t1 = time.perf_counter_ns()
    _TRACER.add_span(f"op.{name}", t0_ns, t1 - t0_ns, **attrs)


def op_t0() -> Optional[int]:
    """Clock read for a timed :func:`op_record`, or None when op profiling
    is off (so the disabled path never touches the clock)."""
    return time.perf_counter_ns() if _TRACER.ops_enabled else None
