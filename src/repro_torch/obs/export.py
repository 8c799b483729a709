"""Chrome-trace-event / Perfetto JSON export and its schema check
(``src/repro/obs/export.py``).

``to_chrome_trace`` renders the tracer's spans in the Trace Event
Format's JSON Object Format (what ``chrome://tracing`` and Perfetto's
legacy importer load):

* finished spans -> complete events (``ph: "X"``; ``ts`` / ``dur`` in
  microseconds from the tracer's epoch);
* instant markers (duration 0) -> ``ph: "i"`` with thread scope;
* one ``thread_name`` metadata event (``ph: "M"``) a recording thread, so
  the prefetch thread and the training loop come out as named tracks,
  and one ``process_name`` event;
* the metrics registry's snapshot and the tracer's accounting in
  ``otherData``.

``pid`` is the caller's: on a multi-rank run each rank exports with its
rank as ``pid``, so the ranks' files merge (their ``traceEvents``
concatenated) into one trace with a process track a rank. The process
is named ``repro_torch`` where the reference names it ``repro``; nothing
else differs.

``validate_chrome_trace`` returns a list of violations (empty: valid)
instead of raising, so a caller asserts on emptiness and prints them all
on failure.
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry, metrics
from repro_torch.obs.tracer import Span, Tracer, get_tracer

__all__ = ["to_chrome_trace", "write_chrome_trace",
           "validate_chrome_trace"]

PROCESS_NAME = "repro_torch"


def _args_of(s: Span) -> dict:
    # the viewers show args as key / value: keep the values JSON-clean
    out = {}
    for k, v in s.attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = repr(v) if not isinstance(v, (list, tuple, dict)) \
                else json.loads(json.dumps(v, default=str))
    return out


def to_chrome_trace(tracer: Optional[Tracer] = None,
                    registry: Optional[MetricsRegistry] = None,
                    pid: int = 1) -> dict:
    """Render the collected spans as a Trace-Event-Format object."""
    tracer = tracer or get_tracer()
    registry = registry or metrics()
    spans = tracer.snapshot()
    events: list[dict] = []
    seen_threads: dict[int, str] = {}
    for s in spans:
        if s.tid not in seen_threads:
            seen_threads[s.tid] = s.tname
        ev = {
            "name": s.name,
            "cat": s.category,
            "pid": pid,
            "tid": s.tid,
            "ts": s.t_start_ns / 1e3,          # µs
            "args": _args_of(s),
        }
        if s.dur_ns > 0:
            ev["ph"] = "X"
            ev["dur"] = s.dur_ns / 1e3
        else:
            ev["ph"] = "i"
            ev["s"] = "t"                       # thread-scoped instant
        events.append(ev)
    meta = [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
         "args": {"name": tname}}
        for tid, tname in sorted(seen_threads.items())
    ]
    meta.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": PROCESS_NAME}})
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "epoch_unix_s": tracer.epoch_unix_s,
            "n_spans": len(spans),
            "n_dropped": tracer.n_dropped,
            "metrics": registry.snapshot(),
        },
    }


def write_chrome_trace(path: str, tracer: Optional[Tracer] = None,
                       registry: Optional[MetricsRegistry] = None,
                       pid: int = 1) -> str:
    """Export to ``path`` (JSON); returns ``path``. Load the file in
    ``chrome://tracing`` or https://ui.perfetto.dev."""
    obj = to_chrome_trace(tracer, registry, pid=pid)
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


# --------------------------------------------------------------------------
# Schema check
# --------------------------------------------------------------------------

_PH_REQUIRED = {
    "X": ("name", "pid", "tid", "ts", "dur"),
    "i": ("name", "pid", "tid", "ts"),
    "M": ("name", "pid"),
}


def validate_chrome_trace(obj) -> list[str]:
    """Structural check of a Trace-Event JSON object (the subset this
    exporter emits, which is also what the viewers require). Returns a
    list of violation strings; empty means valid."""
    errs: list[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be a JSON object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["missing/invalid 'traceEvents' (must be a list)"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PH_REQUIRED:
            errs.append(f"{where}: unknown ph {ph!r}")
            continue
        for field in _PH_REQUIRED[ph]:
            if field not in ev:
                errs.append(f"{where} (ph={ph}): missing {field!r}")
        if "ts" in ev and not isinstance(ev["ts"], (int, float)):
            errs.append(f"{where}: ts must be a number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: dur must be a non-negative number")
        if "args" in ev and not isinstance(ev["args"], dict):
            errs.append(f"{where}: args must be an object")
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            errs.append(f"{where}: name must be a non-empty string")
    return errs
