"""The port's trace export (``repro_torch.obs.export``) and JSONL metrics
sink against the JAX reference's, on the CPU.

The same spans, tracer accounting and metrics give the same Trace-Event
JSON in both packages; the one stated difference is the process track's
name (``repro_torch`` where the reference writes ``repro``). The schema
check gives the same violations on the same malformed objects, the
metrics sink the same record keys. A multi-rank run exports with its
rank as ``pid``: two ranks' files merge into one valid trace with a
process track a rank."""
import importlib
import json

import numpy as np
import pytest

from repro import obs as jobs

from repro_torch import obs

# the packages' ``metrics`` / ``tracer`` names are functions: import the
# modules by path
jexport, jmetrics, jtracer = (importlib.import_module(f"repro.obs.{m}")
                              for m in ("export", "metrics", "tracer"))
texport, tmetrics, ttracer = (importlib.import_module(f"repro_torch.obs.{m}")
                              for m in ("export", "metrics", "tracer"))

# name, start, duration (ns), thread, thread name, depth, attrs: complete
# and instant events, two threads, attrs of every kind the exporter maps
SPANS = [
    ("train.epoch", 1_000, 9_000_000, 11, "MainThread", 0, {"epoch": 0}),
    ("train.step", 2_500, 4_000_123, 11, "MainThread", 1,
     {"step": 3, "grad_sync": "fp32", "sampler": None, "ok": True}),
    ("loader.sample", 1_700, 350_000, 22, "prefetch", 0,
     {"batch": 1, "shape": (64, 602), "plan": {"kind": "ell", "c": 8}}),
    ("tuning.pick", 5_000, 0, 11, "MainThread", 1,
     {"winner": "sell", "ms": 0.25, "cands": ["ell", "sell"],
      "obj": np.float32(1.5)}),
    ("op.ell_spmm", 3_000, 12_345, 11, "MainThread", 2,
     {"backend": "cuda", "shape": [20992, 602]}),
]


def _tracers():
    """A fresh tracer of each package holding the same spans and
    accounting."""
    out = []
    for mod in (jtracer, ttracer):
        tr = mod.Tracer()
        tr.spans = [mod.Span(*s) for s in SPANS]
        tr.epoch_unix_s = 1_700_000_000.25
        tr.n_dropped = 2
        out.append(tr)
    return out


def _registries():
    out = []
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry()
        reg.counter("train.skipped_steps").inc(1)
        reg.gauge("serve.queue").set(3.5)
        hist = reg.histogram("serve.latency_ms")
        for v in (1.0, 2.0, 4.0, 8.0):
            hist.observe(v)
        out.append(reg)
    return out


def _process_names(obj) -> list:
    return [ev["args"]["name"] for ev in obj["traceEvents"]
            if ev["name"] == "process_name"]


@pytest.mark.parametrize("pid", [1, 3])
def test_to_chrome_trace_matches_reference(pid):
    (jtr, ttr), (jreg, treg) = _tracers(), _registries()
    want = jexport.to_chrome_trace(jtr, jreg, pid=pid)
    got = texport.to_chrome_trace(ttr, treg, pid=pid)
    assert _process_names(want) == ["repro"]
    assert _process_names(got) == ["repro_torch"]
    for obj in (want, got):
        for ev in obj["traceEvents"]:
            if ev["name"] == "process_name":
                ev["args"]["name"] = "<process>"
    # the same JSON text, key order included
    assert json.dumps(got) == json.dumps(want)
    assert texport.validate_chrome_trace(got) == []
    assert {ev["pid"] for ev in got["traceEvents"]} == {pid}
    assert got["otherData"]["n_spans"] == len(SPANS)


def test_write_chrome_trace_roundtrips_with_the_callers_pid(tmp_path):
    """Two ranks export with their rank as pid; the files merge into one
    trace that validates and holds a process track a rank."""
    objs = []
    for rank in (0, 1):
        (_, ttr), (_, treg) = _tracers(), _registries()
        path = texport.write_chrome_trace(str(tmp_path / f"r{rank}.json"),
                                          ttr, treg, pid=rank)
        objs.append(json.loads(open(path).read()))
        assert objs[-1] == texport.to_chrome_trace(ttr, treg, pid=rank)
    merged = {"traceEvents": objs[0]["traceEvents"] +
              objs[1]["traceEvents"], "displayTimeUnit": "ms"}
    assert obs.validate_chrome_trace(merged) == []
    tracks = {ev["pid"] for ev in merged["traceEvents"]
              if ev["name"] == "process_name"}
    steps = {ev["pid"] for ev in merged["traceEvents"]
             if ev["name"] == "train.step"}
    assert tracks == steps == {0, 1}


MALFORMED = [
    [],
    "trace",
    {},
    {"traceEvents": {}},
    {"traceEvents": [1, "x", None]},
    {"traceEvents": [{"ph": "B", "name": "a"}]},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1}]},
    {"traceEvents": [{"ph": "X", "name": "", "pid": 1, "tid": 1,
                      "ts": "0", "dur": -1, "args": []}]},
    {"traceEvents": [{"ph": "i", "name": 5, "pid": 1, "tid": 1}]},
    {"traceEvents": [{"ph": "M", "pid": 1},
                     {"ph": "X", "name": "ok", "pid": 1, "tid": 2,
                      "ts": 1.5, "dur": "2"}]},
    {"traceEvents": [{"ph": "X", "name": "ok", "pid": 1, "tid": 2,
                      "ts": 1.5, "dur": 0.0, "args": {}}]},
]


@pytest.mark.parametrize("obj", MALFORMED)
def test_validate_chrome_trace_matches_reference(obj):
    assert texport.validate_chrome_trace(obj) == \
        jexport.validate_chrome_trace(obj)


def test_metrics_to_jsonl_writes_the_reference_record(tmp_path):
    (jreg, treg) = _registries()
    want = jmetrics.metrics_to_jsonl(str(tmp_path / "j.jsonl"), jreg,
                                     rank=1, run="dp")
    got = obs.metrics_to_jsonl(str(tmp_path / "t.jsonl"), treg, rank=1,
                               run="dp")
    obs.metrics_to_jsonl(str(tmp_path / "t.jsonl"), treg, rank=1, run="dp")
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    assert len(lines) == 2                     # appended, one line each
    rec = json.loads(lines[0])
    assert set(rec) == set(want) == {"ts", "metrics", "rank", "run"}
    assert rec["metrics"] == json.loads(json.dumps(want["metrics"]))
    assert set(got["metrics"]) == set(want["metrics"])
    assert set(rec["metrics"]["serve.latency_ms"]) == \
        set(want["metrics"]["serve.latency_ms"])


def test_obs_exports_the_export_names():
    for name in ("to_chrome_trace", "write_chrome_trace",
                 "validate_chrome_trace", "metrics_to_jsonl"):
        assert name in obs.__all__ and callable(getattr(obs, name))
        assert hasattr(jobs, name)
