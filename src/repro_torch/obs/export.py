"""Span export: JSONL for scripts, Chrome trace-event JSON for Perfetto.

The Chrome format (https://ui.perfetto.dev loads it directly) is a flat list
of events under a `traceEvents` key. We emit:

  * one `ph: "M"` (metadata) `thread_name` event per lane, naming the row —
    "main" for the driver, "producer:<device>" for each prefetcher thread;
  * one `ph: "X"` (complete) event per span, `ts`/`dur` in MICROseconds,
    span attributes under `args`.

`pid` is constant (one process); `tid` is the lane index in first-seen order,
so a sharded fit renders with one swimlane per device producer above the
driver lane — the mapper-utilization picture of the paper's job layout.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

from repro_torch.obs.tracer import TRACER, Span, Tracer

_PID = 1


def _lane_tids(spans: Sequence[Span]) -> dict[str, int]:
    tids: dict[str, int] = {}
    for s in spans:
        if s.lane not in tids:
            # tid 0 reads as the process row in some viewers; start at 1
            tids[s.lane] = len(tids) + 1
    return tids


def chrome_trace_events(spans: Sequence[Span], *, epoch: float = 0.0) -> list:
    """Spans -> Chrome trace-event dicts (thread_name metadata first)."""
    tids = _lane_tids(spans)
    events: list[dict] = [
        {
            "name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
            "args": {"name": lane},
        }
        for lane, tid in tids.items()
    ]
    for s in spans:
        events.append({
            "name": s.name, "cat": s.cat, "ph": "X", "pid": _PID,
            "tid": tids[s.lane],
            "ts": (epoch + s.t0) * 1e6,
            "dur": s.dur * 1e6,
            "args": {k: _jsonable(v) for k, v in s.attrs.items()},
        })
    return events


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def write_chrome_trace(path: str | Path, *, tracer: Tracer | None = None) -> Path:
    """Dump the tracer's spans as a Perfetto-loadable trace file."""
    tracer = tracer if tracer is not None else TRACER
    doc = {
        "traceEvents": chrome_trace_events(tracer.spans()),
        "displayTimeUnit": "ms",
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc))
    return path


def write_jsonl(path: str | Path, *, tracer: Tracer | None = None) -> Path:
    """One JSON object per span: {name, cat, lane, t0, dur, ...attrs}."""
    tracer = tracer if tracer is not None else TRACER
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        for s in tracer.spans():
            rec = {
                "name": s.name, "cat": s.cat, "lane": s.lane,
                "t0": s.t0, "dur": s.dur,
            }
            rec.update({k: _jsonable(v) for k, v in s.attrs.items()})
            f.write(json.dumps(rec) + "\n")
    return path


def write_trace(path: str | Path, *, tracer: Tracer | None = None) -> Path:
    """Format by suffix: `.jsonl` -> span-per-line JSONL, anything else ->
    Chrome trace-event JSON."""
    path = Path(path)
    if path.suffix == ".jsonl":
        return write_jsonl(path, tracer=tracer)
    return write_chrome_trace(path, tracer=tracer)
