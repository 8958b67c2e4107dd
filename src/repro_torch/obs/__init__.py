"""repro_torch.obs — spans, metrics and fit reports for the whole port.

Three layers, one import:

  * tracer  — thread-safe `span()` context managers on named lanes (driver +
    one lane per device producer), near-free and allocation-free when
    disabled; export to Chrome trace-event JSON (Perfetto) or JSONL.
  * metrics — always-on counters/gauges/histograms in one registry
    (`engine.blocks_read`, `engine.bytes_h2d`, `engine.passes.<label>`,
    `serve.latency_ms`, ...), scoped by snapshot/delta, thread-safe under the
    stream engine's producer thread, which counts while the driver reads.
  * report  — `FitReport`, the structured record every backend fit and sweep
    returns (phase wall-times, per-iteration inertia trajectory, pass counts,
    bytes, per-device block counts), plus the roofline join that compares
    measured phase time against `repro_torch.roofline.analysis` terms.

A span is host time (`perf_counter`): around work that is queued on the
card without a sync (a launch, a `non_blocking` copy) it times the enqueue,
not the device. No span synchronises; the estimator's phase spans close
after the sync the phase already makes.

See DESIGN.md §13 for the span taxonomy and metric-name table.
"""
from repro_torch.obs.export import (
    chrome_trace_events,
    write_chrome_trace,
    write_jsonl,
    write_trace,
)
from repro_torch.obs.metrics import (
    METRICS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    delta,
    gauge,
    histogram,
    reset_metrics,
    scoped,
    snapshot,
)
from repro_torch.obs.report import (
    FitReport,
    join_fit_roofline,
    report_from_metrics_delta,
    roofline_join,
)
from repro_torch.obs.tracer import (
    NULL_SPAN,
    TRACER,
    Span,
    Tracer,
    clear_trace,
    disable_tracing,
    enable_tracing,
    instant,
    set_lane,
    span,
    tracing_enabled,
)

__all__ = [
    "METRICS", "NULL_SPAN", "TRACER",
    "Counter", "FitReport", "Gauge", "Histogram", "MetricsRegistry", "Span",
    "Tracer",
    "chrome_trace_events", "clear_trace", "counter", "delta",
    "disable_tracing", "enable_tracing", "gauge", "histogram", "instant",
    "join_fit_roofline", "report_from_metrics_delta", "reset_metrics",
    "roofline_join", "scoped", "set_lane", "snapshot", "span",
    "tracing_enabled", "write_chrome_trace", "write_jsonl", "write_trace",
]
