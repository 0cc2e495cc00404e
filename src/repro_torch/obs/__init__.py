"""Host-side observability for the serve stack (and any other module
that needs a clock or a counter).

Three pieces, one bundle:

  metrics.py — typed `MetricsRegistry` (counters / gauges / fixed-bucket
               histograms with p50/p95/p99 extraction, no per-sample
               storage), JSON + Prometheus export
  trace.py   — per-request lifecycle spans (submit -> verdict -> queue
               wait -> execute -> terminal), bounded `FlightRecorder`
               ring the engine dumps on error; `NullRecorder` keeps the
               disabled path allocation-free
  clock.py   — injectable time source: `MonotonicClock` in production,
               `ManualClock` under the deterministic simulation harness
               (`scripts/check_no_stray_timers.py` lints that raw
               ``time.*`` calls exist nowhere else in ``src/``)

`Observability` wires the three together; `ServeEngine(obs=...)`
threads the bundle through scheduler, admission, session manager and
arena instrumentation.  Everything here is host-side Python — no
metric, span, or clock read runs on the device, so the kernels the
engine launches are the same whether tracing is on or off.

Port of ``repro/obs/__init__.py``, copied: the obs layer is pure Python.
"""
from repro_torch.obs.clock import ManualClock, MonotonicClock, perf_counter
from repro_torch.obs.metrics import (DEFAULT_TIME_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     render_prometheus)
from repro_torch.obs.trace import (FlightRecorder, NullRecorder, RequestTrace,
                                   SpanEvent, TraceRecorder)


class Observability:
    """Bundle of (registry, clock, recorder) one engine threads through
    its serve stack.

    The registry and clock are ALWAYS live (counters are cheap dict
    bumps; the clock is read on the host only) — that is what lets the
    engine's legacy ``stats`` dicts become thin views over registry
    counters with zero behavior change.  Only the *recorder* is
    optional: the default `NullRecorder` makes every trace/flight hook
    a no-op, and `Observability.tracing()` swaps in a `TraceRecorder`
    (bound to the same clock + registry) for per-request spans, latency
    histograms and the crash flight buffer."""

    def __init__(self, registry: MetricsRegistry = None, clock=None,
                 recorder=None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.clock = clock if clock is not None else MonotonicClock()
        self.recorder = recorder if recorder is not None \
            else NullRecorder()
        self.recorder.bind(self.clock, self.registry)

    @classmethod
    def tracing(cls, clock=None, flight_capacity: int = 256,
                keep_completed: int = 4096) -> "Observability":
        """Fully-enabled bundle: traces + flight recorder + histograms."""
        return cls(clock=clock,
                   recorder=TraceRecorder(flight_capacity=flight_capacity,
                                          keep_completed=keep_completed))


__all__ = ["Counter", "DEFAULT_TIME_BUCKETS", "FlightRecorder", "Gauge",
           "Histogram", "ManualClock", "MetricsRegistry",
           "MonotonicClock", "NullRecorder", "Observability",
           "RequestTrace", "SpanEvent", "TraceRecorder", "perf_counter",
           "render_prometheus"]
