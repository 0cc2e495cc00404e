"""Request-lifecycle tracing + bounded flight recorder.

A *trace* is the ordered list of span events one request passes through:

  submit -> verdict (admitted | queued | shed) -> [pumped] ->
  popped (queue wait ends) -> executed (batch dispatch) ->
  terminal (finished | shed | cancelled)

exactly one terminal event per submitted request — the trace-conservation
property the simulation suite asserts.  Timestamps come from the
recorder's injected `Clock` (`obs.clock`), so the deterministic
simulation harness produces byte-identical traces run to run.

Two recorder implementations share one call surface:

  NullRecorder  — the default: every hook is a no-op ``pass`` (no
                  allocation, no clock reads), so an engine without
                  tracing behaves bit-exactly like one that never heard
                  of this module.
  TraceRecorder — keeps per-request `RequestTrace`s (bounded completed
                  ring), feeds queue-wait / end-to-end latency
                  histograms into the bound `MetricsRegistry`, and logs
                  every event into a bounded ring-buffer
                  `FlightRecorder` the engine dumps on error.

The recorder observes; it never steers.  Engine/session code calls the
hooks with live `Request` objects (duck-typed: ``.sid``/``.kind``/
``.tenant`` — obs does not import the serve package).

Port of ``repro/obs/trace.py``, copied: pure Python.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.clock import MonotonicClock
from repro_torch.obs.metrics import MetricsRegistry

TERMINALS = ("finished", "shed", "cancelled")


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    name: str
    ts: float
    detail: str = ""


@dataclasses.dataclass
class RequestTrace:
    sid: str
    kind: str
    tenant: str
    events: List[SpanEvent] = dataclasses.field(default_factory=list)

    @property
    def terminal(self) -> Optional[str]:
        for ev in reversed(self.events):
            if ev.name in TERMINALS:
                return ev.name
        return None

    def ts_of(self, name: str) -> Optional[float]:
        """Timestamp of the FIRST event with this name (None if absent)."""
        for ev in self.events:
            if ev.name == name:
                return ev.ts
        return None

    def span(self, start: str, end: str) -> Optional[float]:
        """Seconds between the first ``start`` and first ``end`` event;
        None when either is absent (e.g. queue wait of a shed request)."""
        t0, t1 = self.ts_of(start), self.ts_of(end)
        return None if t0 is None or t1 is None else t1 - t0


class FlightRecorder:
    """Bounded ring buffer of recent (ts, event, detail) triples.  Old
    events fall off the back — memory stays O(capacity) forever; the
    engine dumps the buffer to stderr when an exception escapes a
    drain, so the last moments before a crash are always available."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("flight recorder needs capacity >= 1")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, ts: float, event: str, detail: str = "") -> None:
        self._ring.append((ts, event, detail))

    def events(self) -> List[Tuple[float, str, str]]:
        return list(self._ring)

    def lines(self) -> List[str]:
        return [f"[t={ts:.6f}] {event}" + (f" {detail}" if detail else "")
                for ts, event, detail in self._ring]


class NullRecorder:
    """Do-nothing recorder: the engine's default.  Every hook is a bare
    ``pass`` — no clock reads, no allocation — so the disabled path is
    bit-exact with (and as fast as) a never-instrumented engine."""
    enabled = False

    def bind(self, clock, registry) -> None:
        pass

    # -- request lifecycle --------------------------------------------
    def submit(self, req) -> None:
        pass

    def admitted(self, req) -> None:
        pass

    def backlogged(self, req, reason: str = "") -> None:
        pass

    def pumped(self, req) -> None:
        pass

    def popped(self, req) -> None:
        pass

    def executed(self, req, detail: str = "") -> None:
        pass

    def finished(self, req) -> None:
        pass

    def shed(self, req, reason: str = "") -> None:
        pass

    def cancelled(self, req) -> None:
        pass

    # -- batch / session events (flight recorder only) ----------------
    def note(self, event: str, detail: str = "") -> None:
        pass

    # -- introspection -------------------------------------------------
    def flight_lines(self) -> List[str]:
        return []

    def trace_of(self, req) -> Optional[RequestTrace]:
        return None


class TraceRecorder(NullRecorder):
    """Real tracing: per-request span events, latency histograms,
    flight-recorder feed.

    ``keep_completed`` bounds the retained finished traces (ring — the
    histograms keep the aggregate view forever; traces are for
    debugging and tests).  Active traces are keyed by request object
    identity: callers hold their `Request`s for the request's lifetime
    (the scheduler queue, the engine ledger, and test drivers all do),
    so identity is stable from submit to terminal."""
    enabled = True

    def __init__(self, clock=None, registry: Optional[MetricsRegistry] = None,
                 flight_capacity: int = 256, keep_completed: int = 4096):
        self.clock = clock or MonotonicClock()
        self.flight = FlightRecorder(flight_capacity)
        self._active: Dict[int, Tuple[object, RequestTrace]] = {}
        self._completed: deque = deque(maxlen=keep_completed)
        self._completed_by_key: Dict[int, RequestTrace] = {}
        self._registry: Optional[MetricsRegistry] = None
        self._h_wait = self._h_e2e = None
        if registry is not None:
            self.bind(self.clock, registry)

    def bind(self, clock, registry: MetricsRegistry) -> None:
        """Attach the owning engine's clock + registry (idempotent)."""
        if clock is not None:
            self.clock = clock
        self._registry = registry
        self._h_wait = registry.histogram(
            "serve_queue_wait_seconds",
            "seconds between admission into the scheduler queue and the "
            "batch pop that served the request", labels=("kind",))
        self._h_e2e = registry.histogram(
            "serve_e2e_latency_seconds",
            "seconds between submit and delivery (finished requests "
            "only)", labels=("kind",))

    # -- internals -----------------------------------------------------
    def _event(self, req, name: str, detail: str = "") -> None:
        ts = self.clock.now()
        key = id(req)
        entry = self._active.get(key)
        if entry is None:
            trace = RequestTrace(sid=req.sid, kind=req.kind,
                                 tenant=req.tenant)
            self._active[key] = (req, trace)
        else:
            trace = entry[1]
        trace.events.append(SpanEvent(name, ts, detail))
        self.flight.record(
            ts, name, f"sid={req.sid} kind={req.kind}"
            + (f" {detail}" if detail else ""))
        if name in TERMINALS:
            self._active.pop(key, None)
            self._completed.append(trace)
            self._completed_by_key[key] = trace
            if len(self._completed_by_key) > 2 * self._completed.maxlen:
                live = set(id(t) for t in self._completed)
                self._completed_by_key = {
                    k: t for k, t in self._completed_by_key.items()
                    if id(t) in live}

    # -- request lifecycle --------------------------------------------
    def submit(self, req) -> None:
        self._event(req, "submit", f"len={req.token_len}")

    def admitted(self, req) -> None:
        self._event(req, "admitted")

    def backlogged(self, req, reason: str = "") -> None:
        self._event(req, "queued", reason)

    def pumped(self, req) -> None:
        self._event(req, "pumped")

    def popped(self, req) -> None:
        self._event(req, "popped")
        trace = self.trace_of(req)
        if trace is not None and self._h_wait is not None:
            # queue wait starts at the LAST entry into the queue — a
            # pumped request waited in the backlog first; its scheduler
            # wait is pop - pump, its total wait is pop - submit (both
            # recoverable from the trace; the histogram takes the
            # scheduler wait)
            t_pop = trace.events[-1].ts
            t_in = trace.ts_of("pumped")
            if t_in is None:
                t_in = trace.ts_of("admitted")
            if t_in is not None:
                self._h_wait.labels(kind=req.kind).observe(t_pop - t_in)

    def executed(self, req, detail: str = "") -> None:
        self._event(req, "executed", detail)

    def finished(self, req) -> None:
        self._event(req, "finished")
        trace = self.trace_of(req)
        if trace is not None and self._h_e2e is not None:
            dt = trace.span("submit", "finished")
            if dt is not None:
                self._h_e2e.labels(kind=req.kind).observe(dt)

    def shed(self, req, reason: str = "") -> None:
        self._event(req, "shed", reason)

    def cancelled(self, req) -> None:
        self._event(req, "cancelled")

    # -- batch / session events ---------------------------------------
    def note(self, event: str, detail: str = "") -> None:
        self.flight.record(self.clock.now(), event, detail)

    # -- introspection -------------------------------------------------
    def flight_lines(self) -> List[str]:
        return self.flight.lines()

    def trace_of(self, req) -> Optional[RequestTrace]:
        entry = self._active.get(id(req))
        if entry is not None:
            return entry[1]
        return self._completed_by_key.get(id(req))

    @property
    def active(self) -> List[RequestTrace]:
        return [t for _, t in self._active.values()]

    @property
    def completed(self) -> List[RequestTrace]:
        return list(self._completed)
