"""The port's observability layer (copied from ``repro.obs``) against the
reference: registries fed the same operations export the same JSON and
Prometheus text; the clocks and flight recorder behave alike; a traced
engine traces the same request spans; ``TrainLoop`` times steps on the
port's monotonic clock by default.  Everything compared is exact (host
bookkeeping only; the ManualClock makes timestamps deterministic).
"""
import json
import re

import numpy as np
import pytest

from repro.launch import serve as JSRV
from repro.obs import (FlightRecorder as JFlight, ManualClock as JClock,
                       MetricsRegistry as JReg, Observability as JObs)
from repro.serve import ServeEngine as JEngine
from repro_torch.launch import serve as PSRV
from repro_torch.obs import (FlightRecorder as PFlight, ManualClock as PClock,
                             MetricsRegistry as PReg, Observability as PObs,
                             perf_counter, render_prometheus)
from repro_torch.serve import ServeEngine as PEngine

BOUNDS = (0.5, 1.0, 2.0, 5.0, 10.0)


def _feed(reg):
    reg.counter("req_total", "requests", labels=("kind",)).labels(
        kind="query").inc(3)
    reg.counter("req_total", "requests", labels=("kind",)).labels(
        kind="ingest").inc(1)
    reg.gauge("depth", "queue depth").set(7)
    h = reg.histogram("lat_seconds", "latency", buckets=BOUNDS,
                      labels=("shard",))
    for i, v in enumerate([0.5, 1.0, 1.5, 2.0, 3.0, 42.0, 0.1, 9.9]):
        h.labels(shard=str(i % 2)).observe(v)
    return reg


def test_registry_exports_match_reference():
    j, p = _feed(JReg()), _feed(PReg())
    assert p.snapshot() == j.snapshot()
    assert p.to_prometheus() == j.to_prometheus()
    json.dumps(p.snapshot())
    assert render_prometheus(p.snapshot()) == p.to_prometheus()
    with pytest.raises(ValueError):
        p.gauge("req_total")                     # type conflict
    with pytest.raises(ValueError):
        p.counter("req_total", "requests", labels=("kind",)).labels(
            kind="a").inc(-1)                    # counters are monotonic


def test_clocks_and_flight_recorder_match_reference():
    jc, pc = JClock(5.0), PClock(5.0)
    assert pc.now() == jc.now() == 5.0
    assert pc.advance(2.5) == jc.advance(2.5) == 7.5
    with pytest.raises(ValueError):
        pc.advance(-1.0)
    a, b = perf_counter(), perf_counter()
    assert b >= a
    jf, pf = JFlight(capacity=4), PFlight(capacity=4)
    for i in range(10):
        jf.record(float(i), f"ev{i}")
        pf.record(float(i), f"ev{i}")
    assert pf.lines() == jf.lines() and len(pf) == 4


def test_traced_engine_spans_match_reference():
    """Null steps (control plane only): the same submits, runs, offload
    and close give the same recorder lines and latency histograms."""
    from test_torch_serve import _cfgs

    jc, pc = _cfgs()
    kw = dict(n_slots=2, cache_len=32, batch_buckets=(1, 2, 4),
              max_queued_tokens=12)
    je = JEngine(None, jc, step_factory=JSRV.make_null_step,
                 obs=JObs.tracing(clock=JClock()), **kw)
    pe = PEngine(None, pc, step_factory=PSRV.make_null_step,
                 obs=PObs.tracing(clock=PClock()), device="cpu", **kw)
    for eng in (je, pe):
        for sid, tenant in (("a", "t0"), ("b", "t1"), ("c", "t0")):
            eng.create_session(sid, tenant=tenant)
        clock = eng.obs.clock
        for sid, op, n in (("a", "ingest", 4), ("b", "ingest", 8),
                           ("a", "query", 4), ("c", "ingest", 16),
                           ("b", "query", 2)):
            clock.advance(1.0)
            getattr(eng, op)(sid, np.zeros(n, np.int32))
        clock.advance(1.0)
        eng.run(max_batches=2)
        eng.offload_session("a")
        clock.advance(1.0)
        eng.run()
        eng.close_session("b")
    # transfer notes name their bytes: the port's rows hold the tensor
    # leaves only (its counters stay on the host), the reference's also
    # five int32 counters
    strip = lambda lines: [re.sub(r"bytes=\d+ ", "", x) for x in lines]  # noqa: E731
    assert strip(pe.obs.recorder.flight_lines()) == \
        strip(je.obs.recorder.flight_lines())
    sb = pe._mgr["online"].arena.state_bytes
    assert any(f"rows=1 shard=0 bytes={sb} " in x
               for x in pe.obs.recorder.flight_lines())
    js, ps = je.metrics_snapshot()["metrics"], pe.metrics_snapshot()["metrics"]
    for name in ("serve_queue_wait_seconds", "serve_e2e_latency_seconds"):
        if name in js:
            assert ps[name] == js[name]
    assert len(pe.obs.recorder.completed) == len(je.obs.recorder.completed)


def test_train_loop_times_steps_on_the_port_clock(monkeypatch):
    """Without an injected clock, TrainLoop reads the port's monotonic
    clock (``repro_torch.obs.clock``), so every step has a time."""
    import torch

    from repro_torch.core.masks import segment_layout
    from repro_torch.launch import train as PTR
    from repro_torch.models.config import CCMConfig, ModelConfig
    from repro_torch.obs import clock as pclock
    from repro_torch.optim.adamw import AdamWConfig

    ticks = iter(np.arange(0.0, 100.0, 0.5))
    monkeypatch.setattr(pclock._DEFAULT, "now", lambda: float(next(ticks)))
    cfg = ModelConfig(name="tiny", family="dense", n_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=128,
                      compute_dtype="float32",
                      ccm=CCMConfig(comp_len=2, max_steps=2))
    loop = PTR.TrainLoop(cfg, segment_layout(2, 4, 2, 4), AdamWConfig(), 2,
                         device="cpu")
    hist = loop.run(2, log_every=0)
    assert [h["dt"] for h in hist] == [0.5, 0.5]
    assert torch.isfinite(torch.tensor([h["loss"] for h in hist])).all()
