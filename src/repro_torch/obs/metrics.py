"""Typed host-side metrics: counters, gauges, fixed-bucket histograms.

Prometheus-shaped but dependency-free.  Metrics are *families* keyed by
a name plus declared label names; ``family.labels(kind="query")``
returns (creating on demand) the child holding the actual value.  A
family declared with no labels proxies the single default child, so
``reg.counter("x").inc()`` just works.

Histograms are fixed-bucket with NO per-sample storage: ``observe``
lands each sample in the first bucket whose upper bound is >= the
sample (plus an overflow bucket), keeping O(len(buckets)) memory at any
traffic volume.  Quantiles are extracted from the cumulative bucket
counts and always return a bucket UPPER BOUND — a conservative estimate
that is *exact* whenever the samples sit on bucket boundaries (which is
what the deterministic simulation clock produces, and what the property
suite asserts: merge associativity, monotone quantiles,
bucket-boundary exactness).

Snapshots export two ways (same data):

  registry.snapshot()       — plain-JSON dict (committed benchmark files,
                              CI artifacts)
  registry.to_prometheus()  — Prometheus text exposition format
                              (``render_prometheus`` also re-renders a
                              saved snapshot dict, used by
                              scripts/serve_metrics.py --from-json)

Port of ``repro/obs/metrics.py``, copied: pure Python.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# default latency ladder (seconds): wide enough for micro-dispatches up
# to multi-minute drains; sub-ms resolution where serve batches live
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    1e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)


class Counter:
    """Monotonically non-decreasing value (int or float increments)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n


class Gauge:
    """Point-in-time value (set to anything, any direction)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram; no per-sample storage.

    ``bounds`` are strictly-increasing finite upper bounds; an implicit
    +Inf overflow bucket is always appended.  ``counts[i]`` is the
    number of samples with ``value <= bounds[i]`` that did not fit an
    earlier bucket (i.e. per-bucket, not cumulative)."""
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float] = DEFAULT_TIME_BUCKETS):
        bounds = tuple(float(b) for b in bounds)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(
                f"bucket bounds must be strictly increasing: {bounds}")
        if not all(math.isfinite(b) for b in bounds):
            raise ValueError("bucket bounds must be finite "
                             "(+Inf overflow is implicit)")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)     # +1 = overflow (+Inf)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = 0
        n = len(self.bounds)
        while i < n and value > self.bounds[i]:
            i += 1
        self.counts[i] += 1
        self.sum += value
        self.count += 1

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile sample.

        Exact when samples sit on bucket boundaries; otherwise a
        conservative (>= true value) estimate.  Returns 0.0 for an
        empty histogram and ``inf`` when the quantile falls in the
        overflow bucket (samples beyond the largest finite bound —
        widen the ladder rather than trusting that number)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self.bounds[i] if i < len(self.bounds) \
                    else math.inf
        return math.inf                            # unreachable

    def percentiles(self) -> Dict[str, float]:
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def merge(self, other: "Histogram") -> "Histogram":
        """Combine two histograms over the SAME bucket ladder.  With
        integer-valued sums the operation is exact and associative —
        merging per-shard histograms loses nothing vs one global one."""
        if self.bounds != other.bounds:
            raise ValueError("cannot merge histograms with different "
                             f"bucket ladders: {self.bounds} vs "
                             f"{other.bounds}")
        out = Histogram(self.bounds)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.sum = self.sum + other.sum
        out.count = self.count + other.count
        return out


class _Family:
    """One named metric with declared label names and per-label-values
    children."""

    def __init__(self, name: str, help: str, label_names: Tuple[str, ...],
                 make_child):
        self.name = name
        self.help = help
        self.label_names = label_names
        self._make = make_child
        self._children: Dict[Tuple[str, ...], object] = {}
        if not label_names:
            self._children[()] = make_child()

    def labels(self, **kv):
        if tuple(sorted(kv)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = self._make()
        return child

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        return sorted(self._children.items())

    # no-label convenience: proxy the default child
    def _default(self):
        if self.label_names:
            raise ValueError(
                f"metric {self.name!r} is labelled {self.label_names}; "
                "use .labels(...)")
        return self._children[()]

    def inc(self, n=1):
        self._default().inc(n)

    def set(self, v):
        self._default().set(v)

    def observe(self, v):
        self._default().observe(v)

    @property
    def value(self):
        return self._default().value

    def aggregate(self) -> Histogram:
        """Merge all children of a histogram family into one histogram
        (e.g. per-kind latency children -> overall percentiles)."""
        hists = [c for _, c in self.children()]
        if not hists or not isinstance(hists[0], Histogram):
            raise ValueError(f"{self.name!r} is not a histogram family")
        out = Histogram(hists[0].bounds)
        for h in hists:
            out = out.merge(h)
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Holds metric families; declaration is idempotent (re-declaring
    the same name with the same type/labels returns the existing
    family; a conflicting re-declaration raises)."""

    def __init__(self):
        self._families: Dict[str, Tuple[str, _Family]] = {}

    def _declare(self, kind: str, name: str, help: str,
                 labels: Sequence[str], make_child) -> _Family:
        if not _NAME.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labels = tuple(labels)
        for l in labels:
            if not _LABEL.match(l):
                raise ValueError(f"invalid label name {l!r}")
        existing = self._families.get(name)
        if existing is not None:
            ekind, fam = existing
            if ekind != kind or fam.label_names != labels:
                raise ValueError(
                    f"metric {name!r} already declared as {ekind} with "
                    f"labels {fam.label_names}")
            return fam
        fam = _Family(name, help, labels, make_child)
        self._families[name] = (kind, fam)
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._declare("counter", name, help, labels, Counter)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._declare("gauge", name, help, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS
                  ) -> _Family:
        bounds = tuple(float(b) for b in buckets)
        fam = self._declare("histogram", name, help, labels,
                            lambda: Histogram(bounds))
        return fam

    def get(self, name: str) -> Optional[_Family]:
        entry = self._families.get(name)
        return entry[1] if entry else None

    # -- export --------------------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        """Plain-JSON dict of every family (stable key order)."""
        out: Dict[str, dict] = {}
        for name in sorted(self._families):
            kind, fam = self._families[name]
            values = []
            for key, child in fam.children():
                labels = dict(zip(fam.label_names, key))
                if kind == "histogram":
                    values.append({
                        "labels": labels,
                        "buckets": list(child.bounds),
                        "counts": list(child.counts),
                        "sum": child.sum, "count": child.count,
                        **{k: _json_num(v)
                           for k, v in child.percentiles().items()}})
                else:
                    values.append({"labels": labels,
                                   "value": _json_num(child.value)})
            out[name] = {"type": kind, "help": fam.help, "values": values}
        return out

    def to_prometheus(self) -> str:
        return render_prometheus(self.snapshot())


def _json_num(v):
    """inf/nan are not JSON — encode as strings (rare: overflow-bucket
    quantiles only)."""
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    return v


def _fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_esc(v)}"' for k, v in labels.items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _esc(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _fmt_value(v) -> str:
    if isinstance(v, str):          # _json_num-encoded inf/nan
        return {"inf": "+Inf", "-inf": "-Inf"}.get(v, "NaN")
    if isinstance(v, float):
        return repr(v)
    return str(v)


def render_prometheus(snapshot: Dict[str, dict]) -> str:
    """Prometheus text exposition of a ``MetricsRegistry.snapshot()``
    dict (shared by live registries and saved-snapshot re-rendering)."""
    lines: List[str] = []
    for name in sorted(snapshot):
        meta = snapshot[name]
        if meta["help"]:
            lines.append(f"# HELP {name} {meta['help']}")
        lines.append(f"# TYPE {name} {meta['type']}")
        for val in meta["values"]:
            labels = val["labels"]
            if meta["type"] == "histogram":
                cum = 0
                bounds = list(val["buckets"]) + [math.inf]
                for le, c in zip(bounds, val["counts"]):
                    cum += c
                    le_s = "+Inf" if math.isinf(le) else repr(float(le))
                    le_label = 'le="' + le_s + '"'
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, le_label)} {cum}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(val['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(labels)} "
                             f"{val['count']}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)} "
                             f"{_fmt_value(val['value'])}")
    return "\n".join(lines) + "\n"
