"""Process-wide metric registry: counters, gauges, bounded histograms.

A copy of the reference package's ``obs/registry.py`` (standard library
only), with its metric names, labels and histogram edges unchanged,
because the probes print them. One module-level :data:`REGISTRY` is the
process default: the GTP ``rocalphago-stats`` probe returns its
:func:`snapshot`, and the GTP CLI writes it to ``metrics.jsonl`` at the
end of a session (event ``registry``).

* Metrics are keyed by ``name`` plus sorted ``labels`` (Prometheus
  identity ``name{k="v"}``), get-or-create and thread-safe: ``_get``
  holds the registry lock, every update holds the metric's own lock,
  and ``Histogram.observe`` bisects the immutable ``edges`` tuple
  without a lock.
* Histograms are bounded: fixed ascending edges plus one overflow
  bucket; bucket semantics are Prometheus ``le`` (cumulative,
  edge-inclusive) in :meth:`Histogram.snapshot`.
* :func:`snapshot` is deterministic: the same recorded metrics give the
  same nested dict in the same sorted key order.
* :func:`render_text` emits the Prometheus text exposition shape.
"""

from __future__ import annotations

import bisect
import threading

#: default histogram edges (seconds): microbenchmark to slow-chunk
#: scale, the range every latency in this stack falls into
DEFAULT_EDGES = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

#: rate edges (per-second throughputs: sims/sec, positions/sec)
RATE_EDGES = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
              1000.0, 2500.0, 5000.0, 10000.0, 25000.0, 100000.0)

#: small-count edges (game plies, retries, queue depths)
COUNT_EDGES = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 350.0,
               500.0, 1000.0)


def _fmt(x) -> str:
    """Short stable float rendering for bucket keys ('0.01', '1')."""
    return format(float(x), "g")


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter. ``inc`` only — resets come from
    ``Registry.reset`` (tests), never production code."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins scalar (deadline margins, rates)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = None

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Bounded-bucket histogram over fixed ascending ``edges``.

    A value lands in the FIRST bucket whose edge is >= it (edge
    inclusive — Prometheus ``le``); values past the last edge land in
    the overflow bucket. ``snapshot`` returns cumulative ``le``
    counts plus ``sum``/``count``.
    """

    __slots__ = ("_lock", "edges", "counts", "count", "sum")

    def __init__(self, edges=DEFAULT_EDGES):
        edges = tuple(float(e) for e in edges)
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(
                f"histogram edges must be non-empty and strictly "
                f"ascending, got {edges}")
        self._lock = threading.Lock()
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)   # + overflow
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        idx = bisect.bisect_left(self.edges, v)
        with self._lock:
            self.counts[idx] += 1
            self.count += 1
            self.sum += v

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self.counts)
            total, s = self.count, self.sum
        buckets, cum = {}, 0
        for edge, c in zip(self.edges, counts):
            cum += c
            buckets[_fmt(edge)] = cum
        buckets["+Inf"] = total
        return {"count": total, "sum": round(s, 6),
                "buckets": buckets}


def quantile_from_buckets(snap: dict, q: float):
    """Upper-edge quantile estimate from a :meth:`Histogram.snapshot`
    dict (nearest-rank over the cumulative ``le`` counts). Returns
    the bucket's upper edge as float, ``float('inf')`` when the rank
    falls in the overflow bucket, None for an empty histogram —
    bounded buckets can't do better than an edge, which is exactly
    enough for a report."""
    total = snap.get("count", 0)
    if not total:
        return None
    rank = max(1, round(q * total))
    for edge, cum in snap["buckets"].items():
        if cum >= rank:
            return float("inf") if edge == "+Inf" else float(edge)
    return float("inf")


class Registry:
    """Get-or-create metric store; see module docstring."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}       # guarded-by: self._lock
        self._kinds: dict = {}         # guarded-by: self._lock
        self._families: dict = {}      # guarded-by: self._lock

    def _get(self, kind: str, name: str, labels: dict, make):
        key = _key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is not None:
                if self._kinds[key] != kind:
                    raise ValueError(
                        f"metric {key!r} already registered as "
                        f"{self._kinds[key]}, not {kind}")
                return m
        # miss: construct outside the lock (make is caller code), insert
        # with a re-check; a racing creator wins
        built = make()
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = built
                self._metrics[key] = m
                self._kinds[key] = kind
                self._families[key] = (name, dict(labels))
            elif self._kinds[key] != kind:
                raise ValueError(
                    f"metric {key!r} already registered as "
                    f"{self._kinds[key]}, not {kind}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, edges=None, **labels) -> Histogram:
        """Get-or-create; ``edges`` applies only on creation (an
        existing histogram keeps its buckets — callers agree on edges
        per name by convention)."""
        return self._get("histogram", name, labels,
                         lambda: Histogram(edges or DEFAULT_EDGES))

    def snapshot(self) -> dict:
        """Deterministic nested dict:
        ``{"counters": {key: int}, "gauges": {key: float|None},
        "histograms": {key: {count, sum, buckets}}}`` with every
        level sorted by key."""
        with self._lock:
            items = sorted(self._metrics.items())
            kinds = dict(self._kinds)
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for key, m in items:
            kind = kinds[key]
            if kind == "counter":
                out["counters"][key] = m.value
            elif kind == "gauge":
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = m.snapshot()
        return out

    def render_text(self) -> str:
        """Prometheus-style text exposition of the current state."""
        with self._lock:
            items = sorted(self._metrics.items())
            kinds = dict(self._kinds)
            families = dict(self._families)
        lines, typed = [], set()
        for key, m in items:
            kind = kinds[key]
            name, labels = families[key]
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {kind}")
            if kind == "counter":
                lines.append(f"{key} {m.value}")
            elif kind == "gauge":
                lines.append(f"{key} "
                             f"{'NaN' if m.value is None else m.value}")
            else:
                snap = m.snapshot()
                for edge, cum in snap["buckets"].items():
                    lab = dict(labels, le=edge)
                    lines.append(f"{_key(name + '_bucket', lab)} {cum}")
                lines.append(f"{_key(name + '_sum', labels)} "
                             f"{snap['sum']}")
                lines.append(f"{_key(name + '_count', labels)} "
                             f"{snap['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def log_to(self, metrics) -> None:
        """Write the snapshot as one ``registry`` event through a
        ``MetricsLogger``-shaped object (file-only ``write`` when it
        has one — a snapshot is machine food, not console output)."""
        if metrics is None:
            return
        fn = getattr(metrics, "write", None) or metrics.log
        fn("registry", snapshot=self.snapshot())

    def reset(self) -> None:
        """Drop every metric (tests only — production counters are
        process-lifetime by design)."""
        with self._lock:
            self._metrics.clear()
            self._kinds.clear()
            self._families.clear()


#: the process-wide default registry
REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
render_text = REGISTRY.render_text
log_to = REGISTRY.log_to
reset = REGISTRY.reset
