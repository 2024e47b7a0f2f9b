"""Streaming metrics: bounded estimators for open-loop million-request
traces.

Every container here has O(1) resident memory in the number of samples
observed — the invariant that lets the simulator run arbitrarily long
traces without the per-request lists ``GatewayReport`` used to accrete
(``mttr_samples``, latency lists, pacing logs). Three primitives:

  * ``P2Quantile``  — the Jain & Chlamtac P² estimator: one target
    quantile tracked with five markers, no stored samples. Used where a
    single quantile (a pacer's p99) is all that's needed.
  * ``StreamHist``  — a fixed-bin log-spaced histogram (the PR-5
    ``batch_hist`` pattern generalized to continuous values): relative
    quantile error is bounded by the bin growth factor, any quantile can
    be asked after the fact, and two histograms merge by bin addition.
  * ``BoundedSamples`` / ``BoundedLog`` — list-compatible shims for
    report fields that used to be raw lists: they keep exact streaming
    scalars (count/sum/min/max) plus a bounded prefix (samples) or
    suffix (log entries) of raw entries for inspection. ``len()``
    reports the TOTAL observed count; iteration yields only the
    retained subset.

``MetricsRegistry`` organizes labeled counters / gauges / histograms
under stable names (``registry.counter("requests", tenant="gold")``) and
snapshots to a plain dict; ``resident_samples()`` reports the total
retained entries across every instrument — the number the long-trace
benchmark gates on staying bounded.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field


class P2Quantile:
    """Jain & Chlamtac's P² streaming quantile estimator (CACM 1985).

    Tracks one quantile ``q`` with five markers and piecewise-parabolic
    interpolation — O(1) memory, no stored samples. Exact until five
    observations have arrived."""

    __slots__ = ("q", "_n", "_heights", "_pos", "_desired", "_inc")

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self._n = 0
        self._heights: list[float] = []
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._desired = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0]
        self._inc = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    @property
    def count(self) -> int:
        return self._n

    def observe(self, x: float) -> None:
        self._n += 1
        h = self._heights
        if len(h) < 5:
            h.append(float(x))
            h.sort()
            return
        # locate the cell and bump the extreme markers
        if x < h[0]:
            h[0] = float(x)
            k = 0
        elif x >= h[4]:
            h[4] = float(x)
            k = 3
        else:
            k = 0
            while k < 3 and x >= h[k + 1]:
                k += 1
        pos = self._pos
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._desired[i] += self._inc[i]
        # adjust interior markers toward their desired positions
        for i in (1, 2, 3):
            d = self._desired[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or (
                d <= -1.0 and pos[i - 1] - pos[i] < -1.0
            ):
                d = 1.0 if d >= 1.0 else -1.0
                cand = self._parabolic(i, d)
                if not h[i - 1] < cand < h[i + 1]:
                    cand = self._linear(i, d)
                h[i] = cand
                pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, pos = self._heights, self._pos
        return h[i] + d / (pos[i + 1] - pos[i - 1]) * (
            (pos[i] - pos[i - 1] + d) * (h[i + 1] - h[i]) / (pos[i + 1] - pos[i])
            + (pos[i + 1] - pos[i] - d) * (h[i] - h[i - 1]) / (pos[i] - pos[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        h, pos = self._heights, self._pos
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (pos[j] - pos[i])

    @property
    def value(self) -> float:
        h = self._heights
        if not h:
            return 0.0
        if self._n < 5:
            # exact small-sample quantile (numpy's 'linear' definition)
            idx = self.q * (len(h) - 1)
            lo = int(idx)
            hi = min(lo + 1, len(h) - 1)
            return h[lo] + (idx - lo) * (h[hi] - h[lo])
        return h[2]


class StreamHist:
    """Fixed-bin log-spaced histogram for positive-valued streams.

    Bin edges grow geometrically by ``growth`` from ``lo`` to ``hi``
    (values outside clamp into the end bins), so the RELATIVE error of
    any reported quantile is bounded by ``growth - 1`` as long as the
    mass stays inside [lo, hi]. Resident memory is the fixed bin array —
    independent of how many samples were observed. Exact count / sum /
    min / max ride alongside."""

    __slots__ = ("lo", "growth", "_log_g", "bins", "count", "sum", "min", "max")

    def __init__(self, lo: float = 1e-6, hi: float = 1e4, growth: float = 1.07):
        if not (lo > 0.0 and hi > lo and growth > 1.0):
            raise ValueError(f"bad StreamHist bounds: {lo}, {hi}, {growth}")
        self.lo = lo
        self.growth = growth
        self._log_g = math.log(growth)
        nbins = int(math.ceil(math.log(hi / lo) / self._log_g)) + 1
        self.bins = [0] * nbins
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, x: float) -> int:
        if x <= self.lo:
            return 0
        i = int(math.log(x / self.lo) / self._log_g)
        return min(i, len(self.bins) - 1)

    def observe(self, x: float) -> None:
        self.count += 1
        self.sum += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        self.bins[self._index(x)] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def _edge(self, i: int) -> float:
        return self.lo * self.growth**i

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]: geometric midpoint of the
        bin holding the target rank (clamped to the exact min/max, so a
        single-sample histogram answers exactly)."""
        if self.count == 0:
            return 0.0
        if q <= 0.0:
            return self.min
        if q >= 1.0:
            return self.max
        target = q * self.count
        acc = 0
        for i, n in enumerate(self.bins):
            acc += n
            if acc >= target:
                mid = self._edge(i) * math.sqrt(self.growth)
                return min(max(mid, self.min), self.max)
        return self.max

    def cdf(self, x: float) -> float:
        """Approximate fraction of samples <= x (bin-resolution, exact at
        the stream min/max)."""
        if self.count == 0:
            return 0.0
        if x >= self.max:
            return 1.0
        if x < self.min:
            return 0.0
        idx = self._index(x)
        return sum(self.bins[: idx + 1]) / self.count

    def merge(self, other: "StreamHist") -> None:
        assert len(self.bins) == len(other.bins) and self.lo == other.lo
        for i, n in enumerate(other.bins):
            self.bins[i] += n
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def resident(self) -> int:
        return len(self.bins)

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
        }


class BoundedSamples:
    """List-compatible bounded sample container.

    Streams exact count / sum / min / max (so means and maxima never
    degrade) while retaining only the first ``cap`` raw samples for
    inspection. ``len()`` is the TOTAL number of samples ever appended —
    the semantics every ``len(report.mttr_samples)`` caller already
    assumes — and iteration yields the retained prefix."""

    __slots__ = ("cap", "_kept", "count", "sum", "_min", "_max")

    def __init__(self, cap: int = 512):
        self.cap = cap
        self._kept: list[float] = []
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def append(self, x: float) -> None:
        self.count += 1
        self.sum += x
        self._min = min(self._min, x)
        self._max = max(self._max, x)
        if len(self._kept) < self.cap:
            self._kept.append(x)

    def __len__(self) -> int:
        return self.count

    def __bool__(self) -> bool:
        return self.count > 0

    def __iter__(self):
        return iter(self._kept)

    def __getitem__(self, i):
        return self._kept[i]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def max(self) -> float:
        return self._max if self.count else 0.0

    @property
    def min(self) -> float:
        return self._min if self.count else 0.0

    def resident(self) -> int:
        return len(self._kept)


class BoundedLog:
    """Bounded event log: retains the LAST ``cap`` entries (a deque),
    counts everything. Replaces unbounded append-only logs (pacing
    decisions) where recent history is what matters."""

    __slots__ = ("_kept", "count")

    def __init__(self, cap: int = 1024):
        self._kept: deque = deque(maxlen=cap)
        self.count = 0

    def append(self, item) -> None:
        self.count += 1
        self._kept.append(item)

    def __len__(self) -> int:
        return self.count

    def __bool__(self) -> bool:
        return self.count > 0

    def __iter__(self):
        return iter(self._kept)

    def __getitem__(self, i):
        return list(self._kept)[i]

    def resident(self) -> int:
        return len(self._kept)


@dataclass
class Counter:
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


@dataclass
class Gauge:
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = v


@dataclass
class MetricsRegistry:
    """Labeled counters / gauges / histograms under stable names.

    Instruments are created on first touch and keyed by
    (name, sorted label items) — the Prometheus shape, sized for a
    simulator: ``registry.counter("requests", tenant="gold").inc()``.
    ``snapshot()`` renders everything to one plain dict (the form
    ``GatewayReport`` exposes); ``resident_samples()`` totals the
    retained entries of every instrument, which is bounded by the number
    of DISTINCT (name, labels) series — never by the sample count."""

    _counters: dict = field(default_factory=dict)
    _gauges: dict = field(default_factory=dict)
    _hists: dict = field(default_factory=dict)

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted(labels.items())))

    def counter(self, name: str, **labels) -> Counter:
        key = self._key(name, labels)
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = self._key(name, labels)
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, **labels) -> StreamHist:
        key = self._key(name, labels)
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = StreamHist()
        return h

    def counter_total(self, name: str, **match) -> float:
        """Sum of every counter series named ``name`` whose labels
        include ``match`` (empty match sums all series)."""
        total = 0.0
        for (n, items), c in self._counters.items():
            if n == name and all((k, v) in items for k, v in match.items()):
                total += c.value
        return total

    def merged_histogram(self, name: str, **match) -> StreamHist | None:
        """Bin-wise merge of every histogram series named ``name`` whose
        labels include ``match`` — how a whole-trace quantile is read
        back out of per-tenant/per-kind series."""
        out = None
        for (n, items), h in self._hists.items():
            if n == name and all((k, v) in items for k, v in match.items()):
                if out is None:
                    # hi chosen so the reconstructed bin count matches
                    # exactly (ceil(log(g^(n-1))/log g) + 1 == n)
                    out = StreamHist(
                        lo=h.lo, hi=h._edge(len(h.bins) - 1), growth=h.growth
                    )
                out.merge(h)
        return out

    @staticmethod
    def _label_str(items: tuple) -> str:
        return ",".join(f"{k}={v}" for k, v in items)

    def snapshot(self) -> dict:
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, items), c in sorted(self._counters.items()):
            out["counters"][f"{name}{{{self._label_str(items)}}}"] = c.value
        for (name, items), g in sorted(self._gauges.items()):
            out["gauges"][f"{name}{{{self._label_str(items)}}}"] = g.value
        for (name, items), h in sorted(self._hists.items()):
            out["histograms"][f"{name}{{{self._label_str(items)}}}"] = h.summary()
        return out

    def resident_samples(self) -> int:
        return (
            len(self._counters)
            + len(self._gauges)
            + sum(h.resident() for h in self._hists.values())
        )
