"""In-tree metrics: counters, gauges, and latency histograms.

The reference has no observability beyond stdout logs (SURVEY.md §5); the
serving benchmarks (tokens/sec/chip, p50 TTFT — BASELINE.md) *are* metrics,
so they are first-class here. Prometheus-style text rendering on /metrics;
percentiles computed from a bounded reservoir.
"""

from __future__ import annotations

import threading
from typing import Optional


class Counter:
    def __init__(self, name: str, help_: str = "") -> None:
        self.name = name
        self.help = help_
        self._v = 0.0
        self._mu = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._mu:
            self._v += amount

    @property
    def value(self) -> float:
        with self._mu:
            return self._v

    def render(self) -> str:
        return f"# TYPE {self.name} counter\n{self.name} {self.value}\n"


class Gauge:
    def __init__(self, name: str, help_: str = "") -> None:
        self.name = name
        self.help = help_
        self._v = 0.0
        self._mu = threading.Lock()

    def set(self, v: float) -> None:
        with self._mu:
            self._v = v

    def add(self, d: float) -> None:
        with self._mu:
            self._v += d

    @property
    def value(self) -> float:
        with self._mu:
            return self._v

    def render(self) -> str:
        return f"# TYPE {self.name} gauge\n{self.name} {self.value}\n"


class Histogram:
    """Bounded-reservoir histogram; keeps the most recent ``cap`` samples for
    percentile queries (enough for p50/p95/p99 dashboards and the bench)."""

    def __init__(self, name: str, help_: str = "", cap: int = 4096) -> None:
        self.name = name
        self.help = help_
        self._cap = cap
        self._samples: list[float] = []
        self._idx = 0
        self._count = 0
        self._sum = 0.0
        self._mu = threading.Lock()

    def observe(self, v: float) -> None:
        with self._mu:
            self._count += 1
            self._sum += v
            if len(self._samples) < self._cap:
                self._samples.append(v)
            else:
                self._samples[self._idx] = v
                self._idx = (self._idx + 1) % self._cap

    def percentile(self, p: float) -> Optional[float]:
        with self._mu:
            if not self._samples:
                return None
            xs = sorted(self._samples)
        k = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
        return xs[k]

    @property
    def count(self) -> int:
        with self._mu:
            return self._count

    @property
    def sum(self) -> float:
        with self._mu:
            return self._sum

    def render(self) -> str:
        lines = [f"# TYPE {self.name} summary"]
        for q, label in ((50, "0.5"), (95, "0.95"), (99, "0.99")):
            v = self.percentile(q)
            if v is not None:
                lines.append(f'{self.name}{{quantile="{label}"}} {v}')
        lines.append(f"{self.name}_sum {self.sum}")
        lines.append(f"{self.name}_count {self.count}")
        return "\n".join(lines) + "\n"


class Registry:
    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._metrics: dict[str, object] = {}

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help_), Gauge)

    def histogram(self, name: str, help_: str = "") -> Histogram:
        return self._get(name, lambda: Histogram(name, help_), Histogram)

    def _get(self, name, factory, cls):
        with self._mu:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            if not isinstance(m, cls):
                raise TypeError(f"metric {name} already registered as {type(m).__name__}")
            return m

    def render(self) -> str:
        with self._mu:
            metrics = list(self._metrics.values())
        return "".join(m.render() for m in metrics)  # type: ignore[attr-defined]
