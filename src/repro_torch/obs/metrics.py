"""Typed metrics registry: Counter / Gauge / Histogram, zero dependencies
(the port's own copy of ``repro/obs/metrics.py``).

The serving and calibration subsystems register their observables here
instead of growing hand-rolled counter attributes: ``ContinuousEngine``,
``Scheduler`` and ``BlockPool`` all write into one shared ``Registry`` per
engine (``engine.registry``), and ``engine.metrics()`` is a compatibility
view over it. Two export formats:

  * ``Registry.prometheus()`` — Prometheus text exposition (validated by
    ``tools/check_prom.py``; written by ``launch/serve.py --metrics-out``);
  * ``Registry.snapshot()`` — flat ``{name: float}`` JSON-ready dict
    (histograms expand to ``_count/_sum/_mean/_p50/_p99/_max``).

Histograms use **fixed log-spaced buckets** (``log_buckets``): serving
latencies (TTFT, inter-token/decode-step time, queue wait) span four-plus
decades, where linear buckets either saturate or lose the tail. Bucket
bounds are part of the metric's identity — fixed at registration so rows
stay comparable across runs and PRs.

Metric names follow Prometheus conventions (``snake_case``, counters end
in ``_total``, seconds-valued series end in ``_seconds``). The full name
table lives in docs/observability.md and is frozen by the golden-key
schema tests (tests/test_obs.py, and tests/test_torch_obs.py for the port);
optional subsystems extend it only on engines that enable them
(``serve_spec_*`` with a draft model,
``serve_recalib_*`` after ``attach_recalibrator``), so the base schema
never drifts.

Writers are the single-threaded serving loop; reads (exposition/snapshot)
may come from elsewhere and take no locks — a torn read costs one sample
of staleness, never corruption (floats and list slots update atomically
under the GIL).
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> Tuple[float, ...]:
    """Log-spaced histogram bounds covering [lo, hi], ``per_decade`` each."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    n = int(math.ceil(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


# TTFT / inter-token latency / queue wait all live in [0.1 ms, ~1 min] on
# every backend this repo targets; one shared bucket ladder keeps the
# latency histograms comparable to each other
LATENCY_BUCKETS = log_buckets(1e-4, 60.0, per_decade=3)


class Counter:
    """Monotonic accumulator (float-valued: also used for summed seconds)."""

    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self._value += n

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0


class Gauge:
    """Point-in-time value: ``set()`` explicitly, or a callback (``fn``)
    evaluated at read time — pool/queue depths stay correct with no update
    plumbing through the hot path."""

    __slots__ = ("name", "help", "_value", "_fn")

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        if self._fn is not None:
            raise ValueError(f"gauge {self.name} is callback-backed")
        self._value = float(v)

    @property
    def value(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value

    def reset(self) -> None:
        if self._fn is None:
            self._value = 0.0


class Histogram:
    """Fixed-bucket histogram (cumulative counts on exposition, like
    Prometheus ``le`` buckets; quantiles estimated from bucket edges)."""

    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_count",
                 "_max")

    def __init__(self, name: str, buckets: Sequence[float] = LATENCY_BUCKETS,
                 help: str = ""):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b <= a for a, b in zip(bounds, bounds[1:])):
            raise ValueError(f"histogram {name}: buckets must be "
                             f"non-empty and increasing, got {bounds}")
        self.name = name
        self.help = help
        self.buckets = bounds
        self._counts = [0] * (len(bounds) + 1)   # last = overflow (+Inf)
        self._sum = 0.0
        self._count = 0
        self._max = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        self._counts[i] += 1
        self._sum += v
        self._count += 1
        if v > self._max:
            self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max

    def quantile(self, q: float) -> float:
        """Upper bucket edge holding the q-quantile (0 with no samples;
        capped at the observed max for the overflow bucket)."""
        if not self._count:
            return 0.0
        target = q * self._count
        cum = 0
        for i, c in enumerate(self._counts):
            cum += c
            if cum >= target and c:
                edge = (self.buckets[i] if i < len(self.buckets)
                        else self._max)
                return min(edge, self._max)
        return self._max

    def reset(self) -> None:
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._max = 0.0


class Registry:
    """Ordered collection of typed metrics with exposition/snapshot/reset.

    Registration is strict: a duplicate name raises (metric identity drift
    is a bug, not a merge), and names must be Prometheus-legal.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _register(self, m):
        if not _NAME_RE.match(m.name):
            raise ValueError(f"bad metric name {m.name!r}")
        if m.name in self._metrics:
            raise ValueError(f"metric {m.name!r} already registered")
        self._metrics[m.name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter(name, help))

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        return self._register(Gauge(name, help, fn))

    def histogram(self, name: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS,
                  help: str = "") -> Histogram:
        return self._register(Histogram(name, buckets, help))

    def get(self, name: str):
        return self._metrics[name]

    def names(self) -> List[str]:
        return list(self._metrics)

    def reset(self) -> None:
        """Zero counters/histograms/set-gauges (callback gauges read live
        state and are untouched) — the steady-state benchmarking hook
        behind ``ContinuousEngine.reset_metrics()``."""
        for m in self._metrics.values():
            m.reset()

    # ---------------------------------------------------------------- export
    def snapshot(self) -> Dict[str, float]:
        """Flat JSON-ready view; histogram ``h`` expands to ``h_count``,
        ``h_sum``, ``h_mean``, ``h_p50``, ``h_p99``, ``h_max``."""
        out: Dict[str, float] = {}
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                out[f"{name}_count"] = float(m.count)
                out[f"{name}_sum"] = m.sum
                out[f"{name}_mean"] = m.mean
                out[f"{name}_p50"] = m.quantile(0.50)
                out[f"{name}_p99"] = m.quantile(0.99)
                out[f"{name}_max"] = m.max
            else:
                out[name] = m.value
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for name, m in self._metrics.items():
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt(m.value)}")
            else:
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for bound, c in zip(m.buckets, m._counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{_fmt(bound)}"}} {cum}')
                cum += m._counts[-1]
                lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{name}_sum {_fmt(m.sum)}")
                lines.append(f"{name}_count {m.count}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Exposition-friendly number: integral floats print as ints."""
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)
