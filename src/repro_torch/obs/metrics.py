"""Process-local metrics: counters, gauges, streaming histograms (port of
``repro.obs.metrics``; host-side Python, no torch).

The serving stack records what it knows about itself here: request
latency families (TTFT / TPOT / end-to-end), per-step phase timings,
admission / shed / deadline tallies, degradation-mode residency,
speculative acceptance and device-read counts, through one
:class:`Registry` per engine (replicas each get their own, so per-engine
counts stay attributable; see :class:`repro_torch.obs.Obs`).

* **No unbounded sample lists.** :class:`Histogram` is a fixed array of
  geometrically spaced buckets; an observation is a few host writes.
  Quantiles come from bucket midpoints with a relative error bounded by
  ``growth - 1`` (25% at the default ``growth=1.25``); exact ``count``,
  ``total``, ``min`` and ``max`` ride along.
* **Hot-path safe.** Recording is plain host arithmetic: no device
  values, no synchronisation. The registry is always live (engine
  counters double as state that tests read); only *timing* is switched
  off when obs is disabled.
* **Snapshot round-trip.** :meth:`Registry.snapshot` emits a JSON-able
  dict; :meth:`Registry.from_snapshot` rebuilds an equal registry
  (bucket-exact). :meth:`Registry.prometheus` renders the text
  exposition format.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional


def safe_ratio(num: float, den: float, default: float = 0.0) -> float:
    """``num / den`` with a well-defined answer on an empty denominator.

    Every rate in the stack (prefix hit rate before any admission,
    acceptance rate before any verify round) funnels through this so
    "no data yet" is ``default``, never ``ZeroDivisionError``.
    """
    return num / den if den else default


class Counter:
    """Monotonic counter. ``inc`` is as cheap as the ``+=`` it replaced."""

    __slots__ = ("name", "unit", "desc", "value")

    def __init__(self, name: str, unit: str = "", desc: str = ""):
        self.name, self.unit, self.desc = name, unit, desc
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value (pool bytes, pressure, mode)."""

    __slots__ = ("name", "unit", "desc", "value")

    def __init__(self, name: str, unit: str = "", desc: str = ""):
        self.name, self.unit, self.desc = name, unit, desc
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Streaming histogram over fixed geometric buckets.

    Buckets cover ``[lo, hi)`` with ratio ``growth`` between edges;
    observations below ``lo`` (incl. zero/negative) land in a dedicated
    underflow bucket, above ``hi`` in an overflow bucket. Quantiles
    interpolate to the geometric midpoint of the hit bucket, so the
    relative estimation error is at most ``sqrt(growth) - 1`` for any
    in-range value (``tests/test_obs.py`` asserts the looser
    ``growth - 1`` bound end to end).
    """

    __slots__ = ("name", "unit", "desc", "lo", "growth", "_log_g",
                 "buckets", "count", "total", "min", "max")

    def __init__(self, name: str, unit: str = "s", desc: str = "",
                 lo: float = 1e-7, hi: float = 1e4, growth: float = 1.25):
        if not (lo > 0.0 and hi > lo and growth > 1.0):
            raise ValueError("need 0 < lo < hi and growth > 1")
        self.name, self.unit, self.desc = name, unit, desc
        self.lo, self.growth = lo, growth
        self._log_g = math.log(growth)
        n = int(math.ceil(math.log(hi / lo) / self._log_g))
        # [0] underflow, [1..n] geometric, [n+1] overflow — fixed forever
        self.buckets: List[int] = [0] * (n + 2)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def observe(self, v: float) -> None:
        if v < self.lo:
            idx = 0
        else:
            idx = 1 + int(math.log(v / self.lo) / self._log_g)
            if idx > len(self.buckets) - 2:
                idx = len(self.buckets) - 1
        self.buckets[idx] += 1
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return safe_ratio(self.total, self.count)

    def _edge(self, i: int) -> float:
        """Lower edge of geometric bucket ``i`` (1-based)."""
        return self.lo * self.growth ** (i - 1)

    def percentile(self, q: float) -> float:
        """Estimate the ``q``-quantile (``q`` in [0, 1])."""
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        seen = 0
        for i, n in enumerate(self.buckets):
            if n == 0:
                continue
            seen += n
            if seen > rank:
                if i == 0:                       # underflow: exact floor
                    return self.min
                if i == len(self.buckets) - 1:   # overflow: exact ceiling
                    return self.max
                mid = self._edge(i) * math.sqrt(self.growth)
                # clamp to the observed extremes so single-bucket
                # histograms report sane values
                return min(max(mid, self.min), self.max)
        return self.max


class Registry:
    """Get-or-create home for every metric family, keyed by dotted name."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- get-or-create ------------------------------------------------------
    def counter(self, name: str, unit: str = "", desc: str = "") -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, unit, desc)
        return c

    def gauge(self, name: str, unit: str = "", desc: str = "") -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, unit, desc)
        return g

    def histogram(self, name: str, unit: str = "s", desc: str = "",
                  lo: float = 1e-7, hi: float = 1e4,
                  growth: float = 1.25) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(name, unit, desc, lo, hi,
                                              growth)
        return h

    def ratio(self, num_name: str, den_name: str,
              default: float = 0.0) -> float:
        """Guarded ratio of two counters by name (0 if either absent)."""
        num = self._counters.get(num_name)
        den = self._counters.get(den_name)
        return safe_ratio(num.value if num else 0,
                          den.value if den else 0, default)

    # -- snapshot round-trip ------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able dump of every metric, bucket-exact for histograms."""
        return {
            "counters": {n: {"value": c.value, "unit": c.unit}
                         for n, c in sorted(self._counters.items())},
            "gauges": {n: {"value": g.value, "unit": g.unit}
                       for n, g in sorted(self._gauges.items())},
            "histograms": {
                n: {"unit": h.unit, "lo": h.lo, "growth": h.growth,
                    "count": h.count, "total": h.total,
                    "min": None if h.count == 0 else h.min,
                    "max": None if h.count == 0 else h.max,
                    "buckets": list(h.buckets)}
                for n, h in sorted(self._hists.items())},
        }

    @classmethod
    def from_snapshot(cls, doc: dict) -> "Registry":
        r = cls()
        for n, c in doc.get("counters", {}).items():
            r.counter(n, unit=c.get("unit", "")).value = c["value"]
        for n, g in doc.get("gauges", {}).items():
            r.gauge(n, unit=g.get("unit", "")).set(g["value"])
        for n, hd in doc.get("histograms", {}).items():
            nb = len(hd["buckets"])
            # reconstruct hi from (lo, growth, bucket count)
            hi = hd["lo"] * hd["growth"] ** (nb - 2)
            h = r.histogram(n, unit=hd.get("unit", "s"), lo=hd["lo"],
                            hi=hi * 0.999999, growth=hd["growth"])
            if len(h.buckets) != nb:          # defensive: force exact shape
                h.buckets = [0] * nb
            h.buckets[:] = hd["buckets"]
            h.count = hd["count"]
            h.total = hd["total"]
            h.min = math.inf if hd["min"] is None else hd["min"]
            h.max = -math.inf if hd["max"] is None else hd["max"]
        return r

    # -- prometheus text exposition -----------------------------------------
    @staticmethod
    def _prom_name(name: str) -> str:
        return "".join(ch if (ch.isalnum() or ch == "_") else "_"
                       for ch in name)

    def prometheus(self) -> str:
        """Conventional ``# TYPE``-annotated text dump (counters, gauges,
        and summary-style quantile lines for histograms)."""
        out: List[str] = []
        for n, c in sorted(self._counters.items()):
            pn = self._prom_name(n)
            if c.desc:
                out.append(f"# HELP {pn} {c.desc}")
            out.append(f"# TYPE {pn} counter")
            out.append(f"{pn} {c.value}")
        for n, g in sorted(self._gauges.items()):
            pn = self._prom_name(n)
            if g.desc:
                out.append(f"# HELP {pn} {g.desc}")
            out.append(f"# TYPE {pn} gauge")
            out.append(f"{pn} {g.value}")
        for n, h in sorted(self._hists.items()):
            pn = self._prom_name(n)
            if h.desc:
                out.append(f"# HELP {pn} {h.desc}")
            out.append(f"# TYPE {pn} summary")
            for q in (0.5, 0.9, 0.99):
                out.append(f'{pn}{{quantile="{q}"}} {h.percentile(q)}')
            out.append(f"{pn}_sum {h.total}")
            out.append(f"{pn}_count {h.count}")
        return "\n".join(out) + "\n"

    # -- convenience views --------------------------------------------------
    def counters(self) -> Dict[str, int]:
        return {n: c.value for n, c in self._counters.items()}

    def get_histogram(self, name: str) -> Optional[Histogram]:
        return self._hists.get(name)
