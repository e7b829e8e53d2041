"""Labeled metrics registry unifying the scattered stats surfaces.

Port of ``repro/obs/metrics.py`` (plain Python); the ``absorb_*``
helpers take the port's ``Stats`` and ``OnlineStats``.

``engine.Stats``, ``OnlineStats``, the broker's ``span_stats``, the
``GossipBus`` counters, and the solve/overhead/conflict timing split
all become *views over one registry*: each plane exposes
``metrics_registry()`` which absorbs its own surfaces into counters /
gauges / histograms keyed by ``(name, labels)``, and parent planes
**merge** their children's registries under a composed ``plane`` label
(``"g0/r1"``) — mirroring the gossip aggregation structure, so a
snapshot only ever contains what that plane can legitimately see.

The registry is pull-based: it is built fresh on each
``metrics_registry()`` call from the live stats surfaces, so it adds
zero cost to the admission path (nothing is recorded per-request).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

__all__ = [
    "Histogram",
    "MetricsRegistry",
    "absorb_engine_stats",
    "absorb_online_stats",
    "absorb_gossip_stats",
    "absorb_span_stats",
    "absorb_timing",
]


def _key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class Histogram:
    """Count/sum/min/max plus power-of-two bucket counts — mergeable
    without holding raw samples."""

    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.buckets: dict[int, int] = {}  # bucket i covers [2^(i-1), 2^i)

    def observe(self, v: float, n: int = 1) -> None:
        """Record value ``v``; ``n`` > 1 records it with weight ``n`` (the
        pull-based adapters fold pre-aggregated ``{value: count}`` surfaces
        like the placer's superstep buckets without replaying samples)."""
        self.count += n
        self.sum += v * n
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        b = int(v).bit_length() if v >= 1 else (-1 if v > 0 else 0)
        self.buckets[b] = self.buckets.get(b, 0) + n

    def merge(self, other: "Histogram") -> None:
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        for b, c in other.buckets.items():
            self.buckets[b] = self.buckets.get(b, 0) + c

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
        }


class MetricsRegistry:
    """Counters / gauges / histograms with labels.

    ``merge(other, plane="r0")`` folds another registry in, composing
    any label key both sides define with ``/`` (``plane="g0"`` merged
    over a child metric already labeled ``plane="r1"`` yields
    ``plane="g0/r1"``) — the label path mirrors the plane nesting.
    """

    def __init__(self):
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, Histogram] = {}

    # -- record ---------------------------------------------------------------

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        k = _key(name, labels)
        self._counters[k] = self._counters.get(k, 0.0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        self._gauges[_key(name, labels)] = value

    def observe(self, name: str, value: float, n: int = 1, **labels) -> None:
        k = _key(name, labels)
        h = self._hists.get(k)
        if h is None:
            h = self._hists[k] = Histogram()
        h.observe(value, n)

    # -- read -----------------------------------------------------------------

    def get(self, name: str, **labels) -> float | None:
        k = _key(name, labels)
        if k in self._counters:
            return self._counters[k]
        if k in self._gauges:
            return self._gauges[k]
        h = self._hists.get(k)
        return h.mean if h is not None else None

    def counters(self) -> dict:
        return dict(self._counters)

    def total(self, name: str) -> float:
        """Sum of a counter over all label sets — the honest global view."""
        return sum(v for (n, _), v in self._counters.items() if n == name)

    def labeled(self, name: str) -> dict:
        """All label-set -> value pairs for one metric name."""
        out = {}
        for store in (self._counters, self._gauges):
            for (n, labels), v in store.items():
                if n == name:
                    out[labels] = v
        for (n, labels), h in self._hists.items():
            if n == name:
                out[labels] = h.to_dict()
        return out

    # -- merge ----------------------------------------------------------------

    @staticmethod
    def _compose(labels: tuple, extra: dict) -> tuple:
        if not extra:
            return labels
        d = dict(labels)
        for k, v in extra.items():
            d[k] = f"{v}/{d[k]}" if k in d else v
        return tuple(sorted(d.items()))

    def merge(self, other: "MetricsRegistry", **extra_labels) -> "MetricsRegistry":
        for (n, labels), v in other._counters.items():
            k = (n, self._compose(labels, extra_labels))
            self._counters[k] = self._counters.get(k, 0.0) + v
        for (n, labels), v in other._gauges.items():
            self._gauges[(n, self._compose(labels, extra_labels))] = v
        for (n, labels), h in other._hists.items():
            k = (n, self._compose(labels, extra_labels))
            mine = self._hists.get(k)
            if mine is None:
                mine = self._hists[k] = Histogram()
            mine.merge(h)
        return self

    @classmethod
    def merged(cls, regs: Iterable[tuple["MetricsRegistry", dict]]
               ) -> "MetricsRegistry":
        out = cls()
        for reg, extra in regs:
            out.merge(reg, **extra)
        return out

    # -- snapshot -------------------------------------------------------------

    def snapshot(self, *, reset: bool = False) -> dict:
        """Flat ``name{label=value,...} -> value`` dict (JSON-friendly)."""
        out: dict[str, object] = {}
        for (n, labels), v in sorted(self._counters.items()):
            out[n + _label_str(labels)] = v
        for (n, labels), v in sorted(self._gauges.items()):
            out[n + _label_str(labels)] = v
        for (n, labels), h in sorted(self._hists.items()):
            out[n + _label_str(labels)] = h.to_dict()
        if reset:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
        return out


# ---------------------------------------------------------------------------
# adapters: the legacy stats surfaces as registry views
# ---------------------------------------------------------------------------

# engine.Stats fields that sum across solves/regions
_ENGINE_ADDITIVE = (
    "rounds", "messages_sent", "messages_dropped", "maps_generated",
    "fallback_used", "stale_batches", "preemptions", "defrag_rounds",
    "gossip_messages", "twopc_messages",
)


def absorb_engine_stats(reg: MetricsRegistry, s, **labels) -> MetricsRegistry:
    """``engine.Stats`` -> registry.  Additive fields become counters;
    non-additive fields (``kernel_impl``, ``solve_n``, ``method``,
    ``batch_size``) become *labeled* values instead of last-writer-wins
    scalars (the historical merge bug)."""
    for f in _ENGINE_ADDITIVE:
        v = getattr(s, f, 0)
        if v:
            reg.inc(f"engine.{f}", float(v), **labels)
    reg.gauge("engine.max_set_size", float(s.max_set_size), **labels)
    if s.solve_n:
        reg.observe("engine.solve_n", float(s.solve_n), **labels)
    if s.kernel_impl:
        reg.inc("engine.solves", 1.0, kernel_impl=s.kernel_impl, **labels)
    if getattr(s, "method", ""):
        reg.inc("engine.method", 1.0, method=s.method, **labels)
    for f in ("solve_ms", "overhead_ms", "conflict_resolve_ms"):
        v = getattr(s, f, 0.0)
        if v:
            reg.inc(f"timing.{f}", float(v), **labels)
    return reg


def absorb_online_stats(reg: MetricsRegistry, st, **labels) -> MetricsRegistry:
    """``OnlineStats`` (the placer's lifetime counters + timing split +
    per-impl solve counts) -> registry."""
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if f.name in ("solve_ms", "overhead_ms", "conflict_resolve_ms"):
            reg.inc(f"timing.{f.name}", float(v), **labels)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            if v:
                reg.inc(f"placer.{f.name}", float(v), **labels)
    for impl, cnt in getattr(st, "kernel_impls", {}).items():
        reg.inc("placer.solves_by_impl", float(cnt), kernel_impl=impl,
                **labels)
    # superstep histograms per solve mode ("cold" vs the warm-started
    # bounded correction pass) — the stat the incremental fast path is
    # graded on: warm solves must report strictly fewer supersteps
    for mode, buckets in getattr(st, "supersteps", {}).items():
        for rounds, cnt in buckets.items():
            reg.observe("engine.supersteps", float(rounds), n=int(cnt),
                        mode=mode, **labels)
    if st.solves:
        reg.gauge("placer.mean_solve_n", float(st.mean_solve_n), **labels)
    return reg


def absorb_gossip_stats(reg: MetricsRegistry, gs: dict, **labels
                        ) -> MetricsRegistry:
    """``GossipBus.gossip_stats()`` / ``snapshot()`` dict -> registry."""
    for f in ("rounds", "messages_sent", "records_sent", "payload_sent"):
        if f in gs:
            reg.inc(f"gossip.{f}", float(gs[f]), **labels)
    for f in ("messages_per_round", "records_per_message"):
        if f in gs:
            reg.gauge(f"gossip.{f}", float(gs[f]), **labels)
    return reg


def absorb_span_stats(reg: MetricsRegistry, ss: dict, **labels
                      ) -> MetricsRegistry:
    """Broker ``span_stats`` dict -> registry (``max_*`` keys — running
    maxima like max_chain / max_req_attempts — are gauges, the rest are
    counters)."""
    for k, v in ss.items():
        if k.startswith("max_"):
            reg.gauge(f"twopc.{k}", float(v), **labels)
        else:
            reg.inc(f"twopc.{k}", float(v), **labels)
    return reg


def absorb_timing(reg: MetricsRegistry, timing: dict, **labels
                  ) -> MetricsRegistry:
    """``fairness_report()['timing']`` dict -> registry counters."""
    for k, v in timing.items():
        reg.inc(f"timing.{k}", float(v), **labels)
    return reg
