"""Request-lifecycle tracer for the control planes.

Port of ``repro/obs/trace.py``: ``annotate`` labels device dispatch with
``torch.profiler.record_function`` instead of a JAX trace annotation.

One :class:`Tracer` collects Chrome-trace events (in-memory dicts) from
every layer it is threaded through — control planes, placers, the 2PC
broker, gossip rounds, kernel dispatch — against a single monotonic
clock, so a request's lifecycle can be reconstructed across planes.

Two event families:

- **spans** (``span(...)`` context manager): Chrome "complete" events
  (``ph="X"``) with a duration — pump rounds, batched solves,
  validate/commit loops, 2PC reserve phases, gossip ticks, defrag.
- **flow events** (``flow_begin/flow_point/flow_end``): Chrome async
  events (``ph="b"/"n"/"e"``) keyed by a string id derived from the
  request id — submit, dispatch, admit, reject, preempt, per-region 2PC
  reserves, commit, release.  The string id is prefixed by the plane
  scope (see :meth:`Tracer.scoped`) so region-local rids never collide
  with broker-level rids.

Nested planes share one event buffer through :meth:`Tracer.scoped`,
which returns a view whose track names and flow ids carry a
``"r0/"``-style prefix — mirroring how regional registries merge into a
global snapshot.

Disabled mode is the :data:`NULL` singleton: every method is a constant
no-op (``span``/``annotate`` return one cached reusable null context),
so instrumented hot paths pay one attribute lookup + call per hook.
Tracing reads ``time.perf_counter`` only — no RNG, no solver state —
so enabling it cannot perturb placement decisions (bit-identity suites
run with tracing on).
"""
from __future__ import annotations

import time
from contextlib import nullcontext

__all__ = ["Tracer", "NullTracer", "NULL"]

_NULL_CTX = nullcontext()


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tr", "name", "track", "cat", "args", "_t0")

    def __init__(self, tr, name, track, cat, args):
        self._tr = tr
        self.name = name
        self.track = track
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = self._tr._now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = self._tr._now_us()
        ev = {
            "ph": "X",
            "name": self.name,
            "cat": self.cat or "span",
            "ts": self._t0,
            "dur": t1 - self._t0,
            "track": self.track,
        }
        if self.args:
            ev["args"] = self.args
        self._tr._events.append(ev)
        return False


class Tracer:
    """Collects Chrome-trace events against one monotonic clock."""

    enabled = True

    def __init__(self, *, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._events: list[dict] = []
        self._prefix = ""

    # -- internals ----------------------------------------------------------

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    # -- scoping ------------------------------------------------------------

    def scoped(self, prefix: str) -> "Tracer":
        """A view over the same event buffer whose tracks and flow ids
        carry ``prefix + "/"`` — one per nested plane (region / group)."""
        t = object.__new__(Tracer)
        t._clock = self._clock
        t._t0 = self._t0
        t._events = self._events
        t._prefix = self._prefix + prefix + "/"
        return t

    # -- spans ----------------------------------------------------------------

    def span(self, name: str, *, track: str = "main", cat: str = "",
             **args) -> _Span:
        return _Span(self, name, self._prefix + track, cat, args)

    def instant(self, name: str, *, track: str = "main", cat: str = "",
                **args) -> None:
        ev = {
            "ph": "i",
            "name": name,
            "cat": cat or "instant",
            "ts": self._now_us(),
            "s": "t",
            "track": self._prefix + track,
        }
        if args:
            ev["args"] = args
        self._events.append(ev)

    # -- request-lifecycle flow events ---------------------------------------

    def _flow(self, ph: str, fid, name: str, track: str, args) -> None:
        ev = {
            "ph": ph,
            "name": name,
            "cat": "request",
            "id": f"{self._prefix}req:{fid}",
            "ts": self._now_us(),
            "track": self._prefix + track,
        }
        if args:
            ev["args"] = args
        self._events.append(ev)

    def flow_begin(self, fid, name: str = "request", *,
                   track: str = "lifecycle", **args) -> None:
        self._flow("b", fid, name, track, args)

    def flow_point(self, fid, name: str, *, track: str = "lifecycle",
                   **args) -> None:
        self._flow("n", fid, name, track, args)

    def flow_end(self, fid, name: str = "request", *,
                 track: str = "lifecycle", **args) -> None:
        self._flow("e", fid, name, track, args)

    # -- accelerator hook -----------------------------------------------------

    def annotate(self, name: str):
        """``torch.profiler.record_function`` around device dispatch so the
        span shows up in ``torch.profiler`` traces too."""
        import torch

        return torch.profiler.record_function(self._prefix + name)

    # -- access ---------------------------------------------------------------

    @property
    def events(self) -> list[dict]:
        return self._events

    def clear(self) -> None:
        del self._events[:]


class NullTracer(Tracer):
    """Disabled tracer: every method is a constant no-op.

    ``scoped`` returns itself so plane constructors can scope
    unconditionally; ``span``/``annotate`` return one cached reusable
    null context manager (no allocation per hook)."""

    enabled = False

    def __init__(self):
        self._events = ()
        self._prefix = ""

    def scoped(self, prefix: str) -> "NullTracer":
        return self

    def span(self, name, *, track="main", cat="", **args):
        return _NULL_CTX

    def instant(self, name, *, track="main", cat="", **args):
        return None

    def flow_begin(self, fid, name="request", *, track="lifecycle", **args):
        return None

    def flow_point(self, fid, name, *, track="lifecycle", **args):
        return None

    def flow_end(self, fid, name="request", *, track="lifecycle", **args):
        return None

    def annotate(self, name):
        return _NULL_CTX

    @property
    def events(self):
        return []

    def clear(self):
        return None


#: Module-level disabled tracer; planes default to this when no tracer
#: is passed, so the instrumented paths cost one no-op call per hook.
NULL = NullTracer()
