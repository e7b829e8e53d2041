"""Chrome-trace / Perfetto JSON export, text timeline, schema validation.

Port of ``repro/obs/export.py`` (plain Python).

``to_chrome_trace`` converts a :class:`~repro_torch.obs.trace.Tracer`'s event
buffer into the Chrome trace event format (the JSON flavor Perfetto's
legacy importer and ``chrome://tracing`` both load): span events become
complete events (``ph="X"``), flow events stay async begin/instant/end
(``ph="b"/"n"/"e"``, matched on ``(cat, id)``), and each distinct track
name becomes a named thread via ``thread_name`` metadata events.

``reconstruct_request`` inverts the export for one request id — the
acceptance check that a spanning request's lifecycle (submit → chained
2PC reserves → commit → release) survives the round-trip.
"""
from __future__ import annotations

import json

__all__ = [
    "to_chrome_trace",
    "write_chrome_trace",
    "text_timeline",
    "validate_chrome_trace",
    "reconstruct_request",
]

_PID = 1
_VALID_PH = {"X", "B", "E", "b", "n", "e", "i", "I", "M", "C", "s", "t", "f"}


def _track_ids(events) -> dict[str, int]:
    tracks = sorted({ev.get("track", "main") for ev in events})
    return {t: i + 1 for i, t in enumerate(tracks)}


def to_chrome_trace(tracer_or_events, *, process_name: str = "repro"
                    ) -> dict:
    """Tracer (or raw event list) -> Chrome trace JSON object."""
    events = getattr(tracer_or_events, "events", tracer_or_events)
    tids = _track_ids(events)
    out = [{
        "ph": "M", "name": "process_name", "pid": _PID, "tid": 0,
        "args": {"name": process_name},
    }]
    for track, tid in tids.items():
        out.append({
            "ph": "M", "name": "thread_name", "pid": _PID, "tid": tid,
            "args": {"name": track},
        })
    for ev in events:
        ce = {
            "ph": ev["ph"],
            "name": ev["name"],
            "cat": ev.get("cat", "span"),
            "ts": ev["ts"],
            "pid": _PID,
            "tid": tids[ev.get("track", "main")],
        }
        if ev["ph"] == "X":
            ce["dur"] = ev.get("dur", 0.0)
        if ev["ph"] in ("b", "n", "e"):
            ce["id"] = str(ev["id"])
        if ev["ph"] == "i":
            ce["s"] = ev.get("s", "t")
        if "args" in ev:
            ce["args"] = ev["args"]
        out.append(ce)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(tracer_or_events, path: str, *,
                       process_name: str = "repro") -> dict:
    obj = to_chrome_trace(tracer_or_events, process_name=process_name)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")
    return obj


def validate_chrome_trace(obj) -> list[str]:
    """Check a trace object against the Chrome trace event schema.

    Returns a list of problems (empty == valid): top-level shape, the
    required fields per phase, non-negative durations, and that every
    async begin (``ph="b"``) has a matching end (``ph="e"``) on the
    same ``(cat, id)``.
    """
    errs: list[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' array"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' must be an array"]
    opened: dict[tuple, int] = {}
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            errs.append(f"event {i}: invalid ph {ph!r}")
            continue
        if "name" not in ev:
            errs.append(f"event {i}: missing name")
        if ph != "M":
            if not isinstance(ev.get("ts"), (int, float)):
                errs.append(f"event {i}: missing/invalid ts")
            if not isinstance(ev.get("pid"), int):
                errs.append(f"event {i}: missing/invalid pid")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event {i}: X event needs dur >= 0")
        if ph in ("b", "n", "e"):
            if "id" not in ev:
                errs.append(f"event {i}: async event missing id")
            if "cat" not in ev:
                errs.append(f"event {i}: async event missing cat")
            key = (ev.get("cat"), str(ev.get("id")))
            if ph == "b":
                opened[key] = opened.get(key, 0) + 1
            elif ph == "e":
                if opened.get(key, 0) <= 0:
                    errs.append(f"event {i}: async end without begin {key}")
                else:
                    opened[key] -= 1
    for key, n in opened.items():
        if n > 0:
            errs.append(f"async begin without end: {key} (x{n})")
    return errs


def reconstruct_request(obj_or_events, rid_or_id) -> list[dict]:
    """Lifecycle of one request from an exported trace (or a raw event
    list): every async event whose id mentions ``req:<rid>``, in
    timestamp order.  Pass either a bare rid or a full scoped id."""
    if isinstance(obj_or_events, dict):
        events = obj_or_events.get("traceEvents", [])
    else:
        events = getattr(obj_or_events, "events", obj_or_events)
    needle = str(rid_or_id)
    if "req:" not in needle:
        needle = f"req:{needle}"
    out = [ev for ev in events
           if ev.get("ph") in ("b", "n", "e")
           and str(ev.get("id", "")).endswith(needle)]
    out.sort(key=lambda ev: ev.get("ts", 0.0))
    return out


def text_timeline(tracer_or_events, *, width: int = 64,
                  max_rows: int = 40) -> str:
    """Compact per-track ASCII timeline of the span (``ph="X"``) events."""
    events = getattr(tracer_or_events, "events", tracer_or_events)
    spans = [ev for ev in events if ev.get("ph") == "X"]
    if not spans:
        return "(no spans)"
    t0 = min(ev["ts"] for ev in spans)
    t1 = max(ev["ts"] + ev.get("dur", 0.0) for ev in spans)
    scale = (width - 1) / max(t1 - t0, 1e-9)
    lines = [f"timeline: {len(spans)} spans over "
             f"{(t1 - t0) / 1e3:.2f} ms"]
    # widest spans first; one row each
    for ev in sorted(spans, key=lambda e: -e.get("dur", 0.0))[:max_rows]:
        a = int((ev["ts"] - t0) * scale)
        b = max(a + 1, int((ev["ts"] + ev.get("dur", 0.0) - t0) * scale))
        bar = " " * a + "#" * (b - a)
        lines.append(f"{bar:<{width}} {ev.get('track', 'main')}:"
                     f"{ev['name']} {ev.get('dur', 0.0) / 1e3:.3f}ms")
    if len(spans) > max_rows:
        lines.append(f"... ({len(spans) - max_rows} more spans)")
    return "\n".join(lines)
