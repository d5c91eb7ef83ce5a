"""The program's own spans and counters in a traced window, and the card's
idle time inside and outside them.

While ``torch.profiler`` runs, the program's recorder
(``uwcv_tpu_torch/utils/trace.py``) keeps every span and counter in
``PROFILED``: a traced window (``harness/trace.py::traced``) fills it
without asking.  The spans' host times are ``time.perf_counter_ns``;
``clock_offset_us`` maps them onto the profiler's clock, on which the
trace's device intervals lie, so the idle stretches between device work
can be put down to the span the host was in.  A program without the
recorder gives no record, and every reader then gives nothing.

``record``, ``clock_offset_us`` and ``window_trace`` are a stopgap for
what ``harness/trace.py::traced`` does not return yet: once it returns
the profiler's ``user_annotation`` events and the cells' ``traced_window``
open the program's ``recording()`` around the window, the readers take
the annotations and that record, and these three go, with the program's
``PROFILED``."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def _merge(intervals: Sequence[Interval]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle(trace: Dict) -> List[List[float]]:
    """The merged stretches of ``trace["window_us"]`` (start, end) in which
    no event of ``trace["device"]`` [(name, start µs, duration µs)] ran."""
    t0, t1 = trace["window_us"]
    busy = _merge([(max(s, t0), min(s + d, t1)) for _, s, d in
                   trace["device"] if s + d > t0 and s < t1])
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    return [[edges[i], edges[i + 1]] for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def _overlap(a: Sequence[Sequence[float]], b: Sequence[Sequence[float]]
             ) -> float:
    """µs that two lists of merged, sorted intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_within(trace: Dict, name: str) -> float:
    """µs of the window's idle time inside the intervals of the spans
    ``name`` in ``trace["spans"]`` [(name, start µs, duration µs)], each
    instant counted once however the spans nest or overlap."""
    spans = _merge([(s, s + d) for n, s, d in trace["spans"] if n == name])
    return _overlap(idle(trace), spans)


def idle_outside(trace: Dict, name: str) -> float:
    """µs of the window's idle time outside every span ``name``."""
    return sum(e - s for s, e in idle(trace)) - idle_within(trace, name)


def record():
    """The program's record of the traced window (``PROFILED``), or None
    when the program has no recorder or recorded nothing."""
    try:
        from uwcv_tpu_torch.utils.trace import PROFILED
    except ImportError:
        return None
    return PROFILED if len(PROFILED.spans) or PROFILED.counters else None


_OFFSET: List[float] = []


def clock_offset_us(workdir: str, samples: int = 32) -> float:
    """The profiler's trace clock minus ``time.perf_counter_ns() / 1000``,
    in µs.  Each sample reads the host clock just inside a
    ``record_function`` of a short CPU profile: the annotation opens before
    the first read and closes after the second, which bounds the offset
    from both sides; the bounds of all samples are intersected."""
    if _OFFSET:
        return _OFFSET[0]
    from torch.profiler import ProfilerActivity, profile, record_function

    reads = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(samples):
            with record_function(f"clock {i}"):
                a = time.perf_counter_ns()
                b = time.perf_counter_ns()
            reads.append((a * 1e-3, b * 1e-3))
    path = os.path.join(workdir, "clock.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    marks = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("clock ")}
    lo = max(marks[f"clock {i}"][0] - a for i, (a, _) in enumerate(reads))
    hi = min(marks[f"clock {i}"][1] - b for i, (_, b) in enumerate(reads))
    _OFFSET.append((lo + hi) / 2)
    return _OFFSET[0]


def window_trace(ctx: Dict, rec, workdir: str) -> Optional[Dict]:
    """The traced window as ``idle``/``idle_within`` take it: the device
    events of ``ctx["trace"]``, the record's spans on the profiler's clock,
    and the window, whose end is the last device event's (the window ends
    in a synchronize) and whose length is the traced window's on the
    host's clock.  None without device events."""
    t = ctx["trace"]
    if not t["device"]:
        return None
    off = clock_offset_us(workdir)
    end = max(s + d for _, s, d in t["device"])
    return {"device": t["device"], "window_us": (end - t["window_s"] * 1e6,
                                                 end),
            "spans": [(s.name, s.start_ns * 1e-3 + off,
                       (s.end_ns - s.start_ns) * 1e-3)
                      for s in list(rec.spans)]}


def per(ctx: Dict) -> Optional[int]:
    """The traced window's steps or batches."""
    return ctx.get("steps") or ctx.get("batches")
