"""The port's instrumentation: CUDA-event marks, and one recorder of spans
and counters.

- ``mark(marks, name)`` appends a CUDA event to a caller's list: device
  time between points on the stream (``Trainer.marks``, ``MaskRCNN.marks``).
- ``span(name, device=None, annotate=True)`` is a context manager around a
  piece of work: its name, a trace id (each top-level span starts a trace,
  and its children share it), its parent (tracked per thread: a mesh
  predictor runs its replicas on pool threads), its host start and end
  (``time.perf_counter_ns``), and a pair of CUDA events on the current
  stream when ``device`` is a CUDA tensor or device.  Under an active
  ``torch.profiler`` an ``annotate``d span also enters
  ``torch.profiler.record_function``, which puts it on the profiler's
  timeline as a ``user_annotation`` beside the kernels; spans as short as
  that call (the floods' host reads) pass ``annotate=False``.
- ``count(name, n=1)`` adds to a per-name integer.

Recording is off by default: ``span`` and ``count`` then read two module
values (the open ``recording()`` block, the profiler's flag) and return,
with no ``record_function`` call, no event, no clock read and no
allocation.  It is on inside ``with recording() as rec:``, whose record
takes the spans and counts of every thread.  Nothing is recorded while
``torch.export`` traces the program (``engine/export.py``): the exported
program stays the live one's.

``PROFILED`` is a stopgap: while a ``torch.profiler`` runs outside any
``recording()`` block, spans and counts go there, so that the benchmark's
traced window, which opens no ``recording()`` block of its own, holds the
program's spans (``benchmark/harness/spans.py`` reads it).  It goes, with
the profiler branch of ``_target``, once the benchmark's traced window
records through ``recording()``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler


def mark(marks: Optional[list], name: str) -> None:
    """Append ``(name, CUDA event)`` to ``marks`` when a caller collects
    per-stage timings; a no-op (no event, no sync) otherwise."""
    if marks is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))


class Span:
    """One recorded span: host times in ns (``time.perf_counter_ns``),
    ``events`` the (start, end) CUDA events or None, ``parent`` the span
    it opened inside on its thread or None."""

    __slots__ = ("name", "trace", "parent", "start_ns", "end_ns", "events")

    def __init__(self, name: str, trace: int, parent: Optional["Span"],
                 events):
        self.name, self.trace, self.parent = name, trace, parent
        self.events = events
        self.end_ns = 0
        self.start_ns = time.perf_counter_ns()

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        """Device ms between the span's CUDA events (waits for the end
        event), or None for a host-only span."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


class Record:
    """The spans (in the order they opened) and counters of a recording.
    ``max_spans`` keeps only the latest spans."""

    def __init__(self, max_spans: Optional[int] = None):
        self.spans: collections.deque = collections.deque(maxlen=max_spans)
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def named(self, name: str) -> List[Span]:
        return [s for s in list(self.spans) if s.name == name]

    def host_ms(self) -> Dict[str, float]:
        """Host ms summed by span name."""
        out: Dict[str, float] = {}
        for s in list(self.spans):
            out[s.name] = out.get(s.name, 0.0) + s.host_ms
        return out

    def device_ms(self) -> Dict[str, float]:
        """Device ms (CUDA events) summed by span name, over the spans that
        have events."""
        out: Dict[str, float] = {}
        for s in list(self.spans):
            if s.events is not None:
                out[s.name] = out.get(s.name, 0.0) + s.device_ms
        return out

    def calls(self) -> Dict[str, int]:
        """Spans by name."""
        return dict(collections.Counter(s.name for s in list(self.spans)))

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.counters.clear()


# what torch profiler windows record outside any ``recording()`` block (the
# latest 2**17 spans; a stopgap, see the module's docstring): a process that
# profiles more than one window clears it between them
PROFILED = Record(max_spans=1 << 17)
_RECORD: Optional[Record] = None     # the open ``recording()`` block's
_TRACE_IDS = itertools.count(1)
_NULL = contextlib.nullcontext()


class _Open(threading.local):
    def __init__(self):
        self.spans: List[Span] = []


_OPEN = _Open()


def _target() -> Optional[Record]:
    if _RECORD is not None:
        return _RECORD
    return PROFILED if _profiler._is_profiler_enabled else None


class _SpanContext:
    __slots__ = ("record", "name", "stream", "annotate", "span",
                 "annotation")

    def __init__(self, record: Record, name: str, stream, annotate: bool):
        self.record, self.name, self.stream = record, name, stream
        self.annotate = annotate

    def __enter__(self):
        stack = _OPEN.spans
        parent = stack[-1] if stack else None
        events = None
        if self.stream is not None:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(self.stream)
        # the clock is read outside the annotation at both ends, so that
        # the span holds its annotation and the profiler's own time in it
        self.span = Span(self.name, parent.trace if parent else
                         next(_TRACE_IDS), parent, events)
        self.annotation = None
        if self.annotate and _profiler._is_profiler_enabled:
            self.annotation = _profiler.record_function(self.name)
            self.annotation.__enter__()
        self.record.spans.append(self.span)
        stack.append(self.span)
        return self.span

    def __exit__(self, *exc):
        span = self.span
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        span.end_ns = time.perf_counter_ns()
        if span.events is not None:
            span.events[1].record(self.stream)
        _OPEN.spans.remove(span)
        return False


def _stream(device):
    """The current stream of ``device`` (a tensor, device or name) if it is
    a CUDA one, else None."""
    if device is None:
        return None
    dev = device.device if isinstance(device, torch.Tensor) else \
        torch.device(device)
    return torch.cuda.current_stream(dev) if dev.type == "cuda" else None


def span(name: str, device=None, annotate: bool = True):
    """``with span(name):`` records the block as a span when recording is
    on (see the module's docstring); a shared no-op context otherwise.
    ``device``: a tensor or device whose CUDA stream gets the span's start
    and end events; ``annotate``: also a ``record_function`` under an
    active profiler."""
    record = _target()
    if record is None or torch.compiler.is_exporting():
        return _NULL
    return _SpanContext(record, name, _stream(device), annotate)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` when recording is on."""
    record = _target()
    if record is not None and not torch.compiler.is_exporting():
        record.add(name, n)


@contextlib.contextmanager
def recording() -> Iterator[Record]:
    """Turn recording on for the block, for every thread: → the record
    that takes its spans and counts.  Blocks nest; the inner one's record
    takes what runs inside it."""
    global _RECORD
    outer, _RECORD = _RECORD, Record()
    try:
        yield _RECORD
    finally:
        _RECORD = outer
