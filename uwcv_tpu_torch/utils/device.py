"""Device selection for the port's entry points, and the optional stage
timers of its measurement runs."""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one (the CPU tests pass ``device="cpu"``).  Without CUDA a
    ``cuda`` device raises instead of silently running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def mark(marks: Optional[list], name: str) -> None:
    """Append ``(name, CUDA event)`` to ``marks`` when a caller collects
    per-stage timings; a no-op (no event, no sync) otherwise."""
    if marks is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))


class HostStages:
    """Host-clock seconds and call counts per named stage, summed over
    ``with stages("name"):`` blocks from any thread.  A caller that wants
    the split sets ``predictor.stages = HostStages()``; the folder pipeline
    adds its own stages to the same record."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[name] = self.seconds.get(name, 0.0) + dt
                self.calls[name] = self.calls.get(name, 0) + 1


def host_stage(stages: Optional[HostStages], name: str):
    """``stages(name)``, or a no-op context when no one collects."""
    return contextlib.nullcontext() if stages is None else stages(name)
