"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one (the CPU tests pass ``device="cpu"``).  With no CUDA and
    no explicit device this raises instead of silently running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def mark(marks: Optional[list], name: str) -> None:
    """Append ``(name, CUDA event)`` to ``marks`` when a caller collects
    per-stage timings; a no-op (no event, no sync) otherwise."""
    if marks is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))
