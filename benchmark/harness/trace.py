"""A traced window: ``torch.profiler`` over a callable, reduced to the
device's busy time, the traced window's length, device time by kernel
name, and the longest idle gaps by what the host was doing."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merge(intervals: List[Tuple[float, float]]):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def traced(fn, workdir: str) -> Dict:
    """Run ``fn()`` under the profiler (CPU and CUDA activities), the card
    synchronized at the end.  → {"busy_s", "window_s", "device": [(name,
    start_us, dur_us)], "device_ops": top 10 [name, s], "idle_gaps": top
    10 [name, s]}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    dev = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
           for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    cpu = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
           for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    merged = _merge([(s, s + d) for _, s, d in dev])
    busy_us = sum(e - s for s, e in merged)
    by_name: Dict[str, float] = {}
    for name, _, d in dev:
        by_name[name[:64]] = by_name.get(name[:64], 0.0) + d * 1e-6
    # the idle stretches between device work, and before and after it
    # within the traced window (the span of all recorded events)
    ends = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in events if e.get("ph") == "X"]
    t0, t1 = min(s for s, _ in ends), max(e for _, e in ends)
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    cpu.sort(key=lambda c: c[1])
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        inside = [c for c in cpu if c[1] <= mid <= c[1] + c[2]]
        name = (min(inside, key=lambda c: c[2])[0] if inside
                else "host outside torch ops")
        named.append([name[:64], (e - s) * 1e-6])
    return {"busy_s": busy_us * 1e-6, "window_s": window, "device": dev,
            "device_ops": [[k, v] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": named}


def kernel_seconds(trace: Dict, *patterns: str) -> float:
    """Device seconds of the kernels whose name holds one of ``patterns``."""
    return sum(d for n, _, d in trace["device"]
               if any(p in n for p in patterns)) * 1e-6


def stage_ms(marks) -> Dict[str, float]:
    """Mean ms a batch (or step) between consecutive CUDA-event marks,
    named by the later mark."""
    out: Dict[str, float] = {}
    for run in marks:
        for (_, a), (name, b) in zip(run, run[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b) / len(marks)
    return out
