"""The card's idle time put down to the program's spans
(``harness/spans.py``): overlaps worked by hand on synthetic windows, and
the host clock of the program's spans mapped onto the profiler's."""

import json
import os

import pytest

from benchmark.harness import spans

# a window of 0..100 µs; device work at 10..20, 15..30 (overlapping) and
# 60..70, so the idle stretches are 0..10, 30..60 and 70..100 (70 µs)
WINDOW = {"window_us": (0.0, 100.0),
          "device": [("k1", 10.0, 10.0), ("k2", 15.0, 15.0),
                     ("memcpy", 60.0, 10.0)],
          "spans": [("step", 5.0, 60.0),       # 5..65
                    ("backward", 25.0, 20.0),  # 25..45, inside the step
                    ("backward", 40.0, 15.0),  # 40..55, overlaps the last
                    ("tail", 68.0, 40.0)]}     # 68..108, past the window


def test_idle_stretches():
    assert spans.idle(WINDOW) == [[0.0, 10.0], [30.0, 60.0], [70.0, 100.0]]


@pytest.mark.parametrize("name, inside", [
    ("step", 5.0 + 30.0),          # 5..10 and 30..60
    ("backward", 25.0),            # 30..55, each instant once
    ("tail", 30.0),                # 70..100, the window's end clips it
    ("absent", 0.0)])
def test_idle_within_and_outside(name, inside):
    assert spans.idle_within(WINDOW, name) == pytest.approx(inside)
    assert spans.idle_within(WINDOW, name) + spans.idle_outside(
        WINDOW, name) == pytest.approx(70.0)


def test_device_work_past_the_window_is_clipped():
    t = dict(WINDOW, device=WINDOW["device"] + [("late", 95.0, 20.0)],
             window_us=(0.0, 100.0))
    assert spans.idle(t)[-1] == [70.0, 95.0]
    assert spans.idle_within(t, "tail") == pytest.approx(25.0)


def test_no_record_without_spans():
    from uwcv_tpu_torch.utils.trace import PROFILED

    PROFILED.clear()
    assert spans.record() is None


def test_program_spans_land_on_their_annotations(tmp_path):
    """Spans recorded under a CPU profile, their host times moved by
    ``clock_offset_us``, hold the profile's own ``user_annotation`` of
    each, give or take 25 µs, and little more: the span's clock reads sit
    just outside the annotation's.  A first span takes the profiler's
    one-off cost of its first annotation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from uwcv_tpu_torch.utils.trace import PROFILED, span

    PROFILED.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("first"):
            pass
        for i in range(4):
            with span(f"work {i}"):
                torch.ones(256, 256).matmul(torch.ones(256, 256))
    path = os.path.join(tmp_path, "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ann = {e["name"]: (e["ts"], e["ts"] + e["dur"])
               for e in json.load(f)["traceEvents"]
               if e.get("cat") == "user_annotation"}
    got = [s for s in PROFILED.spans if s.name != "first"]
    PROFILED.clear()
    off = spans.clock_offset_us(str(tmp_path))
    assert len(got) == 4
    for s in got:
        a, b = ann[s.name]
        start, end = s.start_ns * 1e-3 + off, s.end_ns * 1e-3 + off
        assert start <= a + 25 and b - 25 <= end, (s.name, start - a,
                                                   end - b)
        assert end - start < 1.5 * (b - a) + 100, (s.name, end - start,
                                                   b - a)
