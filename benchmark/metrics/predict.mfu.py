"""The inference FLOPs (``harness/flops.py::forward``: trunk, FPN and RPN
head on the canvas, the heads on the valid proposals and detections) over
the traced window, as a share of the H100's 989 TFLOP/s dense bf16 peak,
in %."""

from benchmark.harness.flops import PEAK_FLOPS


def read(ctx):
    return 100.0 * ctx["flops"] / ctx["trace"]["window_s"] / PEAK_FLOPS["bf16"]
