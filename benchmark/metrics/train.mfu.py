"""The training step's model FLOPs (``harness/flops.py::train_step``: the
forward, and the backward of what trains) over the traced window, as a
share of the H100's 989 TFLOP/s dense bf16 peak, in %."""

from benchmark.harness.flops import PEAK_FLOPS


def read(ctx):
    return 100.0 * ctx["flops"] / ctx["trace"]["window_s"] / PEAK_FLOPS["bf16"]
