"""Mean device ms a training step's augmentation takes (mask unpacking,
the draws and ``augment_batch``): the CUDA events of the program's
``augment`` spans, over the traced window's steps."""

from benchmark.harness import spans


def read(ctx):
    rec, n = spans.record(), spans.per(ctx)
    ms = rec.device_ms().get("augment") if rec is not None and n else None
    return ms / n if ms is not None else None
