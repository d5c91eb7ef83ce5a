"""Mean ms a batch in which the card is idle while the host is in the
model part of a prediction: inside the program's ``predict`` spans and
outside their ``mask tail`` (on the profiler's clock), over the traced
window's batches."""

from benchmark.harness import micrographs, spans


def read(ctx):
    rec, n = spans.record(), spans.per(ctx)
    if rec is None or not n or not rec.named("predict"):
        return None
    t = spans.window_trace(ctx, rec, micrographs.workdir("trace"))
    if t is None:
        return None
    idle_us = spans.idle_within(t, "predict") - spans.idle_within(
        t, "mask tail")
    return idle_us * 1e-3 / n
