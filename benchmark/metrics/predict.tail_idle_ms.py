"""Mean ms a batch in which the card is idle while the host is inside the
mask tail (the program's ``mask tail`` spans, on the profiler's clock),
over the traced window's batches."""

from benchmark.harness import micrographs, spans


def read(ctx):
    rec, n = spans.record(), spans.per(ctx)
    if rec is None or not n or not rec.named("mask tail"):
        return None
    t = spans.window_trace(ctx, rec, micrographs.workdir("trace"))
    return spans.idle_within(t, "mask tail") * 1e-3 / n if t else None
