"""Mean ms a training step in which the card is idle while the host is
inside the backward (the program's ``backward`` spans, on the profiler's
clock), over the traced window's steps."""

from benchmark.harness import micrographs, spans


def read(ctx):
    rec, n = spans.record(), spans.per(ctx)
    if rec is None or not n or not rec.named("backward"):
        return None
    t = spans.window_trace(ctx, rec, micrographs.workdir("trace"))
    return spans.idle_within(t, "backward") * 1e-3 / n if t else None
