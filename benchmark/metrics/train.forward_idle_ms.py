"""Mean ms a training step in which the card is idle while the host is
inside the forward (the program's ``forward`` spans, augmentation
included, on the profiler's clock), over the traced window's steps."""

from benchmark.harness import micrographs, spans


def read(ctx):
    rec, n = spans.record(), spans.per(ctx)
    if rec is None or not n or not rec.named("forward"):
        return None
    t = spans.window_trace(ctx, rec, micrographs.workdir("trace"))
    return spans.idle_within(t, "forward") * 1e-3 / n if t else None
