"""Mean ms a training step in which the card is idle while the host is
outside every ``Trainer.train_step`` (the caller's index upload and
gather, its generator, the loss pull), over the traced window's steps."""

from benchmark.harness import micrographs, spans


def read(ctx):
    rec, n = spans.record(), spans.per(ctx)
    if rec is None or not n or not rec.named("train_step"):
        return None
    t = spans.window_trace(ctx, rec, micrographs.workdir("trace"))
    return spans.idle_outside(t, "train_step") * 1e-3 / n if t else None
