"""Mean host ms a training step spends inside ``Trainer.train_step``: the
program's ``train_step`` spans (host clock), over the traced window's
steps."""

from benchmark.harness import spans


def read(ctx):
    rec, n = spans.record(), spans.per(ctx)
    steps = rec.named("train_step") if rec is not None and n else []
    return sum(s.host_ms for s in steps) / n if steps else None
