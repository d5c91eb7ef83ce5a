"""Mean host ms a batch spends reading the floods' loop condition on the
host: the program's ``host sync`` spans (``ops/morphology.py::_loop``),
over the traced window's batches."""

from benchmark.harness import spans


def read(ctx):
    rec, n = spans.record(), spans.per(ctx)
    syncs = rec.named("host sync") if rec is not None and n else []
    return sum(s.host_ms for s in syncs) / n if syncs else None
