"""Mean flood passes a batch of the mask tail's cleanup: the program's
counters ``flood passes.fill_holes`` and ``flood passes.components``
(``ops/morphology.py::_loop``), over the traced window's batches."""

from benchmark.harness import spans

NAMES = ("flood passes.fill_holes", "flood passes.components")


def read(ctx):
    rec, n = spans.record(), spans.per(ctx)
    if rec is None or not n or not any(k in rec.counters for k in NAMES):
        return None
    return sum(rec.counters.get(k, 0) for k in NAMES) / n
