"""The RoIAlign kernel (B1, ``csrc/roi_align.cu``) against its roofline:
for each pooler call of the traced window (box and mask), the least time
it needs at the H100's peaks (``harness/flops.py::roi_align_bound``),
summed, over the device time of the kernel's two launches (task pass,
windows), in %."""

from benchmark.harness.flops import bound_seconds, roi_align_bound
from benchmark.harness.trace import kernel_seconds


def read(ctx):
    spent = kernel_seconds(ctx["trace"], "roi_tasks_kernel",
                           "roi_align_windows_kernel")
    if not ctx["pooler_calls"] or spent <= 0:
        return None
    window = ctx["model"]["pooler_window"]
    least = sum(bound_seconds(*roi_align_bound(shape, elem, rois, lv, res,
                                               window))
                for shape, elem, lv, rois, res in ctx["pooler_calls"])
    return 100.0 * least / spent
