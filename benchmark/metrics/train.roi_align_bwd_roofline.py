"""The RoIAlign backward kernel (B1-bwd, ``csrc/roi_align_bwd.cu``) against
its roofline: for each pooler call of the traced window, the least time
its backward needs at the H100's peaks (``harness/flops.py::
roi_align_bwd_bound``), summed, over the device time of the kernel's two
launches (task pass, tiles), in %."""

from benchmark.harness.flops import bound_seconds, roi_align_bwd_bound
from benchmark.harness.trace import kernel_seconds


def read(ctx):
    spent = kernel_seconds(ctx["trace"], "roi_bwd_tasks_kernel",
                           "roi_bwd_tiles_kernel")
    if not ctx["pooler_calls"] or spent <= 0:
        return None
    window = ctx["model"]["pooler_window"]
    least = sum(bound_seconds(*roi_align_bwd_bound(shape, elem, rois, lv,
                                                   res, window))
                for shape, elem, lv, rois, res in ctx["pooler_calls"])
    return 100.0 * least / spent
