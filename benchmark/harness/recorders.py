"""Recorders the benchmark puts around calls into the program's layers: the
proposals the RPN hands to the ROI heads, and the rois each pooler call
takes.  Each wraps a function of ``uwcv_tpu_torch.models.rcnn`` for the
length of a ``with`` block, keeps what the call returned or took, and
changes nothing of the computation."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def proposals(store: dict):
    """``store["last"]``: {"boxes", "logits", "valid"} of the latest
    ``generate_proposals`` call."""
    from uwcv_tpu_torch.models import rcnn

    orig = rcnn.generate_proposals

    def recorded(*args, **kwargs):
        out = orig(*args, **kwargs)
        store["last"] = {"boxes": out.boxes, "logits": out.scores,
                         "valid": out.valid}
        return out

    rcnn.generate_proposals = recorded
    try:
        yield store
    finally:
        rcnn.generate_proposals = orig


@contextlib.contextmanager
def pooler_calls(calls: list):
    """Appends (canvas shape, canvas element size, rois [B,R,4],
    output size) for every ``pool_level_canvas`` call."""
    from uwcv_tpu_torch.models import rcnn

    orig = rcnn.pool_level_canvas

    def recorded(canvas, shapes, rois, *args, **kwargs):
        out = orig(canvas, shapes, rois, *args, **kwargs)
        calls.append((tuple(canvas.shape), canvas.element_size(),
                      [tuple(s) for s in shapes], rois.detach(),
                      out.shape[2]))
        return out

    rcnn.pool_level_canvas = recorded
    try:
        yield calls
    finally:
        rcnn.pool_level_canvas = orig
