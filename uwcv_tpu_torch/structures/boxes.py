"""Box geometry in PyTorch — XYXY_ABS convention throughout
(port of ``uwcv_tpu/structures/boxes.py``).

Padded (zero-area) boxes produce zero IoU rows/cols rather than NaNs.
Box2Box parameterization matches Detectron2's Box2BoxTransform, used by the
RPN (weights 1,1,1,1) and the ROI heads (weights 10,10,5,5).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class Detections(NamedTuple):
    """Padded per-image detections on the device (``models/heads.py``
    makes them; an exported program's loader rebuilds them from its flat
    outputs)."""
    boxes: torch.Tensor    # [B, D, 4]
    scores: torch.Tensor   # [B, D]
    classes: torch.Tensor  # [B, D] int64
    valid: torch.Tensor    # [B, D] bool


# Detectron2 clamps dw/dh to log(1000/16) before exp to avoid overflow.
_SCALE_CLAMP = math.log(1000.0 / 16.0)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of [..., 4] XYXY boxes (0 for degenerate/padded boxes)."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0)
    return w * h


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: [..., N, 4] × [..., M, 4] → [..., N, M].  Padded boxes
    → 0 IoU.  The arithmetic order (area1 + area2 - inter, then
    inter / max(union, 1e-12)) is the one the NMS kernel repeats."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12),
                       torch.zeros_like(inter))


def clip_boxes(boxes: torch.Tensor, image_size: Tuple[int, int]) -> torch.Tensor:
    """Clip XYXY boxes to [0,W]×[0,H].  image_size is (H, W)."""
    h, w = image_size
    return torch.stack([boxes[..., 0].clamp(0.0, w),
                        boxes[..., 1].clamp(0.0, h),
                        boxes[..., 2].clamp(0.0, w),
                        boxes[..., 3].clamp(0.0, h)], dim=-1)


def nonempty_boxes(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Bool mask of boxes with both sides > threshold."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > threshold) & (h > threshold)


def encode_deltas(
    src_boxes: torch.Tensor,
    target_boxes: torch.Tensor,
    weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Regression targets (dx,dy,dw,dh) that map src→target
    (Box2BoxTransform.get_deltas), in the JAX package's expression order."""
    wx, wy, ww, wh = weights
    src_w = (src_boxes[..., 2] - src_boxes[..., 0]).clamp_min(1e-6)
    src_h = (src_boxes[..., 3] - src_boxes[..., 1]).clamp_min(1e-6)
    src_cx = src_boxes[..., 0] + 0.5 * src_w
    src_cy = src_boxes[..., 1] + 0.5 * src_h

    tgt_w = (target_boxes[..., 2] - target_boxes[..., 0]).clamp_min(1e-6)
    tgt_h = (target_boxes[..., 3] - target_boxes[..., 1]).clamp_min(1e-6)
    tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
    tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

    dx = wx * (tgt_cx - src_cx) / src_w
    dy = wy * (tgt_cy - src_cy) / src_h
    dw = ww * torch.log(tgt_w / src_w)
    dh = wh * torch.log(tgt_h / src_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_deltas(
    deltas: torch.Tensor,
    boxes: torch.Tensor,
    weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Apply (dx,dy,dw,dh) deltas to boxes (Box2BoxTransform.apply_deltas).

    deltas [..., 4] may broadcast over a trailing class axis against boxes
    [..., 4].
    """
    wx, wy, ww, wh = weights
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-6)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-6)
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp_max(_SCALE_CLAMP)
    dh = (deltas[..., 3] / wh).clamp_max(_SCALE_CLAMP)

    pred_cx = dx * w + cx
    pred_cy = dy * h + cy
    pred_w = torch.exp(dw) * w
    pred_h = torch.exp(dh) * h
    return torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                        pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h],
                       dim=-1)
