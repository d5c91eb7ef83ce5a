"""Anchor generation — a numpy-only copy of ``uwcv_tpu/models/anchors.py``.

Rebuilds Detectron2's DefaultAnchorGenerator (exercised inside the reference's
GeneralizedRCNN, SURVEY.md N2): per FPN level, a base set of
len(aspect_ratios)×len(sizes) anchors centered at (0,0) is shifted over the
feature grid with the level stride.  Because the rebuild uses static padded
image sizes, anchors are plain constants folded into the compiled program —
no per-step anchor computation at all.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def generate_cell_anchors(
    sizes: Sequence[float], aspect_ratios: Sequence[float]
) -> np.ndarray:
    """[len(sizes)*len(aspect_ratios), 4] XYXY anchors centered at origin.

    Matches Detectron2's generate_cell_anchors: area = size**2,
    w = sqrt(area/ar), h = ar*w.
    """
    anchors = []
    for size in sizes:
        area = size * size
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, dtype=np.float32)


def anchors_for_level(
    feat_h: int,
    feat_w: int,
    stride: int,
    sizes: Sequence[float],
    aspect_ratios: Sequence[float],
) -> np.ndarray:
    """[feat_h*feat_w*A, 4] anchors for one FPN level.

    Grid offsets follow Detectron2: centers at (x*stride, y*stride) —
    row-major over (y, x), anchor index fastest.
    """
    cell = generate_cell_anchors(sizes, aspect_ratios)  # [A,4]
    shift_x = np.arange(feat_w, dtype=np.float32) * stride
    shift_y = np.arange(feat_h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)  # [H,W]
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)  # [HW,1,4]
    return (shifts + cell[None, :, :]).reshape(-1, 4)


def generate_anchors(
    image_size: Tuple[int, int],
    strides: Sequence[int],
    sizes_per_level: Sequence[Sequence[float]],
    aspect_ratios: Sequence[float],
) -> List[np.ndarray]:
    """Per-level anchor arrays for a padded image of `image_size` (H, W).

    Feature dims are ceil(H/stride) — matching backbone padding='SAME'
    behavior on multiple-of-stride static sizes.
    """
    h, w = image_size
    out = []
    for stride, sizes in zip(strides, sizes_per_level):
        fh = -(-h // stride)
        fw = -(-w // stride)
        out.append(anchors_for_level(fh, fw, stride, sizes, aspect_ratios))
    return out
