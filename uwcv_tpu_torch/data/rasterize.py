"""Polygon → bitmask rasterization on the host (port of
``uwcv_tpu/data/rasterize.py``).

The JAX package fills polygons with PIL where PIL is installed (which also
draws each outline) and with a numpy even-odd scanline fill elsewhere.  The
port has one rasterizer on every machine: that scanline fill, so its ground
truth is the same with or without PIL.  It differs from the JAX package's
PIL path at polygon edges only (measured in
``tests/test_torch_port_eval.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def polygons_to_mask(
    polygons: Sequence[Sequence[float]],
    height: int,
    width: int,
) -> np.ndarray:
    """Flat-xy polygon list(s) → [H, W] bool mask (union of polygons)."""
    mask = np.zeros((height, width), dtype=bool)
    for poly in polygons:
        pts = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
        if len(pts) >= 3:
            mask |= _scanline_fill(pts, height, width)
    return mask


def _scanline_fill(pts: np.ndarray, height: int, width: int) -> np.ndarray:
    """Even-odd scanline polygon fill at pixel centres, vectorized over the
    crossings of each row."""
    mask = np.zeros((height, width), dtype=bool)
    ys = np.arange(height) + 0.5
    x0, y0 = pts[:, 0], pts[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    for yi, y in enumerate(ys):
        crosses = (y0 <= y) != (y1 <= y)
        if not crosses.any():
            continue
        t = (y - y0[crosses]) / (y1[crosses] - y0[crosses])
        xs = np.sort(x0[crosses] + t * (x1[crosses] - x0[crosses]))
        for a, b in zip(xs[0::2], xs[1::2]):
            lo = max(int(np.ceil(a - 0.5)), 0)
            hi = min(int(np.ceil(b - 0.5)), width)
            if hi > lo:
                mask[yi, lo:hi] = True
    return mask


def annotations_to_arrays(
    annotations: Sequence[dict],
    height: int,
    width: int,
    max_instances: int,
    rasterize_masks: bool = True,
    include_crowd: bool = False,
) -> dict:
    """Dataset-dict annotations → fixed-capacity padded numpy arrays.

    Returns {boxes [N,4] f32, classes [N] i32, valid [N] bool,
    masks [N,H,W] bool (if rasterize_masks), num_instances}.  Instances
    beyond ``max_instances`` are dropped (largest box area kept first).
    ``include_crowd=True`` keeps ``iscrowd`` annotations and adds an
    ``iscrowd [N] bool`` output (the evaluation convention: crowd ground
    truth is an ignore-match); uncompressed COCO RLE segmentations
    (``segmentation_rle``) rasterize through ``measure/rle.py``.
    """
    annos = [a for a in annotations
             if include_crowd or not a.get("iscrowd", 0)]
    if len(annos) > max_instances:
        def area(a):
            x1, y1, x2, y2 = a["bbox"]
            return (x2 - x1) * (y2 - y1)
        annos = sorted(annos, key=area, reverse=True)[:max_instances]

    n = len(annos)
    boxes = np.zeros((max_instances, 4), dtype=np.float32)
    classes = np.zeros((max_instances,), dtype=np.int32)
    valid = np.zeros((max_instances,), dtype=bool)
    out = {"boxes": boxes, "classes": classes, "valid": valid}
    if include_crowd:
        iscrowd = np.zeros((max_instances,), dtype=bool)
        out["iscrowd"] = iscrowd
    if rasterize_masks:
        masks = np.zeros((max_instances, height, width), dtype=bool)
        out["masks"] = masks
    for i, a in enumerate(annos):
        boxes[i] = a["bbox"]
        classes[i] = a["category_id"]
        valid[i] = True
        if include_crowd:
            iscrowd[i] = bool(a.get("iscrowd", 0))
        if rasterize_masks:
            rle = a.get("segmentation_rle")
            if rle is not None:
                from uwcv_tpu_torch.measure.rle import rle_from_coco

                m = rle_from_coco(rle)
                mh, mw = m.shape
                masks[i, :min(mh, height), :min(mw, width)] = \
                    m[:height, :width]
            else:
                masks[i] = polygons_to_mask(a["segmentation"], height,
                                            width)
    out["num_instances"] = n
    return out
