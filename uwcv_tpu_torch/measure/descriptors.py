"""Shape descriptors — the reference's 9-metric caliper sweep
(nn_inference.py:411-459) as a pure function per contour (a copy of
``uwcv_tpu/measure/descriptors.py``).

Formulas preserved exactly (nn_inference.py:434-449):
    dA, dB       = caliper midpoint distances of the min-area rect
    Length       = min(dA, dB) / ppm
    Width        = max(dA, dB) / ppm
    Feret        = max(dA, dB) / ppm
    AspectRatio  = Width / Length
    Roundness    = 1 / AspectRatio
    CircularED   = sqrt(4·area/π) / ppm
    Chords       = arcLength (perimeter) / ppm
    Sphericity   = 2·sqrt(π·area) / perimeter      (dimensionless)
    Circularity  = 4π·area / perimeter²            (dimensionless)

(The reference divides the pixel measures by ``pixelsPerMetric``; area-based
quantities use pixel area with the ppm division applied to the derived
diameter, matching nn_inference.py:440,444.)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from uwcv_tpu_torch.measure.contours import (
    arc_length,
    box_points,
    contour_area,
    find_contours,
    midpoint,
    min_area_rect,
    order_points,
)

DESCRIPTOR_NAMES = (
    "Feret Diameter", "Aspect Ratio", "Roundness", "Circularity",
    "Sphericity", "Length", "Width", "CircularED", "Chords",
)


@dataclass
class ShapeDescriptors:
    feret: float
    aspect_ratio: float
    roundness: float
    circularity: float
    sphericity: float
    length: float
    width: float
    circular_ed: float
    chords: float
    area_px: float = 0.0
    centroid: tuple = (0.0, 0.0)

    def as_row(self) -> List[float]:
        return [self.feret, self.aspect_ratio, self.roundness,
                self.circularity, self.sphericity, self.length,
                self.width, self.circular_ed, self.chords]


def describe_contour(contour: np.ndarray,
                     pixels_per_metric: float = 0.85) -> ShapeDescriptors:
    """One traced contour → the 9 reference descriptors."""
    rect = min_area_rect(contour)
    box = order_points(box_points(rect))
    tl, tr, br, bl = box
    # caliper midpoints (nn_inference.py:418-431)
    tltr = midpoint(tl, tr)
    blbr = midpoint(bl, br)
    tlbl = midpoint(tl, bl)
    trbr = midpoint(tr, br)
    dA = math.hypot(tltr[0] - blbr[0], tltr[1] - blbr[1])
    dB = math.hypot(tlbl[0] - trbr[0], tlbl[1] - trbr[1])

    ppm = pixels_per_metric
    area = contour_area(contour)
    perimeter = arc_length(contour, closed=True)

    length = min(dA, dB) / ppm
    width = max(dA, dB) / ppm
    feret = max(dA, dB) / ppm
    aspect = width / length if length > 0 else 0.0
    roundness = 1.0 / aspect if aspect > 0 else 0.0
    circular_ed = math.sqrt(4.0 * area / math.pi) / ppm
    chords = perimeter / ppm
    sphericity = (2.0 * math.sqrt(math.pi * area) / perimeter
                  if perimeter > 0 else 0.0)
    circularity = (4.0 * math.pi * area / (perimeter ** 2)
                   if perimeter > 0 else 0.0)

    return ShapeDescriptors(
        feret=feret, aspect_ratio=aspect, roundness=roundness,
        circularity=circularity, sphericity=sphericity, length=length,
        width=width, circular_ed=circular_ed, chords=chords,
        area_px=area, centroid=(float(contour[:, 0].mean()),
                                float(contour[:, 1].mean())))


def measure_mask(
    mask: np.ndarray,
    pixels_per_metric: float = 0.85,
    min_contour_area: float = 100.0,
) -> List[ShapeDescriptors]:
    """Union mask → per-contour descriptors (the reference ORs all selected
    instance masks into one canvas then measures external contours ≥100 px²,
    nn_inference.py:394-412)."""
    out = []
    for contour in find_contours(mask, min_area=0.0):
        if contour_area(contour) < min_contour_area:
            continue
        out.append(describe_contour(contour, pixels_per_metric))
    return out
