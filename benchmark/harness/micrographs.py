"""Seeded synthetic SEM micrographs with instance annotations.

The drawing follows the program's ``data/synthetic.py`` (a noisy dark
floor, a bright rectangular "Scale bar", thin-wall ellipse rings, small
dark "Pore throats", large bright "Pores"), with tens of instances an
image as polyHIPE micrographs carry, drawn inside each shape's bounding
window.  Each annotation is a polygon (32 points an ellipse) with its
XYXY box and class index (0 scale bar, 1 wall, 2 throat, 3 pore).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

ELLIPSE_POINTS = 32


def _ellipse(img, cx, cy, rx, ry, ang, value, ring=0.0):
    h, w = img.shape
    r = max(rx, ry) + 1
    y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 2, h)
    x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 2, w)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    a = np.deg2rad(ang)
    dx, dy = xx - cx, yy - cy
    u = (dx * np.cos(a) + dy * np.sin(a)) / rx
    v = (-dx * np.sin(a) + dy * np.cos(a)) / ry
    r2 = u * u + v * v
    sel = (r2 <= 1.0) & (r2 >= (1.0 - ring) ** 2) if ring else r2 <= 1.0
    img[y0:y1, x0:x1][sel] = value


def _ellipse_polygon(cx, cy, rx, ry, ang) -> np.ndarray:
    t = np.linspace(0, 2 * np.pi, ELLIPSE_POINTS, endpoint=False)
    a = np.deg2rad(ang)
    x = cx + rx * np.cos(t) * np.cos(a) - ry * np.sin(t) * np.sin(a)
    y = cy + rx * np.cos(t) * np.sin(a) + ry * np.sin(t) * np.cos(a)
    return np.stack([x, y], -1)


def draw(rng: np.random.Generator, hw: Tuple[int, int],
         counts: Dict[str, Tuple[int, int]]):
    """One micrograph: (uint8 [H, W], [{"cls", "poly" [P,2], "box"}])."""
    h, w = hw
    img = np.full((h, w), 40, np.uint8)
    img += rng.integers(0, 12, (h, w), dtype=np.uint8)
    anns: List[dict] = []

    def add(cls, poly):
        poly = np.clip(poly, 0, [w, h])
        anns.append({"cls": cls, "poly": poly,
                     "box": np.concatenate([poly.min(0), poly.max(0)])})

    bw, bh = int(rng.uniform(0.25, 0.4) * w), max(4, int(0.02 * h))
    bx, by = int(rng.uniform(0.05, 0.5) * w), int(rng.uniform(0.85, 0.92) * h)
    img[by:by + bh, bx:bx + bw] = 250
    add(0, np.array([[bx, by], [bx + bw, by], [bx + bw, by + bh],
                     [bx, by + bh]], np.float64))
    m = min(h, w)
    for cls, lo, hi, rlo, rhi, val, ring in (
            (3, 0.15, 0.85, 0.04, 0.09, 190, 0.0),
            (2, 0.1, 0.9, 0.015, 0.03, 15, 0.0),
            (1, 0.3, 0.7, 0.08, 0.14, 120, 0.25)):
        name = {3: "pores", 2: "throats", 1: "walls"}[cls]
        for _ in range(int(rng.integers(*counts[name]))):
            cx, cy = rng.uniform(lo, hi, 2) * (w, h)
            rx, ry = rng.uniform(rlo, rhi, 2) * m
            ang = rng.uniform(0, 180)
            _ellipse(img, cx, cy, rx, ry, ang, val, ring)
            add(cls, _ellipse_polygon(cx, cy, rx, ry, ang))
    return img, anns


def write_tiff(path: str, px: np.ndarray) -> None:
    """[H, W] uint8 or uint16 as a one-strip uncompressed little-endian
    grayscale TIFF."""
    h, w = px.shape
    bits = 16 if px.dtype == np.uint16 else 8
    data = px.astype("<u2" if bits == 16 else "u1").tobytes()
    entries = [(256, 4, w), (257, 4, h), (258, 3, bits), (259, 3, 1),
               (262, 3, 1), (273, 4, 8), (277, 3, 1), (278, 4, h),
               (279, 4, len(data))]
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHII" if typ == 4 else "<HHIHxx", tag, typ, 1, val)
        for tag, typ, val in entries) + struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", 8 + len(data)) + data + ifd)


def workdir(name: str) -> str:
    """A fixed directory for the run's files under ``TMPDIR``."""
    import tempfile

    path = os.path.join(tempfile.gettempdir(), "uwcv_bench", name)
    os.makedirs(path, exist_ok=True)
    return path
