"""Contour extraction & geometry, cv2-free (port of
``uwcv_tpu/measure/contours.py``).

- ``find_contours``: external boundaries of 8-connected components via
  Moore-neighbour tracing (cv2 CHAIN_APPROX_NONE convention: contour points
  are pixel coordinates (x, y)), labelled and traced by the port's host C++
  (``utils/native.py``); ``find_contours_reference`` is the plain version
  (scipy labelling + the Python tracer) the tests hold it against;
- ``contour_area``: shoelace over the traced boundary (cv2.contourArea);
- ``arc_length``: closed polygon perimeter (cv2.arcLength(closed=True));
- ``min_area_rect`` + ``box_points``: rotating calipers over the convex
  hull — the minimum-area enclosing rectangle like cv2.minAreaRect.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from uwcv_tpu_torch.utils import native

# Moore neighborhood in clockwise order starting East, as (dx, dy)
_MOORE = [(1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1)]


def _trace_boundary(mask: np.ndarray, start: Tuple[int, int]) -> np.ndarray:
    """Moore-neighbor boundary trace from ``start`` (x, y), clockwise.

    mask is a 0/1 uint8 array with a 1-pixel zero border guaranteed by the
    caller.  Returns [K, 2] (x, y) boundary pixel coordinates.
    """
    sx, sy = start
    contour = [(sx, sy)]
    # backtrack direction: we entered start scanning left-to-right, so the
    # previous (outside) pixel is to the west → start search from W.
    prev_dir = 4  # index of (-1, 0) West
    cx, cy = sx, sy
    # Termination: stop when the (pixel, backtrack) STATE repeats — the
    # walk is deterministic, so the first repeated state closes the full
    # boundary cycle.  Naive stop-at-start loses whole lobes of components
    # pinched diagonally at the start pixel (e.g. [[0,1,0],[1,0,1]]), and
    # plain Jacob's criterion can stop before a second lobe is traced.
    seen = {(cx, cy, prev_dir)}
    while True:
        found = False
        # search clockwise starting from the neighbor after the backtrack
        for i in range(8):
            d = (prev_dir + 1 + i) % 8
            dx, dy = _MOORE[d]
            nx, ny = cx + dx, cy + dy
            if mask[ny, nx]:
                # new backtrack = direction pointing back to current pixel,
                # i.e. opposite of d, then step one back (Moore tracing rule)
                prev_dir = (d + 4) % 8
                cx, cy = nx, ny
                found = True
                break
        if not found:  # isolated pixel
            break
        state = (cx, cy, prev_dir)
        if state in seen:
            break
        seen.add(state)
        contour.append((cx, cy))
        if len(contour) > 8 * mask.size:  # safety
            break
    return np.asarray(contour, dtype=np.float64)


def find_contours(mask: np.ndarray, min_area: float = 0.0) -> List[np.ndarray]:
    """External contours of all 8-connected components (cv2 RETR_EXTERNAL).

    Returns a list of [K, 2] float arrays of (x, y) boundary points, sorted
    left-to-right by their smallest x (the reference sorts contours
    left-to-right via imutils, nn_inference.py:408).  ``min_area`` filters
    by *pixel count* of the component (a cheap pre-filter; the caller
    applies the cv2-style area threshold).  Union-find labelling and the
    pointer-walk tracer run in the host C++.
    """
    labels, n_comp = native.label_components(mask)
    contours = []
    for comp in range(1, n_comp + 1):
        if min_area and (labels == comp).sum() < min_area:
            continue
        pts = native.moore_trace(labels, comp)
        if len(pts):
            contours.append(pts)
    contours.sort(key=lambda c: c[:, 0].min())
    return contours


def find_contours_reference(mask: np.ndarray,
                            min_area: float = 0.0) -> List[np.ndarray]:
    """Plain version of :func:`find_contours`: scipy labelling, then the
    Python tracer on each component's cropped bounding box."""
    import scipy.ndimage as ndi

    labels, _ = ndi.label(mask.astype(np.uint8), structure=np.ones((3, 3)))
    contours = []
    for comp_id, slc in enumerate(ndi.find_objects(labels), start=1):
        if slc is None:
            continue
        ys, xs = slc
        comp = (labels[slc] == comp_id)
        if min_area and comp.sum() < min_area:
            continue
        # pad with a zero border for tracing
        padded = np.zeros((comp.shape[0] + 2, comp.shape[1] + 2), np.uint8)
        padded[1:-1, 1:-1] = comp
        # first boundary pixel in scan order
        idx = np.argmax(padded.reshape(-1))
        sy, sx = divmod(int(idx), padded.shape[1])
        pts = _trace_boundary(padded, (sx, sy))
        pts[:, 0] += xs.start - 1
        pts[:, 1] += ys.start - 1
        contours.append(pts)
    contours.sort(key=lambda c: c[:, 0].min())
    return contours


def contour_area(contour: np.ndarray) -> float:
    """Shoelace area of the closed polygon through the boundary points."""
    x, y = contour[:, 0], contour[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2)


def arc_length(contour: np.ndarray, closed: bool = True) -> float:
    d = np.diff(contour, axis=0)
    length = float(np.hypot(d[:, 0], d[:, 1]).sum())
    if closed and len(contour) > 1:
        length += float(np.hypot(*(contour[0] - contour[-1])))
    return length


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; returns hull vertices CCW, [H, 2]."""
    pts = np.unique(points, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross2(a, b):
        # 2-D scalar cross product; np.cross on 2-vectors is deprecated
        # (removed in numpy>=2.x for 2-D inputs)
        return a[0] * b[1] - a[1] * b[0]

    def half(seq):
        out: List[np.ndarray] = []
        for p in seq:
            while len(out) >= 2 and cross2(out[-1] - out[-2],
                                           p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def min_area_rect(points: np.ndarray):
    """Minimum-area enclosing rectangle (cv2.minAreaRect equivalent).

    Returns ((cx, cy), (w, h), angle_deg) with w measured along the edge the
    rectangle sits on — rotating calipers over every hull edge.
    """
    hull = convex_hull(points)
    if len(hull) == 1:
        return (tuple(hull[0]), (0.0, 0.0), 0.0)
    if len(hull) == 2:
        c = hull.mean(axis=0)
        d = hull[1] - hull[0]
        return ((float(c[0]), float(c[1])),
                (float(np.hypot(*d)), 0.0),
                float(math.degrees(math.atan2(d[1], d[0]))))

    best = None
    n = len(hull)
    for i in range(n):
        edge = hull[(i + 1) % n] - hull[i]
        norm = np.hypot(*edge)
        if norm < 1e-12:
            continue
        ux = edge / norm                      # unit x along edge
        uy = np.array([-ux[1], ux[0]])        # unit y
        proj_x = hull @ ux
        proj_y = hull @ uy
        w = proj_x.max() - proj_x.min()
        h = proj_y.max() - proj_y.min()
        area = w * h
        if best is None or area < best[0]:
            cx = (proj_x.max() + proj_x.min()) / 2
            cy = (proj_y.max() + proj_y.min()) / 2
            center = cx * ux + cy * uy
            angle = math.degrees(math.atan2(ux[1], ux[0]))
            best = (area, (float(center[0]), float(center[1])),
                    (float(w), float(h)), angle)
    return best[1], best[2], best[3]


def box_points(rect) -> np.ndarray:
    """Rect → 4 corner points [4, 2] (cv2.boxPoints equivalent)."""
    (cx, cy), (w, h), angle = rect
    a = math.radians(angle)
    ux = np.array([math.cos(a), math.sin(a)])
    uy = np.array([-math.sin(a), math.cos(a)])
    c = np.array([cx, cy])
    hw, hh = w / 2.0, h / 2.0
    return np.asarray([
        c - hw * ux - hh * uy,
        c + hw * ux - hh * uy,
        c + hw * ux + hh * uy,
        c - hw * ux + hh * uy,
    ])


def order_points(pts: np.ndarray) -> np.ndarray:
    """Order 4 points tl, tr, br, bl (the reference's perspective-transform
    ordering used before the caliper midpoints, nn_inference.py:418-431)."""
    x_sorted = pts[np.argsort(pts[:, 0])]
    left = x_sorted[:2]
    right = x_sorted[2:]
    tl, bl = left[np.argsort(left[:, 1])]
    # br = farthest from tl among the right pair (imutils convention)
    d = np.hypot(*(right - tl).T)
    br, tr = right[np.argsort(d)][::-1][0], right[np.argsort(d)][0]
    return np.asarray([tl, tr, br, bl])


def midpoint(a, b) -> Tuple[float, float]:
    return ((a[0] + b[0]) * 0.5, (a[1] + b[1]) * 0.5)
