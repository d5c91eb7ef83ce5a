"""Polygon fill, the benchmark's reference for the ground-truth masks: a
pixel is inside when its centre lies inside the polygon by the even-odd
rule (crossings of the pixel's row at or left of its centre are odd)."""

from __future__ import annotations

import torch


def rasterize(poly: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """poly [P, 2] (x, y) → [height, width] bool."""
    poly = poly.double()
    out = torch.zeros((height, width), dtype=torch.bool, device=poly.device)
    lo = poly.min(0).values.floor().clamp_min(0).long()
    hi = poly.max(0).values.ceil().long() + 1
    x_hi, y_hi = min(int(hi[0]), width), min(int(hi[1]), height)
    x_lo, y_lo = int(lo[0]), int(lo[1])
    if x_hi <= x_lo or y_hi <= y_lo:
        return out
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = poly.roll(-1, 0)[:, 0], poly.roll(-1, 0)[:, 1]
    cy = torch.arange(y_lo, y_hi, device=poly.device, dtype=torch.float64) + 0.5
    cx = torch.arange(x_lo, x_hi, device=poly.device, dtype=torch.float64) + 0.5
    crosses = (y0[None] <= cy[:, None]) != (y1[None] <= cy[:, None])   # [Y,E]
    t = (cy[:, None] - y0[None]) / torch.where(y1 == y0, 1.0, y1 - y0)[None]
    xs = x0[None] + t * (x1 - x0)[None]
    left = crosses[:, None, :] & (xs[:, None, :] <= cx[None, :, None])
    out[y_lo:y_hi, x_lo:x_hi] = left.sum(-1) % 2 == 1
    return out
