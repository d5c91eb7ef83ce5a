"""Mask paste-to-image (port of ``uwcv_tpu/ops/mask_paste.py::paste_masks``).

Detectron2's ``paste_masks_in_image``: a predicted [M, M] mask in
roi-relative coordinates is bilinearly resampled onto the image canvas.
Each output pixel inverse-maps into roi space; the weights are separable,
so the paste is two batched matmuls per mask.  The fused
``paste_select_pack`` of the JAX package is not ported yet.
"""

from __future__ import annotations

import torch


def _axis_weights(dim_out: int, lo: torch.Tensor, hi: torch.Tensor,
                  mask_dim: int) -> torch.Tensor:
    """W[..., out_pix, mask_pix] resampling a 1-D mask axis onto image
    pixels for rois spanning [lo, hi) (mask cell centres at (i+0.5)/M of the
    roi extent), zero outside the roi's 1-cell bilinear skirt."""
    span = (hi - lo).clamp_min(1e-6)
    pix = torch.arange(dim_out, dtype=torch.float32, device=lo.device) + 0.5
    u = (pix - lo[..., None]) / span[..., None] * mask_dim - 0.5   # [...,out]
    uc = u.clamp(0.0, mask_dim - 1.0)
    low = torch.floor(uc)
    frac = uc - low
    li = low.to(torch.int64)
    hi_i = (li + 1).clamp_max(mask_dim - 1)
    cols = torch.arange(mask_dim, device=lo.device)
    w = ((cols == li[..., None]) * (1.0 - frac)[..., None]
         + (cols == hi_i[..., None]) * frac[..., None])
    inside = (u >= -1.0) & (u <= mask_dim + 0.0)
    return w * inside[..., None]


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, image_size,
                threshold: float = 0.5, dtype=torch.float32) -> torch.Tensor:
    """[..., M, M] mask probabilities + [..., 4] XYXY boxes → [..., H, W]
    bool."""
    h, w = image_size
    m = masks.shape[-1]
    wy = _axis_weights(h, boxes[..., 1], boxes[..., 3], m)    # [...,H,M]
    wx = _axis_weights(w, boxes[..., 0], boxes[..., 2], m)    # [...,W,M]
    out = (wy.to(dtype) @ masks.to(dtype)) @ wx.transpose(-1, -2).to(dtype)
    return out > threshold
