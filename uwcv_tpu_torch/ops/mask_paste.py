"""Mask paste-to-image (port of ``uwcv_tpu/ops/mask_paste.py::paste_masks``).

Detectron2's ``paste_masks_in_image``: a predicted [M, M] mask in
roi-relative coordinates is bilinearly resampled onto the image canvas.
Each output pixel inverse-maps into roi space; the weights are separable,
so the paste is two batched matmuls per mask.  ``paste_select_pack`` is
the fused paste → overlap claim → min-pixel filter → bit-pack tail
(``postprocess.paste_chunk > 0``).
"""

from __future__ import annotations

import torch

from uwcv_tpu_torch.data.augment import pack_bitmasks


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


def _pad_dets(x: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    """Append ``pad`` zero (False) detections along ``axis``."""
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def paste_select_pack(probs: torch.Tensor, boxes: torch.Tensor,
                      keep: torch.Tensor, scores: torch.Tensor, image_size,
                      min_pixels: int = 0, do_remove_overlaps: bool = True,
                      threshold: float = 0.5, chunk: int = 10,
                      dtype=torch.float32, extent=None):
    """Fused paste → overlap claim → min-pixel filter → bit-pack (port of
    ``uwcv_tpu/ops/mask_paste.py::paste_select_pack``).

    The unfused chain (``paste_masks`` → ``remove_overlaps`` → count filter
    → pack) holds the whole [..., D, H, W] mask stack several times over.
    Here a loop walks the detections in score-rank order, ``chunk`` at a
    time (the JAX ``lax.scan``), carrying only the [..., H, W] pixel-owner
    map: each step pastes its chunk, claims still-unowned pixels (first
    painter wins, as ``remove_overlaps``' best-rank winner), applies the
    min-pixel filter and emits the chunk already bit-packed.

    probs [..., D, M, M] float head-resolution masks (cleaned), boxes
    [..., D, 4] XYXY, keep [..., D] bool, scores [..., D], extent (optional
    [..., H, W] bool: each image's true extent inside the canvas) →
    (packed [..., D, H, W/8] uint8 in the original detection order,
    keep_out [..., D] bool after the min-pixel filter).  Bit-identical to
    the unfused chain."""
    h, w = image_size
    d = probs.shape[-3]
    pad = -d % chunk
    if pad:
        probs = _pad_dets(probs, pad, -3)
        boxes = _pad_dets(boxes, pad, -2)
        keep = _pad_dets(keep, pad, -1)
        scores = _pad_dets(scores, pad, -1)
    dp = d + pad
    # rank = place in the score-descending order of the keep masks; the
    # rest rank last and never claim a pixel
    order = torch.sort(-torch.where(keep, scores, torch.full_like(
        scores, -float("inf"))), dim=-1, stable=True).indices
    ranks = torch.arange(dp, device=probs.device).expand_as(order)
    inv = torch.empty_like(order).scatter_(-1, order, ranks)
    probs_o = probs.gather(-3, order[..., None, None].expand_as(probs))
    boxes_o = boxes.gather(-2, order[..., None].expand_as(boxes))
    keep_o = keep.gather(-1, order)
    owner = torch.full(probs.shape[:-3] + (h, w), dp, dtype=torch.int32,
                       device=probs.device)
    packed, kept = [], []
    for base in range(0, dp, chunk):
        kc = keep_o[..., base:base + chunk]
        img = paste_masks(probs_o[..., base:base + chunk, :, :],
                          boxes_o[..., base:base + chunk, :], (h, w),
                          threshold, dtype)
        img &= kc[..., None, None]
        if extent is not None:
            img &= extent[..., None, :, :]
        if do_remove_overlaps:
            rank = torch.arange(base, base + chunk, dtype=torch.int32,
                                device=probs.device)[:, None, None]
            eff = torch.where(img, rank, torch.full_like(rank, dp))
            owner = torch.minimum(owner, eff.amin(dim=-3))
            img &= eff == owner[..., None, :, :]
        ok = kc & (img.sum(dim=(-2, -1)) >= min_pixels)
        img &= ok[..., None, None]
        packed.append(pack_bitmasks(img))
        kept.append(ok)
    packed_r = torch.cat(packed, dim=-3)
    kept_r = torch.cat(kept, dim=-1)
    packed_out = packed_r.gather(-3, inv[..., None, None].expand_as(packed_r))
    return packed_out[..., :d, :, :], kept_r.gather(-1, inv)[..., :d]


def crop_and_resize_masks(gt_masks: torch.Tensor, boxes: torch.Tensor,
                          out_size: int, index=None) -> torch.Tensor:
    """GT bitmasks sampled inside boxes [N,4] → [N,S,S] float targets:
    bilinear samples at bin centres (Detectron2 BitMasks.crop_and_resize,
    ROIAlign aligned=True on the bitmask; port of
    ``uwcv_tpu/ops/mask_paste.py::crop_and_resize_masks``).  ``gt_masks``
    is [N,H,W], or [M,H,W] with ``index`` [N] naming each box's mask, so
    the caller need not gather whole masks."""
    n = boxes.shape[0]
    h, w = gt_masks.shape[-2:]
    dev = boxes.device
    if index is None:
        index = torch.arange(n, device=dev)
    t = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) \
        / out_size
    x1, y1, x2, y2 = boxes.unbind(-1)
    xs = (x1[:, None] + t * (x2 - x1).clamp_min(1e-6)[:, None] - 0.5).clamp(
        0.0, w - 1.0)
    ys = (y1[:, None] + t * (y2 - y1).clamp_min(1e-6)[:, None] - 0.5).clamp(
        0.0, h - 1.0)
    x0 = torch.floor(xs).to(torch.int64)
    y0 = torch.floor(ys).to(torch.int64)
    x1i = (x0 + 1).clamp_max(w - 1)
    y1i = (y0 + 1).clamp_max(h - 1)
    fx = (xs - x0)[:, None, :]
    fy = (ys - y0)[:, :, None]
    m = index[:, None, None]
    corner = lambda yy, xx: gt_masks[m, yy[:, :, None], xx[:, None, :]].float()
    top = corner(y0, x0) * (1 - fx) + corner(y0, x1i) * fx
    bot = corner(y1i, x0) * (1 - fx) + corner(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy
