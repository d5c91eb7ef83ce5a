"""Plain PyTorch mask tail, the benchmark's reference for what the
predictor does after the mask head: threshold at 0.5, fill holes (scipy's
``binary_fill_holes``: background not 4-connected to the border), smooth
(erosion of the dilation, cross footprint, border counted as set), drop
masks of more than one 8-connected component, paste each 28×28 mask into
the image by bilinear resampling over its box (Detectron2's
``paste_masks_in_image``), give each pixel to the best-scored mask that
covers it, and drop masks under ``min_pixels``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shift_or(m: torch.Tensor, fill: bool, diag: bool) -> torch.Tensor:
    """OR of m with its 4 (``diag``: 8) neighbours; outside reads ``fill``."""
    p = F.pad(m.float(), (1, 1, 1, 1), value=float(fill)) > 0.5
    h, w = m.shape[-2:]
    out = m.clone()
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)) + (
            ((-1, -1), (-1, 1), (1, -1), (1, 1)) if diag else ()):
        out |= p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    return out


def fill_holes(m: torch.Tensor) -> torch.Tensor:
    bg = ~m
    reach = torch.zeros_like(m)
    reach[..., 0, :] = bg[..., 0, :]
    reach[..., -1, :] = bg[..., -1, :]
    reach[..., :, 0] |= bg[..., :, 0]
    reach[..., :, -1] |= bg[..., :, -1]
    while True:
        nxt = _shift_or(reach, False, False) & bg
        if torch.equal(nxt, reach):
            break
        reach = nxt
    return m | (bg & ~reach)


def smooth(m: torch.Tensor) -> torch.Tensor:
    dil = _shift_or(m, False, False)
    return ~_shift_or(~dil, False, False)


def components(m: torch.Tensor) -> torch.Tensor:
    """Number of 8-connected components of each [..., H, W] mask."""
    h, w = m.shape[-2:]
    lead = m.shape[:-2]
    big = h * w + 1
    ids = torch.arange(h * w, device=m.device, dtype=torch.float32).reshape(
        h, w).expand(m.shape)
    lab = torch.where(m, ids, torch.full_like(ids, big))
    while True:
        nb = -F.max_pool2d(-lab.reshape(-1, 1, h, w), 3, 1, 1).reshape(
            lead + (h, w))
        nxt = torch.where(m, torch.minimum(lab, nb), lab)
        if torch.equal(nxt, lab):
            break
        lab = nxt
    return (m & (lab == ids)).sum(dim=(-2, -1))


def paste(probs: torch.Tensor, boxes: torch.Tensor, hw) -> torch.Tensor:
    """[..., M, M] probabilities, [..., 4] boxes → [..., H, W] bool."""
    m = probs.shape[-1]

    def axis(n, lo, hi):
        pix = torch.arange(n, dtype=torch.float32, device=lo.device) + 0.5
        u = (pix - lo[..., None]) / (hi - lo).clamp_min(1e-6)[..., None] * m - 0.5
        uc = u.clamp(0, m - 1)
        low = torch.floor(uc)
        frac = uc - low
        li = low.long()
        hi_i = (li + 1).clamp_max(m - 1)
        cells = torch.arange(m, device=lo.device)
        wts = ((cells == li[..., None]) * (1 - frac)[..., None]
               + (cells == hi_i[..., None]) * frac[..., None])
        return wts * ((u >= -1) & (u <= m))[..., None]

    wy = axis(hw[0], boxes[..., 1], boxes[..., 3])
    wx = axis(hw[1], boxes[..., 0], boxes[..., 2])
    return (wy @ probs.float()) @ wx.transpose(-1, -2) > 0.5


def tail(probs, boxes, scores, valid, content_hw, canvas_hw, pp):
    """probs [D,28,28] (the detection's class), boxes [D,4], scores [D],
    valid [D] of one image; ``pp``: the postprocess settings.  → (masks
    [D,H,W] bool on the canvas, keep [D])."""
    m = probs > 0.5
    if pp["fill_holes"]:
        m = fill_holes(m)
    if pp["smooth"]:
        m = smooth(m)
    single = torch.ones(m.shape[:-2], dtype=torch.bool, device=m.device)
    if pp["drop_fragmented"]:
        single = components(m) <= 1
        m = m & single[..., None, None]
    keep = valid & single & (scores >= pp["score_floor"])
    masks = paste(m.float(), boxes, canvas_hw)
    inside = torch.zeros(canvas_hw, dtype=torch.bool, device=m.device)
    inside[:content_hw[0], :content_hw[1]] = True
    masks &= inside
    if pp["remove_overlaps"]:
        order = torch.sort(torch.where(keep, scores, torch.full_like(
            scores, -float("inf"))), descending=True, stable=True).indices
        claimed = torch.zeros(canvas_hw, dtype=torch.bool, device=m.device)
        for i in order.tolist():
            masks[i] &= ~claimed
            if keep[i]:
                claimed |= masks[i]
    keep &= masks.sum(dim=(1, 2)) >= pp["min_mask_pixels"]
    return masks & keep[:, None, None], keep
