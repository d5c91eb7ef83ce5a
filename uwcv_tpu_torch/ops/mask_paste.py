"""Mask paste-to-image (port of ``uwcv_tpu/ops/mask_paste.py::paste_masks``).

Detectron2's ``paste_masks_in_image``: a predicted [M, M] mask in
roi-relative coordinates is bilinearly resampled onto the image canvas.
Each output pixel inverse-maps into roi space; the weights are separable,
so the paste is two batched matmuls per mask.

The predictor's tail after the head-resolution cleanup (paste → extent →
overlap claim → min-pixel filter → bit-pack) is the op
``uwcv::paste_claim_pack``: on a CUDA tensor it launches the kernels of
``csrc/mask_tail.cu``, which hold no [B, D, H, W] stack; on the CPU it runs
the unfused chain ``paste_claim_pack_reference``.  ``paste_select_pack`` is
the same tail as a loop over chunks of detections (the JAX package's scan),
which the CPU takes with ``postprocess.paste_chunk > 0``.
"""

from __future__ import annotations

import torch

from uwcv_tpu_torch import kernels
from uwcv_tpu_torch.data.augment import pack_bitmasks
from uwcv_tpu_torch.ops.morphology import remove_overlaps

# the kernels' limits: mask rows are 32-bit words, a claim block lists an
# image's detections in shared memory, rectangles are int16
PASTE_MAX_M = 32
PASTE_MAX_D = 1024
PASTE_MAX_SIDE = 32767


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


def extent_map(out_sizes: torch.Tensor, canvas) -> torch.Tensor:
    """[B, H, W] bool: each image's true extent ``out_sizes`` [B, 2] (h, w)
    at the top left of the canvas."""
    h, w = canvas
    yy = torch.arange(h, device=out_sizes.device)[None, :, None]
    xx = torch.arange(w, device=out_sizes.device)[None, None, :]
    return ((yy < out_sizes[:, 0][:, None, None])
            & (xx < out_sizes[:, 1][:, None, None]))


def paste_claim_pack_reference(masks, boxes, keep, scores, out_sizes,
                               height: int, width: int, min_pixels: int,
                               do_remove_overlaps: bool, dtype):
    """Plain PyTorch version of ``paste_claim_pack``: the unfused chain,
    which holds the [B, D, H, W] stack at each step."""
    pasted = paste_masks(masks.float(), boxes, (height, width), dtype=dtype)
    # pasted pixels beyond the image's true extent are not content
    pasted &= extent_map(out_sizes, (height, width))[:, None]
    if do_remove_overlaps:
        ranked = torch.where(keep, scores,
                             torch.full_like(scores, -float("inf")))
        order = torch.sort(-ranked, dim=-1, stable=True).indices
        pasted = remove_overlaps(pasted, order)
    keep = keep & (pasted.sum(dim=(2, 3)) >= min_pixels)
    return pack_bitmasks(pasted & keep[..., None, None]), keep


def paste_claim_pack(masks: torch.Tensor, boxes: torch.Tensor,
                     keep: torch.Tensor, scores: torch.Tensor,
                     out_sizes: torch.Tensor, canvas, min_pixels: int = 0,
                     do_remove_overlaps: bool = True,
                     dtype=torch.float32):
    """Paste → extent → overlap claim → min-pixel filter → bit-pack of
    every detection.

    masks [B, D, M, M] bool (the cleaned head masks), boxes [B, D, 4] XYXY
    in their own dtype, keep [B, D] bool, scores [B, D], out_sizes [B, 2]
    (each image's true h, w), canvas (H, W) with W % 8 == 0; ``dtype`` the
    paste's (float32 or bfloat16) → (packed [B, D, H, W/8] uint8 in the
    original detection order, MSB first; keep [B, D] bool after the
    min-pixel filter).  Kept detections claim pixels in descending score,
    ties to the lower index; their scores must not be -inf or NaN (the
    chain would rank such a detection among the dropped ones).

    Calls the op ``uwcv::paste_claim_pack``, so ``torch.export`` records
    the kernel call.  CPU tensors take the plain chain; CUDA tensors launch
    the two kernels of ``csrc/mask_tail.cu`` (bit-identical to the chain on
    the card) or raise."""
    h, w = canvas
    return torch.ops.uwcv.paste_claim_pack(
        masks, boxes, keep, scores, out_sizes, int(h), int(w),
        int(min_pixels), bool(do_remove_overlaps), dtype)


paste_claim_pack.launches = 0   # op calls on a card (two kernels each)

torch.library.define(
    "uwcv::paste_claim_pack",
    "(Tensor masks, Tensor boxes, Tensor keep, Tensor scores, "
    "Tensor out_sizes, int height, int width, int min_pixels, "
    "bool remove_overlaps, ScalarType dtype) -> (Tensor, Tensor)")


@torch.library.impl("uwcv::paste_claim_pack", "default")
def _paste_claim_pack_op(masks, boxes, keep, scores, out_sizes, height,
                         width, min_pixels, remove_overlaps, dtype):
    if masks.device.type == "cpu":
        return paste_claim_pack_reference(masks, boxes, keep, scores,
                                          out_sizes, height, width,
                                          min_pixels, remove_overlaps, dtype)
    dev = masks.device
    if masks.dim() != 4 or masks.shape[2] != masks.shape[3] \
            or masks.dtype != torch.bool:
        raise ValueError(f"masks must be [B,D,M,M] bool, got "
                         f"{tuple(masks.shape)} {masks.dtype}")
    b, d, m = masks.shape[:3]
    if boxes.shape != (b, d, 4) or keep.shape != (b, d) \
            or scores.shape != (b, d) or out_sizes.shape != (b, 2):
        raise ValueError(f"boxes [B,D,4], keep and scores [B,D], out_sizes "
                         f"[B,2] for masks {tuple(masks.shape)}; got "
                         f"{tuple(boxes.shape)}, {tuple(keep.shape)}, "
                         f"{tuple(scores.shape)}, {tuple(out_sizes.shape)}")
    if keep.dtype != torch.bool or out_sizes.is_floating_point():
        raise ValueError("keep must be bool and out_sizes integer")
    if boxes.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"boxes must be float32, bfloat16 or float16, got "
                         f"{boxes.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the paste dtype must be float32 or bfloat16, got "
                         f"{dtype}")
    if any(t.device != dev for t in (boxes, keep, scores, out_sizes)):
        raise ValueError("every input must be on the masks' device")
    if width % 8:
        raise ValueError(f"width {width} not a multiple of 8")
    if not (1 <= m <= PASTE_MAX_M and 1 <= d <= PASTE_MAX_D
            and 1 <= b <= 65535 and 1 <= min(height, width)
            and max(height, width) <= PASTE_MAX_SIDE):
        raise ValueError(f"paste_claim_pack supports M in 1..{PASTE_MAX_M}, "
                         f"D in 1..{PASTE_MAX_D}, B in 1..65535 and sides "
                         f"in 1..{PASTE_MAX_SIDE}; got M={m}, D={d}, B={b}, "
                         f"{height}×{width}")
    packed = torch.empty((b, d, height, width // 8), dtype=torch.uint8,
                         device=dev)
    # lo and span as _axis_weights takes them, in the boxes' own dtype
    lo = boxes[..., :2]
    geo = torch.cat([lo, (boxes[..., 2:] - lo).clamp_min(1e-6)],
                    -1).float().contiguous()
    counts = torch.zeros((b, d), dtype=torch.int32, device=dev)
    owner = (torch.empty((b, height, width), dtype=torch.int16, device=dev)
             if remove_overlaps else counts)
    keep_out = torch.empty_like(keep)
    masks, keep = masks.contiguous(), keep.contiguous()
    scores = scores.float().contiguous()
    out_sizes = out_sizes.to(torch.int32).contiguous()
    lib = kernels.library("mask_tail")
    with torch.cuda.device(dev):
        rc = lib.uwcv_paste_claim_pack(
            masks.data_ptr(), geo.data_ptr(), keep.data_ptr(),
            scores.data_ptr(), out_sizes.data_ptr(), counts.data_ptr(),
            owner.data_ptr(), packed.data_ptr(), keep_out.data_ptr(), b, d,
            m, height, width, min_pixels, int(remove_overlaps),
            int(dtype == torch.bfloat16), kernels.stream_ptr(dev))
    kernels.check(rc, "paste_claim_pack")
    kernels.count_launch(paste_claim_pack)
    return packed, keep_out


@torch.library.register_fake("uwcv::paste_claim_pack")
def _(masks, boxes, keep, scores, out_sizes, height, width, min_pixels,
      remove_overlaps, dtype):
    b, d = keep.shape
    return (masks.new_empty((b, d, height, width // 8), dtype=torch.uint8),
            torch.empty_like(keep))


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
