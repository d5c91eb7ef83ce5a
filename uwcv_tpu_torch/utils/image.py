"""Image front-end helpers (port of ``uwcv_tpu/utils/image.py``).

Test-time geometry follows Detectron2's ResizeShortestEdge (short edge →
800, long edge capped at 1333).  The scale is computed on the host; the
resample runs either on the host (``host_resize``, downscales, the
predictor's default) or on the device (``device_resize``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# jax.image's weight-normalisation threshold (compute_weight_mat)
_WEIGHT_EPS = 1000.0 * float(np.finfo(np.float32).eps)


def shortest_edge_scale(h: int, w: int, short: int = 800,
                        max_size: int = 1333) -> float:
    """Detectron2 ResizeShortestEdge scale factor."""
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return float(scale)


def pad_to_canvas(img: np.ndarray, canvas_h: int, canvas_w: int) -> np.ndarray:
    """Zero-pad HWC uint8 to the static host canvas (top-left anchored)."""
    h, w = img.shape[:2]
    if h > canvas_h or w > canvas_w:
        img = img[:canvas_h, :canvas_w]
        h, w = img.shape[:2]
    out = np.zeros((canvas_h, canvas_w, img.shape[2]), img.dtype)
    out[:h, :w] = img
    return out


def bucket_up(v: int, bucket: int) -> int:
    """Round ``v`` up to the next multiple of ``bucket``."""
    return -(-v // bucket) * bucket


def host_resize(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Antialiased bilinear resize of an HWC uint8 image on the host — the
    PIL-free stand-in for the JAX predictor's ``Image.resize(BILINEAR)``
    (PIL's BILINEAR widens the triangle filter by the downscale factor, as
    ``antialias=True`` does here).  Within 2 gray levels of PIL."""
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    y = F.interpolate(x.float(), size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=True)
    y = y.round_().clamp_(0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def _resize_weights(input_size: int, output_size: int, scale: torch.Tensor
                    ) -> torch.Tensor:
    """[input_size, output_size] weights of ``jax.image.scale_and_translate``
    (``compute_weight_mat``) for method="bilinear", antialias=True and zero
    translation: a triangle filter widened by 1/scale when downsampling,
    normalised per output sample, and zero for samples that fall outside
    the input."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample_f = ((torch.arange(output_size, dtype=torch.float32, device=dev)
                 + 0.5) * inv_scale - 0.5)
    x = (torch.abs(sample_f[None, :]
                   - torch.arange(input_size, dtype=torch.float32,
                                  device=dev)[:, None]) / kernel_scale)
    weights = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > _WEIGHT_EPS,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def device_resize(image: torch.Tensor, scale: torch.Tensor, out_h: int,
                  out_w: int) -> torch.Tensor:
    """Resample a padded HWC image by ``scale`` onto a static (out_h, out_w)
    canvas: separable triangle-filter weight matrices applied with two
    matmuls, matching ``jax.image.scale_and_translate(method="bilinear",
    antialias=True)``.  Content occupies the top-left scale·(h, w) region;
    the rest is zero.  Returns float32 [out_h, out_w, C]."""
    h, w, _ = image.shape
    scale = scale.to(device=image.device, dtype=torch.float32)
    wy = _resize_weights(h, out_h, scale)               # [h, out_h]
    wx = _resize_weights(w, out_w, scale)               # [w, out_w]
    x = image.to(torch.float32)
    rows = torch.einsum("hwc,hy->ywc", x, wy)
    return torch.einsum("ywc,wx->yxc", rows, wx)
