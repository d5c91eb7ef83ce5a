"""Training augmentations on the device and mask bit-packing (port of
``uwcv_tpu/data/augment.py``).

The reference's pipeline (nn_train.py:134-144) after the host resize:
brightness (blend with black), contrast (blend with the mean), saturation
(blend with gray), rot90 with ``rotation_prob``, PCA lighting, vertical
flip, then a clip to 0..255.  Blends follow Detectron2's BlendTransform,
out = (1-w)·src + w·img.  Geometric ops apply to image (HWC RGB f32
0..255), instance masks and XYXY boxes alike; images are square.

``augment_draws`` makes every random value a batch needs from a
``torch.Generator`` (torch's numbers are not ``jax.random``'s, so a test
hands both packages the same final values instead); ``augment_batch``
applies them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from uwcv_tpu_torch.config import InputConfig

# ITU-R 601 luma weights (RGB), Detectron2 RandomSaturation
_GRAY_RGB = (0.299, 0.587, 0.114)
# ImageNet PCA lighting basis (RGB), Detectron2 RandomLighting
_EIGVEC = ((-0.5675, 0.7192, 0.4009),
           (-0.5808, -0.0045, -0.8140),
           (-0.5836, -0.6948, 0.4203))
_EIGVAL = (0.2175, 0.0188, 0.0045)


def augment_draws(n: int, cfg: InputConfig,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> Dict[str, torch.Tensor]:
    """Every random value ``augment_batch`` consumes for ``n`` samples: the
    three blend weights [n] (uniform in their ranges), do_rot / do_flip [n]
    bool, and the lighting normals [n, 3] (before ``lighting_scale``)."""
    u = lambda: torch.rand(n, generator=generator, device=device)
    span = lambda lo, hi: lo + (hi - lo) * u()
    return {
        "brightness": span(*cfg.brightness_range),
        "contrast": span(*cfg.contrast_range),
        "saturation": span(*cfg.saturation_range),
        "do_rot": u() < cfg.rotation_prob,
        "lighting": torch.randn(n, 3, generator=generator, device=device),
        "do_flip": u() < cfg.vflip_prob,
    }


def _blend(img, src, w):
    return (1.0 - w) * src + w * img


def _rows(flag: torch.Tensor, ndim: int) -> torch.Tensor:
    """[B] bool → broadcastable [B, 1, ...] of rank ``ndim``."""
    return flag.reshape((-1,) + (1,) * (ndim - 1))


def rot90_boxes(boxes: torch.Tensor, size: int) -> torch.Tensor:
    """XYXY boxes under a CCW rot90 of a size×size image: (x, y) → (y, W-x)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([y1, size - x2, y2, size - x1], dim=-1)


def vflip_boxes(boxes: torch.Tensor, height: int) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1, height - y2, x2, height - y1], dim=-1)


def augment_batch(batch: Dict[str, torch.Tensor], cfg: InputConfig,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """The reference pipeline on a batch: {image [B,S,S,3] f32 RGB 0..255,
    boxes [B,N,4], masks [B,N,S,S] bool (optional), ...}; other keys pass
    through.  ``draws`` (``augment_draws``) are the random values; without
    them they are drawn from ``generator``.  Per sample, in the order of
    ``augment_sample`` (augment.py:104-157)."""
    img = batch["image"]
    boxes = batch["boxes"]
    masks = batch.get("masks")
    b, size = img.shape[0], img.shape[1]
    if img.shape[1] != img.shape[2]:
        raise ValueError("rot90 augmentation needs square images")
    if draws is None:
        draws = augment_draws(b, cfg, generator, img.device)
    w = lambda k: draws[k].to(img.dtype).reshape(b, 1, 1, 1)

    img = _blend(img, 0.0, w("brightness"))
    img = _blend(img, img.mean(dim=(1, 2, 3), keepdim=True), w("contrast"))
    gray = (img * torch.tensor(_GRAY_RGB, dtype=img.dtype,
                               device=img.device)).sum(-1, keepdim=True)
    img = _blend(img, gray, w("saturation"))

    # RandomRotation(angle=[90,90]) with rotation_prob (augment.py:127-141)
    if tuple(cfg.rotation_angles) == (90.0,):
        rot = draws["do_rot"]
        img = torch.where(_rows(rot, 4), torch.rot90(img, 1, (1, 2)), img)
        boxes = torch.where(_rows(rot, 3), rot90_boxes(boxes, size), boxes)
        if masks is not None:
            masks = torch.where(_rows(rot, 4), torch.rot90(masks, 1, (2, 3)),
                                masks)

    # Detectron2 RandomLighting: eigvecs·(w·eigvals) added to the 0-255 image
    eigvec = torch.tensor(_EIGVEC, dtype=img.dtype, device=img.device)
    eigval = torch.tensor(_EIGVAL, dtype=img.dtype, device=img.device)
    weights = draws["lighting"].to(img.dtype) * cfg.lighting_scale
    delta = (weights * eigval) @ eigvec.T                        # [B,3]
    img = img + delta[:, None, None, :]

    flip = draws["do_flip"]
    img = torch.where(_rows(flip, 4), img.flip(1), img)
    boxes = torch.where(_rows(flip, 3), vflip_boxes(boxes, size), boxes)
    if masks is not None:
        masks = torch.where(_rows(flip, 4), masks.flip(2), masks)

    out = dict(batch)
    out["image"] = img.clamp(0.0, 255.0)
    out["boxes"] = boxes
    if masks is not None:
        out["masks"] = masks
    return out


def augment_sample(sample: Dict[str, torch.Tensor], cfg: InputConfig,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
    """``augment_batch`` for one sample {image [S,S,3], boxes [N,4],
    masks [N,S,S], ...}; ``draws`` hold one value each ([1] / [1, 3])."""
    keys = [k for k in ("image", "boxes", "masks") if k in sample]
    out = augment_batch({k: sample[k][None] for k in keys}, cfg, generator,
                        draws)
    res = dict(sample)
    res.update({k: out[k][0] for k in keys})
    return res


def pack_bitmasks(masks: torch.Tensor) -> torch.Tensor:
    """[..., W] bool → [..., W/8] uint8, MSB first (``np.packbits`` order,
    which ``np.unpackbits`` in ``Predictor.to_instances`` inverts)."""
    *lead, w = masks.shape
    if w % 8:
        raise ValueError(f"width {w} not a multiple of 8")
    bits = masks.reshape(*lead, w // 8, 8).to(torch.uint8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=masks.device)
    return (bits * weights).sum(dim=-1, dtype=torch.uint8)


def unpack_bitmasks(packed: torch.Tensor, width: int) -> torch.Tensor:
    """[..., W/8] uint8 bit-packed masks (``np.packbits``, MSB first) →
    [..., W] bool."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)[..., :width] != 0
