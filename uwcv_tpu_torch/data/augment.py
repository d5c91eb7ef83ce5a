"""Mask bit-packing (port of ``uwcv_tpu/data/augment.py::pack_bitmasks``).

The training augmentations of the JAX module belong to the training slice
and are not ported yet."""

from __future__ import annotations

import torch


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
