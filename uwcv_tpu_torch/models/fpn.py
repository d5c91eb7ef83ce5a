"""Feature Pyramid Network over ResNet C2..C5 (port of
``uwcv_tpu/models/fpn.py``): 1x1 laterals, nearest 2× top-down, 3x3 output
convs, and P6 = P5 subsampled by 2 (Flax ``max_pool`` with a 1×1 window and
stride 2, fpn.py:47).  NCHW inside.

With a model ``axis`` (``parallel/spatial.py``) it runs on row shards:
the 3×3 output convs exchange halo rows; the laterals, the nearest 2×
top-down and P6 are row-local (every interior shard boundary is a
multiple of 64 image rows)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from uwcv_tpu_torch.parallel.spatial import spatial_conv2d


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """[B,C,H,W] → [B,C,2H,2W], each cell repeated 2×2."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class FPN(nn.Module):
    def __init__(self, channels: int = 256,
                 in_channels=(256, 512, 1024, 2048)):
        super().__init__()
        for i, c_in in zip(range(2, 6), in_channels):
            setattr(self, f"lateral_c{i}", nn.Conv2d(c_in, channels, 1))
            setattr(self, f"output_p{i}",
                    nn.Conv2d(channels, channels, 3, padding=1))

    def forward(self, feats: Dict[str, torch.Tensor], axis=None
                ) -> Dict[str, torch.Tensor]:
        lat = {f"c{i}": getattr(self, f"lateral_c{i}")(feats[f"c{i}"])
               for i in range(2, 6)}
        td = {"c5": lat["c5"]}
        for upper, lower in (("c5", "c4"), ("c4", "c3"), ("c3", "c2")):
            td[lower] = lat[lower] + upsample2x_nearest(td[upper])
        out = {f"p{i}": spatial_conv2d(td[f"c{i}"],
                                       getattr(self, f"output_p{i}"), axis)
               for i in range(2, 6)}
        out["p6"] = out["p5"][:, :, ::2, ::2]
        return out
