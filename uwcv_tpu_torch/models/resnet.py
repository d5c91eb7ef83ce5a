"""ResNet-26/50/101 backbone (port of ``uwcv_tpu/models/resnet.py``).

Internally NCHW (channels-last memory on the GPU, which cuDNN prefers and
which makes the NHWC view at the port's public functions free).  FrozenBN
is a per-channel affine in the compute dtype; stride sits on the 3×3 conv.
Each FrozenBN but a projection's takes what follows it up to the next conv
(the ReLU, and in a block's last one the shortcut, under the projection's
FrozenBN where there is one) as one ``ops/frozen_bn.py::frozen_bn_act``: one
kernel pass on a card where no gradient flows through it.
Module and buffer names follow the Flax param tree, so
``weights.params_from_flax`` maps each leaf by name.

With a model ``axis`` (``parallel/spatial.py``) the backbone runs on row
shards: the stem conv, the stem max-pool and each bottleneck's 3×3 conv
exchange halo rows; the 1×1 convs, FrozenBN, ReLU and the residual add are
row-local.  Without one it is the plain module.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from uwcv_tpu_torch.ops.frozen_bn import frozen_bn_act
from uwcv_tpu_torch.parallel.spatial import spatial_conv2d, spatial_max_pool2d

# 26 is a minimal 1-block-per-stage variant for tests/smoke runs; 50/101 are
# the production depths
STAGE_BLOCKS = {26: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class FrozenBN(nn.Module):
    """y = x·scale + bias per channel (FrozenBatchNorm2d after folding),
    computed in the compute dtype like the Flax module (resnet.py:55);
    then ``+ residual`` (under ``residual_bn`` when given) and the ReLU.
    A projection's FrozenBN is not called: the block hands it to its last
    one as ``residual_bn``."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))

    def forward(self, x, residual=None,
                residual_bn: Optional["FrozenBN"] = None):
        return frozen_bn_act(
            x, self.scale, self.bias, residual,
            None if residual_bn is None else residual_bn.scale,
            None if residual_bn is None else residual_bn.bias)


class Bottleneck(nn.Module):
    """1x1 → 3x3 (strided) → 1x1 bottleneck with optional projection."""

    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_channels: int, stride: int, use_projection: bool):
        super().__init__()
        self.use_projection = use_projection
        if use_projection:
            self.shortcut_conv = nn.Conv2d(in_channels, out_channels, 1,
                                           stride=stride, bias=False)
            self.shortcut_bn = FrozenBN(out_channels)
        self.conv1 = nn.Conv2d(in_channels, bottleneck_channels, 1, bias=False)
        self.bn1 = FrozenBN(bottleneck_channels)
        self.conv2 = nn.Conv2d(bottleneck_channels, bottleneck_channels, 3,
                               stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBN(bottleneck_channels)
        self.conv3 = nn.Conv2d(bottleneck_channels, out_channels, 1,
                               bias=False)
        self.bn3 = FrozenBN(out_channels)

    def forward(self, x, axis=None):
        shortcut = self.shortcut_conv(x) if self.use_projection else x
        y = self.bn1(self.conv1(x))
        y = self.bn2(spatial_conv2d(y, self.conv2, axis))
        return self.bn3(self.conv3(y), residual=shortcut,
                        residual_bn=(self.shortcut_bn if self.use_projection
                                     else None))


class ResNet(nn.Module):
    """Backbone returning {"c2","c3","c4","c5"} NCHW features at /4../32."""

    def __init__(self, depth: int = 50):
        super().__init__()
        if depth not in STAGE_BLOCKS:
            raise ValueError(f"depth must be one of {sorted(STAGE_BLOCKS)}")
        self.blocks = STAGE_BLOCKS[depth]
        self.stem_conv = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = FrozenBN(64)
        in_c = 64
        for stage, (n_blocks, out_c) in enumerate(
                zip(self.blocks, (256, 512, 1024, 2048))):
            for b in range(n_blocks):
                setattr(self, f"res{stage + 2}_block{b}", Bottleneck(
                    in_c, out_c, out_c // 4,
                    stride=(1 if stage == 0 or b > 0 else 2),
                    use_projection=(b == 0)))
                in_c = out_c

    def forward(self, x, axis=None) -> Dict[str, torch.Tensor]:
        x = self.stem_bn(spatial_conv2d(x, self.stem_conv, axis))
        x = spatial_max_pool2d(x, 3, 2, 1, axis)
        feats = {}
        for stage, n_blocks in enumerate(self.blocks):
            for b in range(n_blocks):
                x = getattr(self, f"res{stage + 2}_block{b}")(x, axis)
            feats[f"c{stage + 2}"] = x
        return feats
