"""Seeded weights of a Mask R-CNN configuration, made on the device.

Flat Flax-layout paths (``params/backbone/stem_conv/kernel``; conv
kernels HWIO, dense kernels [in, out]), the layout the program loads
(``Predictor(cfg, params)``, ``Trainer.load_params``) and the reference
reads.  One normal draw from a ``torch.Generator`` on the card covers every
kernel: lecun-normal scales, Detectron2's small-std RPN and box
regression inits, zero biases, FrozenBN scales of 1 except the stem's
and each block's last (the configuration's ``init``: random weights with
identity FrozenBN let the activations grow through the residual stages
until the heads saturate).  ``init`` also sets the class scores' spread
and the mask predictor's bias, so that random weights give confident
detections and solid masks: the mask tail's floods, whose passes follow
the masks' shapes, then do the same work for every seed.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

STAGE_BLOCKS = {26: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
MASK_CONV = 256


def shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    """Flax path → shape of the model ``m`` (the configuration's model
    section)."""
    out = {}
    f, k, a = m["fpn_channels"], m["num_classes"], len(m["anchor_aspect_ratios"])

    def conv(path, kh, cin, cout, bias=True):
        out[f"params/{path}/kernel"] = (kh, kh, cin, cout)
        if bias:
            out[f"params/{path}/bias"] = (cout,)

    def bn(path, c):
        out[f"params/{path}/frozen_bn_scale"] = (c,)
        out[f"params/{path}/frozen_bn_bias"] = (c,)

    conv("backbone/stem_conv", 7, 3, 64, bias=False)
    bn("backbone/stem_bn", 64)
    cin = 64
    for s, n in enumerate(STAGE_BLOCKS[m["depth"]]):
        cout = (256, 512, 1024, 2048)[s]
        mid = cout // 4
        for b in range(n):
            p = f"backbone/res{s + 2}_block{b}"
            if b == 0:
                conv(f"{p}/shortcut_conv", 1, cin, cout, bias=False)
                bn(f"{p}/shortcut_bn", cout)
            conv(f"{p}/conv1", 1, cin, mid, bias=False)
            bn(f"{p}/bn1", mid)
            conv(f"{p}/conv2", 3, mid, mid, bias=False)
            bn(f"{p}/bn2", mid)
            conv(f"{p}/conv3", 1, mid, cout, bias=False)
            bn(f"{p}/bn3", cout)
            cin = cout
    for i, c in zip(range(2, 6), (256, 512, 1024, 2048)):
        conv(f"fpn/lateral_c{i}", 1, c, f)
        conv(f"fpn/output_p{i}", 3, f, f)
    conv("rpn_head/rpn_conv", 3, f, f)
    conv("rpn_head/objectness", 1, f, a)
    conv("rpn_head/anchor_deltas", 1, f, 4 * a)
    fc = m["box_fc_dim"]
    p = m["pooler_resolution_box"]
    for name, i, o in (("fc1", f * p * p, fc), ("fc2", fc, fc),
                       ("cls_score", fc, k + 1), ("bbox_pred", fc, 4 * k)):
        out[f"params/box_head/{name}/kernel"] = (i, o)
        out[f"params/box_head/{name}/bias"] = (o,)
    c = f
    for i in range(1, 5):
        conv(f"mask_head/mask_fcn{i}", 3, c, MASK_CONV)
        c = MASK_CONV
    conv("mask_head/deconv", 2, MASK_CONV, MASK_CONV)
    conv("mask_head/predictor", 1, MASK_CONV, k)
    return out


def _std(path: str, shape, init: dict) -> float:
    if "cls_score" in path:
        return init["cls_std"]
    if "rpn_head" in path:
        # Detectron2's 0.01 at its width of 256 inputs: objectness keeps
        # that width's spread at any width
        return 0.01 * math.sqrt(256 / shape[-2])
    if "bbox_pred" in path:
        return 0.001
    return 1.0 / math.sqrt(math.prod(shape[:-1]))


def make(m: dict, init: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded f32 weights of model ``m`` on ``device``."""
    table = sorted(shapes(m).items())
    kernels = [(p, s) for p, s in table if p.endswith("/kernel")]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    total = sum(math.prod(s) for _, s in kernels)
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for p, s in kernels:
        n = math.prod(s)
        out[p] = draw[at:at + n].view(s) * _std(p, s, init)
        at += n
    for p, s in table:
        if p.endswith("frozen_bn_scale"):
            # as a trained model's folded BN statistics keep activations
            # near unit scale: the stem's scale takes the pixels' range
            # out, and each residual branch adds a damped share
            v = (init["stem_bn_scale"] if "stem_bn" in p
                 else init["bn3_scale"] if p.endswith("bn3/frozen_bn_scale")
                 else 1.0)
            out[p] = torch.full(s, float(v), device=device)
        elif not p.endswith("/kernel"):
            out[p] = torch.zeros(s, device=device)
    out["params/box_head/cls_score/bias"][0] = init["cls_bias0"]
    out["params/mask_head/predictor/bias"][:] = init["mask_bias"]
    return out


def to_numpy(w: Dict[str, torch.Tensor]):
    return {k: v.detach().cpu().numpy() for k, v in w.items()}
