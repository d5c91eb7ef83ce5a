"""Operations and bytes from shapes: the model's FLOPs (multiply-adds of
its convolutions and dense layers, ×2) for a forward pass or a training
step, and the least bytes and operations of the RoIAlign kernel and its
backward, against the H100's published peaks.

Counts follow the configuration and the rois and detections that the
inputs need; padded slots are not counted.  A kernel that changes how the
work is done leaves these counts alone.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from benchmark.harness.weights import MASK_CONV, STAGE_BLOCKS

# NVIDIA H100 SXM data sheet, dense
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def conv(h, w, cin, cout, k, s=1, p=0):
    """(FLOPs, out h, out w) of a k×k convolution."""
    ho, wo = _out(h, k, s, p), _out(w, k, s, p)
    return 2.0 * ho * wo * cout * cin * k * k, ho, wo


def trunk_layers(m: dict, h: int, w: int) -> List[Tuple[str, float]]:
    """(layer path, forward FLOPs) of backbone, FPN and RPN head for one
    image of h × w."""
    out = []
    f, ho, wo = conv(h, w, 3, 64, 7, 2, 3)
    out.append(("backbone/stem_conv", f))
    ho, wo = _out(ho, 3, 2, 1), _out(wo, 3, 2, 1)
    cin = 64
    level_hw = {}
    for s, n in enumerate(STAGE_BLOCKS[m["depth"]]):
        cout = (256, 512, 1024, 2048)[s]
        mid = cout // 4
        for b in range(n):
            p = f"backbone/res{s + 2}_block{b}"
            stride = 2 if (s > 0 and b == 0) else 1
            if b == 0:
                out.append((f"{p}/shortcut_conv",
                            conv(ho, wo, cin, cout, 1, stride)[0]))
            out.append((f"{p}/conv1", conv(ho, wo, cin, mid, 1)[0]))
            f, h2, w2 = conv(ho, wo, mid, mid, 3, stride, 1)
            out.append((f"{p}/conv2", f))
            ho, wo = h2, w2
            out.append((f"{p}/conv3", conv(ho, wo, mid, cout, 1)[0]))
            cin = cout
        level_hw[s + 2] = (ho, wo, cout)
    fc = m["fpn_channels"]
    for i in range(2, 6):
        lh, lw, c = level_hw[i]
        out.append((f"fpn/lateral_c{i}", conv(lh, lw, c, fc, 1)[0]))
        out.append((f"fpn/output_p{i}", conv(lh, lw, fc, fc, 3, 1, 1)[0]))
    lh, lw, _ = level_hw[5]
    level_hw[6] = ((lh + 1) // 2, (lw + 1) // 2, fc)
    a = len(m["anchor_aspect_ratios"])
    for i in range(2, 7):
        lh, lw, _ = level_hw[i]
        out.append((f"rpn_head/rpn_conv@p{i}", conv(lh, lw, fc, fc, 3, 1, 1)[0]))
        out.append((f"rpn_head/objectness@p{i}", conv(lh, lw, fc, a, 1)[0]))
        out.append((f"rpn_head/anchor_deltas@p{i}",
                    conv(lh, lw, fc, 4 * a, 1)[0]))
    return out


def box_head(m: dict, rois: int) -> float:
    fc, k, p = m["box_fc_dim"], m["num_classes"], m["pooler_resolution_box"]
    return 2.0 * rois * (m["fpn_channels"] * p * p * fc + fc * fc
                         + fc * (k + 1) + fc * 4 * k)


def mask_head(m: dict, rois: int) -> float:
    p = m["pooler_resolution_mask"]
    c = m["fpn_channels"]
    per = 0.0
    for _ in range(4):
        per += 2.0 * p * p * MASK_CONV * c * 9
        c = MASK_CONV
    per += 2.0 * p * p * MASK_CONV * MASK_CONV * 4       # 2×2 deconv
    per += 2.0 * (2 * p) ** 2 * MASK_CONV * m["num_classes"]
    return rois * per


def forward(m: dict, hw: Tuple[int, int], proposals: int, detections: int
            ) -> float:
    """One image's inference FLOPs: trunk, FPN and RPN head on the
    canvas, the box head on its proposals, the mask head on its valid
    detections."""
    return (sum(f for _, f in trunk_layers(m, *hw)) + box_head(m, proposals)
            + mask_head(m, detections))


def _frozen(path: str, freeze_at: int) -> bool:
    return ("/stem_" in "/" + path and freeze_at >= 1) or any(
        freeze_at >= s and f"res{s}_block" in path for s in (2, 3, 4, 5))


def train_step(m: dict, solver: dict, size: int, images: int,
               rois_per_image: int, fg_per_image: int) -> float:
    """FLOPs of one training step: the forward, and for every layer that
    trains the gradients of its weights and (where anything below it
    trains) of its input; frozen layers have no backward.  The box head
    runs on the sampled rois, the mask head on the foreground ones alone
    (the mask loss reads no other)."""
    fwd = bwd = 0.0
    lowest = True
    for path, f in trunk_layers(m, size, size):
        fwd += f
        if _frozen(path, solver["freeze_at"]):
            continue
        # the first trainable layers take an input that needs no gradient
        first = path.startswith(f"backbone/res{solver['freeze_at'] + 1}"
                                "_block0/") and (
            path.endswith("conv1") or path.endswith("shortcut_conv"))
        first |= solver["freeze_at"] >= 2 and path == "fpn/lateral_c2"
        bwd += f if first else 2 * f
    heads = box_head(m, rois_per_image) + mask_head(m, fg_per_image)
    return images * (fwd + bwd + 3 * heads)


# ---------------------------------------------------------------- RoIAlign

def _extent(w: torch.Tensor):
    """First index and length of the nonzero span of [R, P, win] weights."""
    nz = (w != 0).any(dim=1)
    idx = torch.arange(w.shape[-1], device=w.device)
    lo = torch.where(nz, idx, w.shape[-1]).amin(dim=1)
    hi = torch.where(nz, idx, -1).amax(dim=1)
    n = (hi - lo + 1).clamp_min(0)
    return torch.where(n > 0, lo, 0), n


def roi_geometry(rois, level_hw: List[Tuple[int, int]], res: int,
                 window: int, dtype):
    """Each roi's slab, window origin and weights as the configuration's
    pooler places them (``benchmark.reference.maskrcnn.pool``), with the
    weights rounded to the canvas dtype."""
    from benchmark.reference.maskrcnn import pool_geometry

    slab, y0, x0, wy, wx = pool_geometry(rois, level_hw, res, window)
    return slab, y0, x0, wy.to(dtype), wx.to(dtype)


def roi_align_bound(canvas_shape, elem: int, rois, level_hw, res: int,
                    window: int) -> Tuple[float, float]:
    """(bytes, FLOPs) the pooler call needs at least: every canvas cell
    that some roi's nonzero sub-window covers read once, weights and
    origins read once, the output written once; the two contractions
    over the sub-windows."""
    dtype = torch.bfloat16 if elem == 2 else torch.float32
    slab, y0, x0, wy, wx = roi_geometry(rois, level_hw, res, window, dtype)
    s, h, w, c = canvas_shape
    hlo, nh = _extent(wy)
    wlo, nw = _extent(wx)
    diff = torch.zeros((s, h + 1, w + 1), dtype=torch.int32,
                       device=rois.device)
    ys, xs = y0 + hlo, x0 + wlo
    one = torch.ones_like(slab, dtype=torch.int32)
    for dy, dx, sign in ((0, 0, 1), (nh, 0, -1), (0, nw, -1), (nh, nw, 1)):
        diff.index_put_((slab, ys + dy, xs + dx), one * sign, accumulate=True)
    covered = int((diff.cumsum(1).cumsum(2) > 0).sum())
    r = slab.shape[0]
    bytes_ = (covered * c * elem + 2 * r * res * window * 4 + 3 * r * 4
              + r * res * res * c * elem)
    flops = 2.0 * res * c * float((nh * nw).sum() + res * nw.sum())
    return float(bytes_), flops


def roi_align_bwd_bound(canvas_shape, elem: int, rois, level_hw, res: int,
                        window: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of the backward call at least: the pooled gradient,
    weights and origins read once, the canvas gradient written once; the
    two contractions over each roi's sub-window."""
    dtype = torch.bfloat16 if elem == 2 else torch.float32
    slab, y0, x0, wy, wx = roi_geometry(rois, level_hw, res, window, dtype)
    r = slab.shape[0]
    c = canvas_shape[-1]
    _, nh = _extent(wy)
    _, nw = _extent(wx)
    bytes_ = (r * res * res * c * elem + 2 * r * res * window * 4 + 3 * r * 4
              + math.prod(canvas_shape) * elem)
    flops = 2.0 * res * c * float((res * nw + nh * nw).sum())
    return float(bytes_), flops


def bound_seconds(bytes_: float, flops: float, dtype: str = "bf16") -> float:
    return max(bytes_ / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
