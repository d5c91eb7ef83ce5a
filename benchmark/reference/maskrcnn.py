"""Plain PyTorch Mask R-CNN (ResNet-FPN), the benchmark's reference.

Written from the published architecture (Detectron2's
``mask_rcnn_R_{50,101}_FPN_3x``: FrozenBN ResNet with the stride on the
3x3 conv, FPN with a max-pooled P6, a shared RPN head, a 2-FC box head and
a 4-conv mask head) and the configuration's stated semantics.  It reads
the weights as a flat dict of Flax-layout tensors (``params/backbone/...``,
conv kernels HWIO, dense kernels [in, out]), runs in float32 with TF32
off, and imports nothing of the program under test.

``quant="fp8"`` rounds every convolution's and dense layer's input and
weight to float8 e4m3 with one scale per tensor (the gradient passes
straight through): the precision step below the bf16 the configurations
state, which the correctness check's control uses.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

LEVELS = ("p2", "p3", "p4", "p5", "p6")
STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
STAGE_BLOCKS = {26: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
NEG = -1e10
_FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """Float32 matmuls and convolutions without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fake_quant(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """x rounded to float8 e4m3 at one scale per tensor (amax → 448), in
    f32; the identity without ``quant``."""
    if quant is None:
        return x
    if quant != "fp8":
        raise ValueError(f"unknown quantization {quant!r}")
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = _FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


class Net:
    """The weights and the forward pieces.  ``w`` maps Flax paths (without
    the ``params/`` root) to f32 tensors on one device."""

    def __init__(self, weights: Dict[str, torch.Tensor], depth: int,
                 num_classes: int, quant: Optional[str] = None):
        self.w = {k[len("params/"):] if k.startswith("params/") else k: v
                  for k, v in weights.items()}
        self.blocks = STAGE_BLOCKS[depth]
        self.num_classes = num_classes
        self.quant = quant

    # -------- layers --------

    def conv(self, x, path, stride=1, padding=0):
        k = self.w[f"{path}/kernel"]                    # HWIO
        weight = fake_quant(k.permute(3, 2, 0, 1), self.quant)
        bias = self.w.get(f"{path}/bias")
        return F.conv2d(fake_quant(x, self.quant), weight, bias,
                        stride=stride, padding=padding)

    def dense(self, x, path):
        k = fake_quant(self.w[f"{path}/kernel"], self.quant)   # [in, out]
        return fake_quant(x, self.quant) @ k + self.w[f"{path}/bias"]

    def bn(self, x, path):
        s = self.w[f"{path}/frozen_bn_scale"].view(1, -1, 1, 1)
        b = self.w[f"{path}/frozen_bn_bias"].view(1, -1, 1, 1)
        return x * s + b

    # -------- trunk --------

    def backbone(self, x):
        x = F.relu(self.bn(self.conv(x, "backbone/stem_conv", 2, 3),
                           "backbone/stem_bn"))
        x = F.max_pool2d(x, 3, 2, 1)
        out = {}
        for s, n in enumerate(self.blocks):
            for b in range(n):
                p = f"backbone/res{s + 2}_block{b}"
                stride = 2 if (s > 0 and b == 0) else 1
                short = x
                if b == 0:
                    short = self.bn(self.conv(x, f"{p}/shortcut_conv", stride),
                                    f"{p}/shortcut_bn")
                y = F.relu(self.bn(self.conv(x, f"{p}/conv1"), f"{p}/bn1"))
                y = F.relu(self.bn(self.conv(y, f"{p}/conv2", stride, 1),
                                   f"{p}/bn2"))
                y = self.bn(self.conv(y, f"{p}/conv3"), f"{p}/bn3")
                x = F.relu(y + short)
            out[f"c{s + 2}"] = x
        return out

    def fpn(self, c):
        lat = {i: self.conv(c[f"c{i}"], f"fpn/lateral_c{i}") for i in range(2, 6)}
        td = {5: lat[5]}
        for i in (4, 3, 2):
            td[i] = lat[i] + F.interpolate(td[i + 1], scale_factor=2,
                                           mode="nearest")
        p = {f"p{i}": self.conv(td[i], f"fpn/output_p{i}", 1, 1)
             for i in range(2, 6)}
        p["p6"] = p["p5"][:, :, ::2, ::2]
        return p

    def features(self, images_nhwc, pixel_mean, bgr=True):
        """[B,H,W,3] RGB 0..255 → FPN levels {p2..p6} NCHW f32."""
        x = images_nhwc.float()
        if bgr:
            x = x.flip(-1)
        x = x - torch.tensor(pixel_mean, dtype=torch.float32, device=x.device)
        return self.fpn(self.backbone(x.permute(0, 3, 1, 2).contiguous()))

    def rpn(self, feats):
        """→ (objectness [B, A_total], deltas [B, A_total, 4]) over the
        levels in order, anchors (y, x, a) row-major within a level."""
        objs, dels = [], []
        for name in LEVELS:
            h = F.relu(self.conv(feats[name], "rpn_head/rpn_conv", 1, 1))
            o = self.conv(h, "rpn_head/objectness")
            d = self.conv(h, "rpn_head/anchor_deltas")
            b = o.shape[0]
            objs.append(o.permute(0, 2, 3, 1).reshape(b, -1))
            dels.append(d.permute(0, 2, 3, 1).reshape(b, -1, 4))
        return torch.cat(objs, 1), torch.cat(dels, 1)

    def box_head(self, pooled):
        """[R,7,7,C] → (logits [R,K+1], deltas [R,K,4])."""
        r = pooled.shape[0]
        h = F.relu(self.dense(pooled.reshape(r, -1), "box_head/fc1"))
        h = F.relu(self.dense(h, "box_head/fc2"))
        return (self.dense(h, "box_head/cls_score"),
                self.dense(h, "box_head/bbox_pred").reshape(
                    r, self.num_classes, 4))

    def mask_head(self, pooled):
        """[R,14,14,C] → per-class logits [R,28,28,K]."""
        h = pooled.permute(0, 3, 1, 2)
        for i in range(1, 5):
            h = F.relu(self.conv(h, f"mask_head/mask_fcn{i}", 1, 1))
        k = self.w["mask_head/deconv/kernel"]            # Flax HWIO, flipped
        weight = fake_quant(k.flip(0, 1).permute(2, 3, 0, 1), self.quant)
        h = F.relu(F.conv_transpose2d(fake_quant(h, self.quant), weight,
                                      self.w["mask_head/deconv/bias"],
                                      stride=2))
        return self.conv(h, "mask_head/predictor").permute(0, 2, 3, 1)


# ---------------------------------------------------------------- anchors

def anchors(image_hw: Tuple[int, int], sizes, ratios, device) -> torch.Tensor:
    """All anchors of a padded image, levels p2..p6 in order, (y, x, a)
    row-major: [A_total, 4] XYXY."""
    out = []
    h, w = image_hw
    for name, (size,) in zip(LEVELS, sizes):
        s = STRIDES[name]
        cell = []
        for r in ratios:
            aw = math.sqrt(size * size / r)
            ah = r * aw
            cell.append([-aw / 2, -ah / 2, aw / 2, ah / 2])
        cell = torch.tensor(cell, dtype=torch.float32, device=device)
        ys = torch.arange(-(-h // s), dtype=torch.float32, device=device) * s
        xs = torch.arange(-(-w // s), dtype=torch.float32, device=device) * s
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        shift = torch.stack([gx, gy, gx, gy], -1).reshape(-1, 1, 4)
        out.append((shift + cell[None]).reshape(-1, 4))
    return torch.cat(out)


def level_sizes(image_hw, num_anchors: int):
    h, w = image_hw
    return [(-(-h // STRIDES[n])) * (-(-w // STRIDES[n])) * num_anchors
            for n in LEVELS]


# ---------------------------------------------------------------- boxes

def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] × [..., M, 4] → [..., N, M]; empty boxes give 0."""
    area = lambda x: ((x[..., 2] - x[..., 0]).clamp_min(0)
                      * (x[..., 3] - x[..., 1]).clamp_min(0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12),
                       torch.zeros_like(inter))


def decode(deltas, boxes, weights):
    wx, wy, ww, wh = weights
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-6)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-6)
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    clamp = math.log(1000.0 / 16)
    px = deltas[..., 0] / wx * w + cx
    py = deltas[..., 1] / wy * h + cy
    pw = torch.exp((deltas[..., 2] / ww).clamp_max(clamp)) * w
    ph = torch.exp((deltas[..., 3] / wh).clamp_max(clamp)) * h
    return torch.stack([px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2],
                       -1)


def encode(src, tgt, weights):
    wx, wy, ww, wh = weights
    sw = (src[..., 2] - src[..., 0]).clamp_min(1e-6)
    sh = (src[..., 3] - src[..., 1]).clamp_min(1e-6)
    tw = (tgt[..., 2] - tgt[..., 0]).clamp_min(1e-6)
    th = (tgt[..., 3] - tgt[..., 1]).clamp_min(1e-6)
    return torch.stack([
        wx * ((tgt[..., 0] + 0.5 * tw) - (src[..., 0] + 0.5 * sw)) / sw,
        wy * ((tgt[..., 1] + 0.5 * th) - (src[..., 1] + 0.5 * sh)) / sh,
        ww * torch.log(tw / sw), wh * torch.log(th / sh)], -1)


def clip(boxes, hw):
    h, w = hw
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)],
                       -1)


def nonempty(boxes):
    return ((boxes[..., 2] - boxes[..., 0]) > 0) & \
        ((boxes[..., 3] - boxes[..., 1]) > 0)


def sort_desc(scores):
    """Descending order, ties to the lower index."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)


def greedy_nms(boxes, scores, thresh, classes=None):
    """Greedy NMS of each row: boxes [P,N,4], scores [P,N] (NEG = absent)
    → keep [P,N] in the given order.  Highest score first (ties to the
    lower index); a box is dropped when a kept, earlier box overlaps it by
    IoU > thresh (and, with ``classes`` [P,N], has its class)."""
    order = sort_desc(scores).indices
    bs = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    alive = torch.gather(scores, 1, order) > NEG / 2
    over = iou(bs, bs) > thresh
    if classes is not None:
        cs = torch.gather(classes, 1, order)
        over &= cs[:, :, None] == cs[:, None, :]
    keep = torch.zeros_like(alive)
    for i in range(scores.shape[1]):
        ki = alive[:, i].clone()
        keep[:, i] = ki
        alive &= ~(over[:, i, :] & ki[:, None])
    return torch.zeros_like(keep).scatter_(1, order, keep)


# ---------------------------------------------------------------- proposals

def proposals(obj, deltas, anc, image_hw, level_n, pre_k, post_k, nms_thresh):
    """Detectron2's find_top_rpn_proposals for a batch: per level the top
    ``pre_k`` logits, decode, clip, drop empty, NMS; then the top
    ``post_k`` over the levels.  → {"boxes" [B,K,4], "logits" [B,K],
    "valid" [B,K], and the candidates before NMS, "cand_boxes",
    "cand_logits" (NEG where empty), "cand_level" [sum of the levels'
    top-k]}."""
    b = obj.shape[0]
    boxes_l, scores_l = [], []
    start = 0
    for n in level_n:
        o = obj[:, start:start + n]
        d = deltas[:, start:start + n]
        a = anc[start:start + n]
        start += n
        k = min(pre_k, n)
        top = sort_desc(o)
        s, idx = top.values[:, :k], top.indices[:, :k]
        bx = clip(decode(torch.gather(d, 1, idx[..., None].expand(-1, -1, 4)),
                         a[idx], (1.0, 1.0, 1.0, 1.0)), image_hw)
        boxes_l.append(bx)
        scores_l.append(torch.where(nonempty(bx), s, torch.full_like(s, NEG)))
    # the levels' NMS problems side by side, padded with absent entries
    kmax = max(s.shape[1] for s in scores_l)
    pb = torch.stack([F.pad(x, (0, 0, 0, kmax - x.shape[1]))
                      for x in boxes_l], 1).reshape(-1, kmax, 4)
    ps = torch.stack([F.pad(x, (0, kmax - x.shape[1]), value=NEG)
                      for x in scores_l], 1).reshape(-1, kmax)
    keep = greedy_nms(pb, ps, nms_thresh).reshape(b, len(level_n), kmax)
    boxes = torch.cat(boxes_l, 1)
    cand = torch.cat(scores_l, 1)
    level = torch.cat([torch.full((x.shape[1],), i, device=obj.device)
                       for i, x in enumerate(scores_l)])
    scores = torch.cat([torch.where(keep[:, i, :x.shape[1]], x,
                                    torch.full_like(x, NEG))
                        for i, x in enumerate(scores_l)], 1)
    top = sort_desc(scores)
    k = min(post_k, scores.shape[1])
    s, idx = top.values[:, :k], top.indices[:, :k]
    valid = s > NEG / 2
    bx = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    return {"boxes": torch.where(valid[..., None], bx, torch.zeros_like(bx)),
            "logits": s, "valid": valid, "cand_boxes": boxes,
            "cand_logits": cand, "cand_level": level}


# ---------------------------------------------------------------- RoIAlign

def pool_geometry(rois, level_hw, res, window, canonical=224.0, k0=4):
    """Where each roi of rois [B,R,4] pools from: FPN eq. 1 assigns the
    level, raised until the roi spans at most ``window`` − 2 cells, up to
    a virtual level 6; ``level_hw``: the five levels' (h, w).  Samples
    (2×2 a bin) clamp to the level; the roi reads one ``window``²
    neighbourhood centred on them.  → (slab [B·R] = 5·image + level − 2,
    window origins y0, x0 [B·R], bin weights wy, wx [B·R, res, window])."""
    b, r = rois.shape[:2]
    ext_h = torch.tensor([float(t[0]) for t in level_hw], device=rois.device)
    ext_w = torch.tensor([float(t[1]) for t in level_hw], device=rois.device)
    flat = rois.reshape(-1, 4).float()
    w_ = (flat[:, 2] - flat[:, 0]).clamp_min(0)
    h_ = (flat[:, 3] - flat[:, 1]).clamp_min(0)
    lvl = torch.floor(k0 + torch.log2(torch.sqrt(w_ * h_).clamp_min(1e-6)
                                      / canonical)).clamp(2, 5)
    fit = torch.ceil(torch.log2((torch.maximum(w_, h_) / (window - 2.0))
                                .clamp_min(1e-6)))
    li = (torch.maximum(lvl, fit).clamp(2, 6) - 2).long()
    stride = 4.0 * torch.pow(2.0, li.float())
    s = 2 * res
    t = (torch.arange(s, dtype=torch.float32, device=rois.device) + 0.5) / s

    def axis(lo, hi, extent):
        a = lo / stride - 0.5
        bnd = hi / stride - 0.5
        pts = a[:, None] + t[None] * (bnd - a).clamp_min(1e-6)[:, None]
        pts = torch.minimum(pts.clamp_min(0), extent[:, None] - 1)
        org = torch.floor((pts[:, 0] + pts[:, -1]) / 2 - window / 2 + 0.5)
        org = torch.minimum(org.clamp_min(0), (extent - window).clamp_min(0))
        rel = (pts - org[:, None]).clamp(0, window - 1)
        low = torch.floor(rel)
        frac = rel - low
        lo_i = low.long()
        hi_i = (lo_i + 1).clamp_max(window - 1)
        cells = torch.arange(window, device=rois.device)
        wts = ((cells == lo_i[..., None]) * (1 - frac)[..., None]
               + (cells == hi_i[..., None]) * frac[..., None])
        return org.long(), wts.reshape(-1, res, 2, window).mean(2)

    y0, wy = axis(flat[:, 1], flat[:, 3], ext_h[li])
    x0, wx = axis(flat[:, 0], flat[:, 2], ext_w[li])
    slab = torch.arange(b, device=rois.device).repeat_interleave(r) * 5 + li
    return slab, y0, x0, wy, wx


def level_maps(feats):
    """NCHW p2..p5 → the five NHWC maps pooling reads: p2..p5 and the
    virtual level (p5 edge-padded to even size, 2×2 averaged)."""
    lv = [feats[n].permute(0, 2, 3, 1) for n in ("p2", "p3", "p4", "p5")]
    p5 = lv[3]
    if p5.shape[1] % 2:
        p5 = torch.cat([p5, p5[:, -1:]], 1)
    if p5.shape[2] % 2:
        p5 = torch.cat([p5, p5[:, :, -1:]], 2)
    b, hb, wb, c = p5.shape[0], p5.shape[1] // 2, p5.shape[2] // 2, p5.shape[3]
    lv.append(p5.reshape(b, hb, 2, wb, 2, c).mean(dim=(2, 4)))
    return lv


def pool(feats, rois, res, window, chunk=1024):
    """Detectron2 RoIAlign (aligned, 2×2 samples a bin) over the FPN
    levels, placed by ``pool_geometry``.  feats: NCHW levels; rois
    [B,R,4] → [B,R,res,res,C]."""
    b, r = rois.shape[:2]
    lv = level_maps(feats)
    c = lv[0].shape[-1]
    hmax = max(max(t.shape[1] for t in lv), window)
    wmax = max(max(t.shape[2] for t in lv), window)
    canvas = torch.stack([F.pad(t, (0, 0, 0, wmax - t.shape[2], 0,
                                    hmax - t.shape[1])) for t in lv], 1)
    canvas = canvas.reshape(b * 5, hmax, wmax, c)
    slab, y0, x0, wy, wx = pool_geometry(
        rois, [t.shape[1:3] for t in lv], res, window)
    cells = torch.arange(window, device=rois.device)
    out = []
    for i in range(0, b * r, chunk):
        sl = slice(i, i + chunk)
        patch = canvas[slab[sl, None, None], (y0[sl, None] + cells)[:, :, None],
                       (x0[sl, None] + cells)[:, None, :]]
        rows = torch.einsum("nph,nhwc->npwc", wy[sl], patch)
        out.append(torch.einsum("nqw,npwc->npqc", wx[sl], rows))
    return torch.cat(out).reshape(b, r, res, res, c)


# ---------------------------------------------------------------- inference

def detections(prop_boxes, prop_valid, logits, deltas, image_hw, score_thresh,
               nms_thresh, n_cand, n_det, reg_weights):
    """Detectron2 fast_rcnn_inference: score threshold, the top ``n_cand``
    (proposal, class) candidates, per-class NMS, the top ``n_det``.
    → dict of boxes [B,D,4], scores, classes, valid, and the candidates'
    boxes [B,R,K,4] and scores [B,R,K] before selection."""
    b, r = prop_boxes.shape[:2]
    k = deltas.shape[2]
    probs = torch.softmax(logits, -1)[..., :k]                    # [B,R,K]
    boxes = clip(decode(deltas, prop_boxes[:, :, None], reg_weights), image_hw)
    fb = boxes.reshape(b, r * k, 4)
    fs = probs.reshape(b, r * k)
    fc = torch.arange(k, device=fs.device).repeat(r)
    ok = (fs > score_thresh) & prop_valid.repeat_interleave(k, 1) & nonempty(fb)
    fs = torch.where(ok, fs, torch.full_like(fs, NEG))
    top = sort_desc(fs)
    nc = min(n_cand, r * k)
    cs, ci = top.values[:, :nc], top.indices[:, :nc]
    cb = torch.gather(fb, 1, ci[..., None].expand(-1, -1, 4))
    cc = fc[ci]
    # per-class NMS: classes never suppress each other
    keep = greedy_nms(cb, cs, nms_thresh, classes=cc)
    ms = torch.where(keep, cs, torch.full_like(cs, NEG))
    top = sort_desc(ms)
    ds, di = top.values[:, :n_det], top.indices[:, :n_det]
    valid = ds > NEG / 2
    db = torch.gather(cb, 1, di[..., None].expand(-1, -1, 4))
    return {"boxes": torch.where(valid[..., None], db, torch.zeros_like(db)),
            "scores": torch.where(valid, ds, torch.zeros_like(ds)),
            "classes": torch.where(valid, torch.gather(cc, 1, di),
                                   torch.zeros_like(di)),
            "valid": valid, "cand_boxes": boxes, "cand_scores": probs}
