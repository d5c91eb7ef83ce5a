"""Region Proposal Network — head + static-shape proposal selection
(port of ``uwcv_tpu/models/rpn.py``).

Per level: exact top-k of the objectness logits, decode, clip, drop empty
boxes, greedy NMS; then the cross-level top-k (with the optional
``rpn_post_nms_level_floor`` quota).  All B×5 per-level NMS problems run in
one launch of the NMS kernel, padded to the largest level's size with
invalid entries.  ``rpn_approx_topk`` (a TPU approximate top-k) maps to the
exact top-k here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from uwcv_tpu_torch.config import ModelConfig
from uwcv_tpu_torch.ops.nms import NEG_INF, nms_mask_batched, topk_stable
from uwcv_tpu_torch.structures.boxes import (
    clip_boxes,
    decode_deltas,
    nonempty_boxes,
)

LEVELS = ("p2", "p3", "p4", "p5", "p6")
# added to per-level-guaranteed candidates before the cross-level top-k
# (rpn_post_nms_level_floor); far above any logit, far below |NEG_INF|
_FLOOR_BONUS = 1e6


class RPNHead(nn.Module):
    """Shared conv head: NCHW features → (objectness [B,H,W,A],
    deltas [B,H,W,A*4]) in f32 and NHWC, as the Flax head returns them.

    The weights are cast to the features' dtype at use, as the Flax convs
    cast their f32 params: a trainer's f32 copy of this head, which runs
    once per level, then adds the five levels' gradients in f32.  With
    weights already in the features' dtype (the predictor) the cast is a
    no-op."""

    def __init__(self, num_anchors: int, channels: int = 256):
        super().__init__()
        self.rpn_conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.objectness = nn.Conv2d(channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: Dict[str, torch.Tensor]):
        dt = feats[LEVELS[0]].dtype
        conv = lambda m, x: F.conv2d(x, m.weight.to(dt), m.bias.to(dt),
                                     padding=m.padding)
        obj, deltas = {}, {}
        for name in LEVELS:
            h = F.relu(conv(self.rpn_conv, feats[name]))
            # head outputs back to f32 (rpn.py:63-64)
            obj[name] = conv(self.objectness, h).permute(0, 2, 3, 1).float()
            deltas[name] = conv(self.anchor_deltas,
                                h).permute(0, 2, 3, 1).float()
        return obj, deltas


class Proposals(NamedTuple):
    boxes: torch.Tensor   # [B, K, 4]
    scores: torch.Tensor  # [B, K] objectness logits (sorted desc)
    valid: torch.Tensor   # [B, K] bool


@torch.no_grad()
def generate_proposals(obj: Dict[str, torch.Tensor],
                       deltas: Dict[str, torch.Tensor],
                       anchors: Dict[str, torch.Tensor],
                       image_size: Tuple[int, int],
                       cfg: ModelConfig, training: bool = False) -> Proposals:
    """Proposal selection for a batch.

    obj[level]: [B,H,W,A] logits; deltas[level]: [B,H,W,A*4];
    anchors[level]: [H*W*A, 4] for the padded image size.  ``training``
    takes the train top-k and no level floor (rpn.py:87-102,141).  The
    selection carries no gradient (Detectron2's find_top_rpn_proposals is
    under no_grad; the NMS kernel has no backward)."""
    pre_k = (cfg.rpn_pre_nms_topk_train if training
             else cfg.rpn_pre_nms_topk_test)
    post_k = (cfg.rpn_post_nms_topk_train if training
              else cfg.rpn_post_nms_topk_test)
    b = obj[LEVELS[0]].shape[0]
    lv_boxes, lv_scores = [], []
    for name in LEVELS:
        logits = obj[name].reshape(b, -1)                    # [B,HWA]
        d = deltas[name].reshape(b, -1, 4)                   # [B,HWA,4]
        k = min(pre_k, logits.shape[1])
        # stable descending selection (rpn.py:117; see topk_stable)
        top_scores, idx = topk_stable(logits, k)
        sel_deltas = torch.gather(d, 1, idx[..., None].expand(-1, -1, 4))
        boxes = decode_deltas(sel_deltas, anchors[name][idx],
                              cfg.rpn_bbox_reg_weights)
        boxes = clip_boxes(boxes, image_size)
        ok = nonempty_boxes(boxes, 0.0)
        lv_boxes.append(boxes)
        lv_scores.append(torch.where(ok, top_scores,
                                     torch.full_like(top_scores, NEG_INF)))

    # per-level NMS (rpn.py:135): one launch for all B×5 problems, each
    # padded to the largest level with invalid (NEG_INF) entries
    kmax = max(s.shape[1] for s in lv_scores)
    pad_b = torch.stack([F.pad(x, (0, 0, 0, kmax - x.shape[1]))
                         for x in lv_boxes], dim=1)
    pad_s = torch.stack([F.pad(s, (0, kmax - s.shape[1]), value=NEG_INF)
                         for s in lv_scores], dim=1)
    keep = nms_mask_batched(pad_b.reshape(b * len(LEVELS), kmax, 4),
                            pad_s.reshape(b * len(LEVELS), kmax),
                            cfg.rpn_nms_thresh).reshape(b, len(LEVELS), kmax)
    cand_scores = [torch.where(keep[:, i, :s.shape[1]], s,
                               torch.full_like(s, NEG_INF))
                   for i, s in enumerate(lv_scores)]

    boxes = torch.cat(lv_boxes, dim=1)                        # [B,sum_k,4]
    masked = torch.cat(cand_scores, dim=1)
    floor = 0 if training else cfg.rpn_post_nms_level_floor
    if floor > 0:
        # guarantee each level's top-`floor` survivors a slot, then report
        # the original scores
        bonused = []
        for s in cand_scores:
            m = min(floor, s.shape[1])
            thr = topk_stable(s, m)[0][:, -1:]               # rpn.py:154
            guarantee = (s >= thr) & (s > NEG_INF / 2)
            bonused.append(torch.where(guarantee, s + _FLOOR_BONUS, s))
        sel_scores = torch.cat(bonused, dim=1)
    else:
        sel_scores = masked
    top_sel, idx = topk_stable(sel_scores, min(post_k, sel_scores.shape[1]))
    top_scores = torch.gather(masked, 1, idx) if floor > 0 else top_sel
    valid = top_scores > NEG_INF / 2                          # rpn.py:160
    out_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    out_boxes = torch.where(valid[..., None], out_boxes,
                            torch.zeros_like(out_boxes))
    return Proposals(out_boxes, top_scores, valid)
