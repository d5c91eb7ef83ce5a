"""ROI heads: box head + predictors, mask head, and test-time inference
(port of ``uwcv_tpu/models/heads.py``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from uwcv_tpu_torch.config import ModelConfig
from uwcv_tpu_torch.ops.nms import NEG_INF, batched_class_nms_mask, topk_stable
from uwcv_tpu_torch.structures.boxes import (
    Detections,
    clip_boxes,
    decode_deltas,
    nonempty_boxes,
)


class BoxHead(nn.Module):
    """[R,7,7,C] pooled NHWC features → (class logits [R,C+1] f32,
    deltas [R,C,4] f32).  ``fc1`` takes the HWC-flattened pool, as the Flax
    head does."""

    def __init__(self, in_features: int, num_classes: int, fc_dim: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.fc1 = nn.Linear(in_features, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)
        self.cls_score = nn.Linear(fc_dim, num_classes + 1)
        self.bbox_pred = nn.Linear(fc_dim, num_classes * 4)

    def forward(self, x: torch.Tensor):
        r = x.shape[0]
        h = x.reshape(r, -1).to(self.fc1.weight.dtype)
        h = F.relu(self.fc1(h))
        h = F.relu(self.fc2(h))
        # head outputs back to f32 (heads.py:42-45)
        logits = self.cls_score(h).float()
        deltas = self.bbox_pred(h).float()
        return logits, deltas.reshape(r, self.num_classes, 4)


class MaskHead(nn.Module):
    """[R,14,14,C] pooled NHWC features → per-class mask logits
    [R,28,28,num_classes] f32."""

    def __init__(self, in_channels: int, num_classes: int,
                 conv_dim: int = 256, num_convs: int = 4):
        super().__init__()
        self.num_convs = num_convs
        c = in_channels
        for i in range(num_convs):
            setattr(self, f"mask_fcn{i + 1}", nn.Conv2d(c, conv_dim, 3,
                                                        padding=1))
            c = conv_dim
        self.deconv = nn.ConvTranspose2d(conv_dim, conv_dim, 2, stride=2)
        self.predictor = nn.Conv2d(conv_dim, num_classes, 1)

    def forward(self, x: torch.Tensor):
        h = x.permute(0, 3, 1, 2).to(self.predictor.weight.dtype)
        for i in range(self.num_convs):
            h = F.relu(getattr(self, f"mask_fcn{i + 1}")(h))
        h = F.relu(self.deconv(h))
        # back to f32 (heads.py:67), NHWC
        return self.predictor(h).permute(0, 2, 3, 1).float()


def inference_detections(proposal_boxes: torch.Tensor,
                         proposal_valid: torch.Tensor,
                         class_logits: torch.Tensor, deltas: torch.Tensor,
                         image_size: Tuple[int, int],
                         cfg: ModelConfig) -> Detections:
    """Detectron2 fast_rcnn_inference for a batch, static shapes.

    proposal_boxes [B,R,4]; class_logits [B,R,C+1]; deltas [B,R,C,4].
    Candidates = R×C (proposal × fg class): score threshold, a stable top-k
    cap at ``nms_candidates_test``, class-offset NMS (one kernel launch for
    the batch), then the ``detections_per_image`` top-k."""
    b, r = proposal_boxes.shape[:2]
    c = cfg.num_classes
    probs = torch.softmax(class_logits, dim=-1)[..., :c]          # [B,R,C]
    boxes_pc = decode_deltas(deltas, proposal_boxes[:, :, None, :],
                             cfg.roi_bbox_reg_weights)
    boxes_pc = clip_boxes(boxes_pc, image_size)                   # [B,R,C,4]

    flat_boxes = boxes_pc.reshape(b, r * c, 4)
    flat_scores = probs.reshape(b, r * c)
    flat_classes = torch.arange(c, device=probs.device).repeat(r)  # [R·C]
    ok = flat_scores > cfg.roi_score_thresh_test
    ok &= proposal_valid.repeat_interleave(c, dim=1)
    ok &= nonempty_boxes(flat_boxes, 0.0)
    flat_scores = torch.where(ok, flat_scores,
                              torch.full_like(flat_scores, NEG_INF))

    n_cand = min(cfg.nms_candidates_test, r * c)
    cand_scores, cand_idx = topk_stable(flat_scores, n_cand)   # heads.py:112
    cand_boxes = torch.gather(flat_boxes, 1,
                              cand_idx[..., None].expand(-1, -1, 4))
    cand_classes = flat_classes[cand_idx]

    keep = batched_class_nms_mask(cand_boxes, cand_scores, cand_classes,
                                  cfg.roi_nms_thresh_test)     # heads.py:116
    masked = torch.where(keep, cand_scores,
                         torch.full_like(cand_scores, NEG_INF))
    top_scores, idx = topk_stable(masked, cfg.detections_per_image)  # :119
    valid = top_scores > NEG_INF / 2
    boxes = torch.gather(cand_boxes, 1, idx[..., None].expand(-1, -1, 4))
    return Detections(
        boxes=torch.where(valid[..., None], boxes, torch.zeros_like(boxes)),
        scores=torch.where(valid, top_scores, torch.zeros_like(top_scores)),
        classes=torch.where(valid, torch.gather(cand_classes, 1, idx),
                            torch.zeros_like(idx)),
        valid=valid,
    )
