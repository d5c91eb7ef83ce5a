"""GeneralizedRCNN inference (port of ``uwcv_tpu/models/rcnn.py``).

``MaskRCNN.inference``: a padded NHWC image batch → per-image padded
``Detections`` and the predicted class's 28×28 mask probabilities, through
backbone, FPN, RPN, the box pooler (RoIAlign kernel), the box head, batched
NMS (NMS kernel), the mask pooler (RoIAlign kernel) and the mask head.
``forward_train`` belongs to the training slice and is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from uwcv_tpu_torch.config import ModelConfig
from uwcv_tpu_torch.models.anchors import generate_anchors
from uwcv_tpu_torch.models.fpn import FPN
from uwcv_tpu_torch.models.heads import BoxHead, MaskHead, inference_detections
from uwcv_tpu_torch.models.resnet import ResNet
from uwcv_tpu_torch.models.rpn import LEVELS, RPNHead, generate_proposals
from uwcv_tpu_torch.ops.roi_align import level_canvas, pool_level_canvas
from uwcv_tpu_torch.utils.device import mark

STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _rgb_to_model_format(images: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RGB float NHWC images → normalized model input (BGR flip when the
    weights expect BGR, then caffe-style mean/std)."""
    if cfg.input_format == "BGR":
        images = images.flip(-1)
    mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32,
                        device=images.device)
    std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=images.device)
    return (images - mean) / std


class MaskRCNN(nn.Module):
    """Mask R-CNN whose parameters and buffers are held in the compute dtype
    (``cfg.dtype``) — the Flax modules keep f32 params and cast them to the
    compute dtype at use, which rounds identically."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNet(cfg.depth)
        self.fpn = FPN(cfg.fpn_channels)
        self.rpn_head = RPNHead(cfg.num_anchors_per_cell, cfg.fpn_channels)
        self.box_head = BoxHead(
            cfg.fpn_channels * cfg.pooler_resolution_box ** 2,
            cfg.num_classes, cfg.box_fc_dim)
        if cfg.mask_on:
            self.mask_head = MaskHead(cfg.fpn_channels, cfg.num_classes)
        self._anchor_cache: Dict[tuple, Dict[str, torch.Tensor]] = {}
        # per-stage (name, CUDA event) pairs of the model and the
        # predictor's tail, recorded only while a caller sets a list here
        self.marks: Optional[list] = None

    def _anchors(self, image_size: Tuple[int, int], device
                 ) -> Dict[str, torch.Tensor]:
        key = (tuple(image_size), str(device))
        if key not in self._anchor_cache:
            per_level = generate_anchors(
                image_size, self.cfg.anchor_stride_levels,
                self.cfg.anchor_sizes, self.cfg.anchor_aspect_ratios)
            self._anchor_cache[key] = {
                n: torch.from_numpy(a).to(device)
                for n, a in zip(LEVELS, per_level)}
        return self._anchor_cache[key]

    def features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images [B,H,W,3] → FPN features {p2..p6} as NCHW tensors
        (channels-last memory on the GPU)."""
        x = _rgb_to_model_format(images.float(), self.cfg).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        x = x.to(compute_dtype(self.cfg))
        return self.fpn(self.backbone(x))

    @torch.no_grad()
    def inference(self, images: torch.Tensor):
        """images [B,H,W,3] RGB float/uint8 (padded) → (Detections with a
        leading batch dim, mask probabilities [B,D,28,28] of the predicted
        class, or None)."""
        cfg = self.cfg
        b, h, w, _ = images.shape
        feats = self.features(images)
        mark(self.marks, "trunk+fpn")
        obj, deltas = self.rpn_head(feats)
        proposals = generate_proposals(
            obj, deltas, self._anchors((h, w), images.device), (h, w), cfg)
        mark(self.marks, "rpn+proposals")

        # one level canvas serves both poolers; NHWC views of the
        # channels-last features cost no copy
        canvas, shapes = level_canvas(
            {k: feats[k].permute(0, 2, 3, 1) for k in ("p2", "p3", "p4", "p5")},
            cfg.pooler_window)
        pool = lambda rois, res: pool_level_canvas(
            canvas, shapes, rois, STRIDES, res, cfg.canonical_box_size,
            cfg.canonical_level, window=cfg.pooler_window)

        pooled = pool(proposals.boxes, cfg.pooler_resolution_box)
        k = pooled.shape[1]
        logits, box_deltas = self.box_head(
            pooled.reshape((b * k,) + pooled.shape[2:]))
        dets = inference_detections(
            proposals.boxes, proposals.valid, logits.reshape(b, k, -1),
            box_deltas.reshape(b, k, cfg.num_classes, 4), (h, w), cfg)
        mark(self.marks, "box pooler+head+detections")

        mask_probs = None
        if cfg.mask_on:
            # invalid detection slots are zero boxes (heads.py:122): they
            # pool a harmless level-2 window at the origin
            pooled_m = pool(dets.boxes, cfg.pooler_resolution_mask)
            d = pooled_m.shape[1]
            mlogits = self.mask_head(
                pooled_m.reshape((b * d,) + pooled_m.shape[2:]))
            mlogits = mlogits.reshape((b, d) + mlogits.shape[1:])
            # the one-hot class select of rcnn.py:150-152, as a gather
            sel = dets.classes[:, :, None, None, None].expand(
                -1, -1, mlogits.shape[2], mlogits.shape[3], 1)
            mask_probs = torch.sigmoid(torch.gather(mlogits, 4, sel)[..., 0])
            mark(self.marks, "mask pooler+head")
        return dets, mask_probs
