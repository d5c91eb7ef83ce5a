"""GeneralizedRCNN inference (port of ``uwcv_tpu/models/rcnn.py``).

``MaskRCNN.inference``: a padded NHWC image batch → per-image padded
``Detections`` and the predicted class's 28×28 mask probabilities, through
backbone, FPN, RPN, the box pooler (RoIAlign kernel), the box head, batched
NMS (NMS kernel), the mask pooler (RoIAlign kernel) and the mask head.

``MaskRCNN.forward_train``: the joint RPN + ROI losses of a training batch,
with in-graph label assignment and balanced sampling; the poolers go
through the RoIAlign kernel and its backward, the RPN's proposal selection
through the NMS kernel.  Its random draws come from a ``torch.Generator``
through ``sampler_draws``, or from the caller.  In a data-parallel run
(``world``, ``parallel/mesh.py::DataAxis``) each rank computes its share of
the global batch's loss; the shares add up to it.

With a model axis (``model_axis``: ``parallel/mesh.py::ModelAxis`` in a
process group, ``parallel/spatial.py::DeviceRow`` in one process) the
image's height is split over the axis (``mesh.height_shards``): the trunk
runs on this process's row shard(s) with halo rows exchanged, and each
FPN level is gathered whole (``spatial.gather_rows``) before the RPN, the
anchors (at the full image size), the poolers and the heads, which run
unchanged on the gathered levels.
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
from uwcv_tpu_torch.ops.mask_paste import crop_and_resize_masks
from uwcv_tpu_torch.ops.matcher import (
    match_boxes,
    sampler_uniforms,
    subsample_labels,
)
from uwcv_tpu_torch.ops.roi_align import level_canvas, pool_level_canvas
from uwcv_tpu_torch.parallel.mesh import height_shards
from uwcv_tpu_torch.parallel.spatial import (
    gather_rows,
    level_heights,
    shard_rows,
)
from uwcv_tpu_torch.structures.boxes import encode_deltas
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


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid BCE, max(x,0) - x·z + log1p(exp(-|x|))
    (``optax_sigmoid_ce``, rcnn.py:345)."""
    return (logits.clamp_min(0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross-entropy (rcnn.py:351)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels[:, None])[:, 0]


def sampler_draws(cfg: ModelConfig, b: int, n_anchors: int, n_cands: int,
                  generator: Optional[torch.Generator], device
                  ) -> Dict[str, torch.Tensor]:
    """The uniforms ``forward_train``'s two samplers consume: per image,
    the RPN's over its anchors and the ROI head's over its candidates
    (proposals, then gt).  The positive draws are floored for the weighted
    draw where the config sets class weights."""
    d = {}
    d["rpn_pos"], d["rpn_neg"] = sampler_uniforms(
        (b, n_anchors), bool(cfg.rpn_fg_class_weights), generator, device)
    d["roi_pos"], d["roi_neg"] = sampler_uniforms(
        (b, n_cands), bool(cfg.roi_fg_class_weights), generator, device)
    return d


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] gathered along dim 1 by idx [B, K] → [B, K, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


class MaskRCNN(nn.Module):
    """Mask R-CNN.  The predictor holds its parameters and buffers in the
    compute dtype (``cfg.dtype``) — the Flax modules keep f32 params and
    cast them to the compute dtype at use, which rounds identically; the
    trainer keeps f32 masters and a compute-dtype working copy."""

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

    def _model_input(self, images: torch.Tensor) -> torch.Tensor:
        """images [B,h,W,3] RGB → the normalized NCHW trunk input in the
        compute dtype (channels-last memory on the GPU)."""
        x = _rgb_to_model_format(images.float(), self.cfg).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        return x.to(compute_dtype(self.cfg))

    def features(self, images: torch.Tensor, model_axis=None
                 ) -> Dict[str, torch.Tensor]:
        """images [B,H,W,3] → FPN features {p2..p6} as NCHW tensors
        (channels-last memory on the GPU).  With ``model_axis`` the trunk
        runs on this process's rows of the image and the levels are
        gathered whole (on the row's first device in one process)."""
        if model_axis is None:
            return self.fpn(self.backbone(self._model_input(images)))
        rows = height_shards(images.shape[1], model_axis.size)
        x = shard_rows(images, model_axis, rows, self._model_input)
        feats = self.fpn(self.backbone(x, model_axis), model_axis)
        return {k: gather_rows(v, model_axis, level_heights(rows, STRIDES[k]))
                for k, v in feats.items()}

    @torch.no_grad()
    def inference(self, images: torch.Tensor, model_axis=None):
        """images [B,H,W,3] RGB float/uint8 (padded) → (Detections with a
        leading batch dim, mask probabilities [B,D,28,28] of the predicted
        class, or None).  ``model_axis``: the trunk on row shards
        (``features``)."""
        cfg = self.cfg
        b, h, w, _ = images.shape
        feats = self.features(images, model_axis)
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

    def forward_train(self, images: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_classes: torch.Tensor, gt_masks: torch.Tensor,
                      gt_valid: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Dict[str, torch.Tensor]] = None,
                      world=None, model_axis=None
                      ) -> Dict[str, torch.Tensor]:
        """Training forward → loss dict (port of rcnn.py:161-325).

        images [B,H,W,3] RGB float; gt_boxes [B,N,4]; gt_classes [B,N];
        gt_masks [B,N,H,W] bool; gt_valid [B,N].  Losses follow Detectron2:
        rpn_cls (BCE), rpn_loc (L1), cls (softmax CE incl. background),
        box_reg (L1, fg only), mask (BCE on the matched class's channel).
        ``draws`` (``sampler_draws``) are the samplers' uniforms; without
        them they are drawn from ``generator``.

        ``world`` (``parallel/mesh.py::DataAxis``): this batch is rank
        ``world.rank``'s rows of a global batch of ``world.size`` such
        batches.  The generator then draws for the global batch and the
        rank takes its rows, and every loss is the rank's numerator over
        the global denominator (the batch, its rois, the summed roi
        weights, all-reduced and detached): the ranks' losses add up to
        the global batch's, and so do their gradients.

        ``model_axis`` (``parallel/mesh.py::ModelAxis``): the batch's
        whole images; this rank runs the trunk on its rows of them, and
        every rank of the axis computes the same losses on the gathered
        levels.  The trunk's parameter gradients are then this rank's
        share; every other gradient is the whole one."""
        c = self.cfg
        b, h, w, _ = images.shape
        dev = images.device
        feats = self.features(images, model_axis)
        obj, deltas = self.rpn_head(feats)
        anchors = self._anchors((h, w), dev)
        anchors_cat = torch.cat([anchors[n] for n in LEVELS])      # [A,4]
        proposals = generate_proposals(obj, deltas, anchors, (h, w), c,
                                       training=True)
        obj_cat = torch.cat([obj[n].reshape(b, -1) for n in LEVELS], 1)
        deltas_cat = torch.cat([deltas[n].reshape(b, -1, 4) for n in LEVELS],
                               1)
        cand_boxes = torch.cat([proposals.boxes, gt_boxes.float()], 1)
        cand_valid = torch.cat([proposals.valid, gt_valid], 1)
        ranks, rank = (world.size, world.rank) if world else (1, 0)
        if draws is None:
            draws = sampler_draws(c, b * ranks, anchors_cat.shape[0],
                                  cand_boxes.shape[1], generator, dev)
            draws = {k: v[rank * b:(rank + 1) * b] for k, v in draws.items()}
        classes = gt_classes.long()
        wtab = lambda ws: torch.tensor(ws, dtype=torch.float32, device=dev)
        class_of = lambda idx: _take(classes, idx).clamp(0, c.num_classes - 1)

        # --- RPN losses (per image, then the batch mean) ---
        m = match_boxes(anchors_cat, gt_boxes, gt_valid, c.rpn_fg_iou_thresh,
                        c.rpn_bg_iou_thresh, allow_low_quality=True)
        rpn_w = (wtab(c.rpn_fg_class_weights)[class_of(m.matched_idx)]
                 if c.rpn_fg_class_weights else None)
        idx, is_pos = subsample_labels(
            m.labels, c.rpn_batch_size_per_image, c.rpn_positive_fraction,
            draws["rpn_pos"], draws["rpn_neg"], fg_weights=rpn_w)
        lbl = is_pos.float()
        rpn_cls = sigmoid_ce(_take(obj_cat, idx), lbl).mean(dim=1)
        rpn_targets = encode_deltas(
            anchors_cat[idx], _take(gt_boxes, _take(m.matched_idx, idx)),
            c.rpn_bbox_reg_weights)
        rpn_loc = ((_take(deltas_cat, idx) - rpn_targets).abs().sum(-1)
                   * lbl).sum(dim=1) / max(c.rpn_batch_size_per_image, 1)

        # --- ROI sampling: proposals + gt boxes as candidates ---
        mm = match_boxes(cand_boxes, gt_boxes, gt_valid, c.roi_fg_iou_thresh,
                         c.roi_fg_iou_thresh)
        cand_labels = torch.where(cand_valid, mm.labels,
                                  torch.full_like(mm.labels, -1))
        roi_cw = (wtab(c.roi_fg_class_weights)[class_of(mm.matched_idx)]
                  if c.roi_fg_class_weights else None)
        sidx, s_pos = subsample_labels(
            cand_labels, c.roi_batch_size_per_image, c.roi_positive_fraction,
            draws["roi_pos"], draws["roi_neg"], fg_weights=roi_cw)
        roi_boxes = _take(cand_boxes, sidx)                       # [B,R,4]
        roi_gt_idx = _take(mm.matched_idx, sidx)
        cls_target = torch.where(s_pos, _take(classes, roi_gt_idx),
                                 torch.full_like(roi_gt_idx, c.num_classes))
        reg_targets = encode_deltas(roi_boxes, _take(gt_boxes, roi_gt_idx),
                                    c.roi_bbox_reg_weights)
        r = roi_boxes.shape[1]
        n = b * r
        tgt = cls_target.reshape(n)
        fg = s_pos.reshape(n).float()
        # per-roi weight by target class, background 1.0 (torch
        # CrossEntropyLoss(weight=w) semantics)
        roi_w = (wtab(tuple(c.class_loss_weights) + (1.0,))[tgt]
                 if c.class_loss_weights
                 else torch.ones((n,), dtype=torch.float32, device=dev))
        # the batch-wide denominators: summed roi weights (cls) and summed
        # fg roi weights (mask), over every rank's batch
        dens = torch.stack([roi_w.sum(), (fg * roi_w).sum()]).detach()
        if world:
            world.all_reduce_sum(dens)
        b_all, n_all = b * ranks, n * ranks

        # --- box head ---
        canvas, shapes = level_canvas(
            {k: feats[k].permute(0, 2, 3, 1) for k in ("p2", "p3", "p4", "p5")},
            c.pooler_window)
        pool = lambda res: pool_level_canvas(
            canvas, shapes, roi_boxes, STRIDES, res, c.canonical_box_size,
            c.canonical_level, window=c.pooler_window)
        pooled = pool(c.pooler_resolution_box)
        logits, box_deltas = self.box_head(pooled.reshape((n,) + pooled.shape[2:]))
        if c.class_loss_weights:
            # sum(w·ce) / sum(w)
            cls_loss = (softmax_ce(logits, tgt) * roi_w).sum() \
                / dens[0].clamp_min(1.0)
        else:
            cls_loss = softmax_ce(logits, tgt).sum() / n_all
        fg_cls = tgt.clamp(0, c.num_classes - 1)
        per_roi_deltas = box_deltas[torch.arange(n, device=dev), fg_cls]
        box_loss = ((per_roi_deltas - reg_targets.reshape(n, 4)).abs().sum(-1)
                    * fg * roi_w).sum() / max(n_all, 1)
        losses = {"rpn_cls": rpn_cls.sum() / b_all,
                  "rpn_loc": rpn_loc.sum() / b_all,
                  "cls": cls_loss, "box_reg": box_loss}

        # --- mask head ---
        if c.mask_on:
            mres = c.mask_head_resolution
            gt_roi = crop_and_resize_masks(
                gt_masks.reshape((-1,) + gt_masks.shape[2:]),
                roi_boxes.reshape(n, 4), mres,
                index=(torch.arange(b, device=dev)[:, None]
                       * gt_masks.shape[1] + roi_gt_idx).reshape(n))
            mpooled = pool(c.pooler_resolution_mask)
            mlogits = self.mask_head(mpooled.reshape((n,) + mpooled.shape[2:]))
            per_class = torch.gather(
                mlogits, 3, fg_cls[:, None, None, None].expand(
                    -1, mres, mres, 1))[..., 0]
            mask_ce = sigmoid_ce(per_class, (gt_roi > 0.5).float())
            # Detectron2's mask_rcnn_loss: the mean over all fg rois of the
            # batch jointly, weighted per roi by target class
            losses["mask"] = (mask_ce.mean(dim=(1, 2)) * fg * roi_w).sum() \
                / dens[1].clamp_min(1.0)
        return losses
