"""Predictor: folder/batch inference on one GPU (port of
``uwcv_tpu/engine/predictor.py``).

The host decodes, resizes (antialiased bilinear, no PIL) and pads a batch;
the device runs the optional resample, Mask R-CNN inference, the head-
resolution mask cleanup, the full-canvas paste, overlap claim, min-pixel
filter and bit-pack; the host pulls the valid prefix and builds padded
``Instances``.  Not ported yet: ``mesh`` (multi-GPU) and ``from_exported``.
"""

from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from uwcv_tpu_torch.config import Config, model_fields_by_scope
from uwcv_tpu_torch.data.augment import pack_bitmasks
from uwcv_tpu_torch.data.loader import load_image_rgb
from uwcv_tpu_torch.models.rcnn import MaskRCNN, compute_dtype
from uwcv_tpu_torch.ops.mask_paste import paste_masks, paste_select_pack
from uwcv_tpu_torch.ops.morphology import clean_head_masks, remove_overlaps
from uwcv_tpu_torch.structures.instances import Instances
from uwcv_tpu_torch.utils.device import (
    HostStages,
    host_stage,
    mark,
    resolve_device,
)
from uwcv_tpu_torch.utils.image import (
    bucket_up,
    device_resize,
    host_resize,
    pad_to_canvas,
    shortest_edge_scale,
)
from uwcv_tpu_torch.engine.checkpoint import load_weights
from uwcv_tpu_torch.weights import params_from_flax


class PulledBatch(NamedTuple):
    """A batch's results on their way to the host: host tensors (pinned on
    a GPU) that ``ready`` (a CUDA event, None on the CPU) completes."""
    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor              # dets.valid & keep
    masks: Optional[torch.Tensor]    # packed [B, D, H, W/8] uint8
    scales: list
    out_sizes: list
    ready: Optional[torch.cuda.Event]


class Predictor:
    """predictor = Predictor(cfg, flat_flax_params); insts =
    predictor.predict_batch(images_rgb)

    ``params`` is a flat ``/``-joined Flax param dict (``weights.load_npz``)
    or None to keep the model's own initialisation.  ``device`` defaults to
    ``cuda`` and raises when there is none; tests pass ``device="cpu"``."""

    def __init__(self, cfg: Config, params=None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        bkt = cfg.input.canvas_bucket
        if bkt <= 0 or bkt % cfg.input.size_divisibility:
            raise ValueError(
                f"input.canvas_bucket must be a positive multiple of "
                f"size_divisibility={cfg.input.size_divisibility}, got {bkt}")
        # host seconds per stage, collected only when a caller sets it
        self.stages: Optional[HostStages] = None
        self.device = resolve_device(device)
        self.model = MaskRCNN(cfg.model)
        self.model.to(device=self.device,
                      dtype=compute_dtype(cfg.model)).eval()
        if params is not None:
            self.set_params(params)
        self.pad_h, self.pad_w = cfg.input.pad_size_test

    def set_params(self, params) -> None:
        """Swap flat Flax params into the existing model in place: it keeps
        its dtype and device, and is not rebuilt.  HPO reuses one eval
        predictor across trials this way."""
        self.model.load_state_dict(params_from_flax(params), strict=True)

    # -------- device program --------

    @torch.no_grad()
    def _run(self, images: torch.Tensor, scales: np.ndarray,
             out_sizes: torch.Tensor, model_canvas=None):
        """images [B,Hc,Wc,3|1] uint8 host-padded (on the device); scales
        [B] host floats; out_sizes [B,2] (true resized h, w) → (Detections,
        packed masks [B,D,H,W/8] uint8 | None, keep [B,D] bool)."""
        cfg = self.cfg
        mch, mcw = model_canvas or (self.pad_h, self.pad_w)
        if images.shape[-1] == 1:
            # grayscale transfer: one channel shipped, re-broadcast to RGB
            images = images.expand(images.shape[:-1] + (3,))
        dev = images.device
        yy = torch.arange(mch, device=dev)[None, :, None]
        xx = torch.arange(mcw, device=dev)[None, None, :]
        inside = ((yy < out_sizes[:, 0][:, None, None])
                  & (xx < out_sizes[:, 1][:, None, None]))      # [B,H,W]
        if images.shape[1:3] == (mch, mcw) and bool(np.all(scales == 1.0)):
            # unit-scale fast path (predictor.py:197-209): the host already
            # resampled every image, the device resample is an identity
            resized = images.float() * inside[..., None]
        else:
            scale_t = torch.as_tensor(scales, dtype=torch.float32)
            resized = torch.stack([
                device_resize(images[i], scale_t[i], mch, mcw)
                for i in range(images.shape[0])]) * inside[..., None]

        dets, mask_probs = self.model.inference(resized)
        if mask_probs is None:   # box-only config (mask_on=False)
            return dets, None, dets.valid

        pp = cfg.postprocess
        cleaned, single = clean_head_masks(
            mask_probs, 0.5, do_fill_holes=pp.fill_holes,
            do_smooth=pp.smooth, drop_fragmented=pp.drop_fragmented)
        keep = dets.valid & single & (dets.scores >= pp.score_floor)
        paste_dtype = getattr(torch, pp.paste_dtype)
        if pp.paste_chunk > 0:
            # the fused tail: one [B, chunk, H, W] transient at a time;
            # bit-identical to the chain below
            packed, keep = paste_select_pack(
                cleaned.float(), dets.boxes, keep, dets.scores, (mch, mcw),
                min_pixels=pp.min_mask_pixels,
                do_remove_overlaps=pp.remove_overlaps, chunk=pp.paste_chunk,
                dtype=paste_dtype, extent=inside)
            mark(self.model.marks, "mask tail")
            return dets, packed, keep
        masks = paste_masks(cleaned.float(), dets.boxes, (mch, mcw),
                            dtype=paste_dtype)
        # pasted pixels beyond the image's true extent are not content
        masks &= inside[:, None]
        if pp.remove_overlaps:
            scores = torch.where(keep, dets.scores,
                                 torch.full_like(dets.scores, -np.inf))
            order = torch.sort(-scores, dim=-1, stable=True).indices
            masks = remove_overlaps(masks, order)
        keep &= masks.sum(dim=(2, 3)) >= pp.min_mask_pixels
        packed = pack_bitmasks(masks & keep[..., None, None])
        mark(self.model.marks, "mask tail")
        return dets, packed, keep

    # -------- host API --------

    def _prepare(self, image_rgb: np.ndarray):
        """Returns (ship_image, device_scale, unmap_scale, out_size)."""
        h, w = image_rgb.shape[:2]
        scale = shortest_edge_scale(
            h, w, self.cfg.input.test_short_edge, self.cfg.input.test_max_size)
        # ensure the scaled image fits the static pad; shrink further if not
        scale = min(scale, self.pad_h / h, self.pad_w / w)
        out_h = min(int(round(h * scale)), self.pad_h)
        out_w = min(int(round(w * scale)), self.pad_w)
        if self.cfg.input.host_resize and scale < 1.0:
            # downscales resize on the host (fewer bytes to the device)
            return (host_resize(image_rgb, out_h, out_w), 1.0, scale,
                    (out_h, out_w))
        return image_rgb, scale, scale, (out_h, out_w)

    def stage_batch(self, images_rgb: Sequence[np.ndarray]):
        """Host-prep a batch and place it on the device → ``(device_ops,
        unmap)``; ``device_ops`` feeds ``_run``, ``unmap = (unmap_scales,
        out_sizes)`` maps results back to original-image coordinates."""
        prepped = [self._prepare(im) for im in images_rgb]
        raw_h = max(p[0].shape[0] for p in prepped)
        raw_w = max(p[0].shape[1] for p in prepped)
        bkt = self.cfg.input.canvas_bucket
        ch, cw = bucket_up(raw_h, bkt), bucket_up(raw_w, bkt)
        # clamp to the pad canvas whenever the content already fits it, so
        # host-resized batches keep the unit-scale fast path
        if raw_h <= self.pad_h:
            ch = min(ch, self.pad_h)
        if raw_w <= self.pad_w:
            cw = min(cw, self.pad_w)
        batch = np.stack([pad_to_canvas(p[0], ch, cw) for p in prepped])
        if (self.cfg.input.grayscale_transfer and batch.shape[-1] == 3
                and all(np.array_equal(p[0][..., 0], p[0][..., 1])
                        and np.array_equal(p[0][..., 0], p[0][..., 2])
                        for p in prepped)):
            batch = batch[..., :1]
        scales = np.asarray([p[1] for p in prepped], np.float32)
        out_sizes = np.asarray([p[3] for p in prepped], np.int32)
        # model canvas = bucketed max resized extent, never past the pad
        mch = min(bucket_up(int(out_sizes[:, 0].max()), bkt), self.pad_h)
        mcw = min(bucket_up(int(out_sizes[:, 1].max()), bkt), self.pad_w)
        pin = self.device.type == "cuda"
        put = lambda a: torch.from_numpy(a).pin_memory().to(
            self.device, non_blocking=True) if pin else torch.from_numpy(a)
        return ((put(batch), scales, put(out_sizes), (mch, mcw)),
                ([p[2] for p in prepped], [p[3] for p in prepped]))

    def predict_batch_device(self, images_rgb: Sequence[np.ndarray],
                             block: bool = True):
        """Run a batch, returning device-resident results: (Detections,
        packed masks | None, keep, unmap scales, out sizes).  Waits for the
        device to finish unless ``block=False``, which lets a caller
        pipeline batches (``start_pull`` then ``to_instances``)."""
        with host_stage(self.stages, "stage_batch"):
            device_ops, unmap = self.stage_batch(images_rgb)
        with host_stage(self.stages, "_run"):
            dets, masks_packed, keep = self._run(*device_ops)
        if block and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return dets, masks_packed, keep, unmap[0], unmap[1]

    def predict_batch(self, images_rgb: Sequence[np.ndarray]) -> List[Instances]:
        """Run a batch and pull results to host Instances; images may have
        arbitrary (per-image) sizes."""
        return self.to_instances(self.predict_batch_device(images_rgb,
                                                           block=False))

    def start_pull(self, device_out) -> PulledBatch:
        """Enqueue the device → host copy of a ``predict_batch_device``
        result into pinned host buffers and record an event for it.

        A caller that enqueues batch i−1's copy before it dispatches batch
        i waits, in ``to_instances``, for batch i−1 alone: a copy enqueued
        after batch i would wait for all of batch i on the one stream.  The
        whole packed stack is copied (the valid prefix is not known without
        a sync); ``to_instances`` unpacks only the valid prefix."""
        dets, masks_packed, keep, scales, out_sizes = device_out
        fields = [dets.boxes, dets.scores, dets.classes, dets.valid & keep,
                  masks_packed]
        ready = None
        if self.device.type == "cuda":
            fields = [None if t is None else torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True).copy_(
                    t, non_blocking=True) for t in fields]
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        mark(self.model.marks, "d2h")
        return PulledBatch(*fields, scales, out_sizes, ready)

    def to_instances(self, out) -> List[Instances]:
        """Host Instances of a ``predict_batch_device`` result or of a
        ``start_pull`` of one (then waiting for that copy only); of the
        masks only the valid-slot prefix is unpacked (detection slots are
        score-sorted)."""
        if not isinstance(out, PulledBatch):
            out = self.start_pull(out)
        if out.ready is not None:
            with host_stage(self.stages, "d2h wait"):
                out.ready.synchronize()
        with host_stage(self.stages, "to_instances"):
            return self._instances(out)

    def _instances(self, out: PulledBatch) -> List[Instances]:
        boxes_np = out.boxes.numpy()
        scores_np = out.scores.numpy()
        classes_np = out.classes.numpy().astype(np.int32)
        valid_np = out.valid.numpy()
        masks_np = None
        if out.masks is not None:
            nz = np.nonzero(valid_np)
            max_k = int(nz[1].max()) + 1 if len(nz[1]) else 1
            masks_np = out.masks[:, :max_k].numpy()
        results = []
        for i, (scale, (oh, ow)) in enumerate(zip(out.scales,
                                                  out.out_sizes)):
            masks_i = None
            if masks_np is not None:
                prefix = np.unpackbits(masks_np[i], axis=-1).astype(bool)
                if prefix.shape[0] < boxes_np.shape[1]:
                    masks_i = np.zeros(
                        (boxes_np.shape[1],) + prefix.shape[1:], bool)
                    masks_i[:prefix.shape[0]] = prefix
                else:
                    masks_i = prefix
            # clip to the true content extent in the model frame, then unmap
            boxes_i = boxes_np[i].copy()
            boxes_i[:, 0::2] = boxes_i[:, 0::2].clip(0.0, float(ow))
            boxes_i[:, 1::2] = boxes_i[:, 1::2].clip(0.0, float(oh))
            boxes_i /= scale
            results.append(Instances(
                boxes=boxes_i, scores=scores_np[i], classes=classes_np[i],
                valid=valid_np[i], masks=masks_i, image_size=(oh, ow)))
        return results

    def __call__(self, image) -> Instances:
        """Single image: an RGB ndarray or an image file's path."""
        if isinstance(image, (str, os.PathLike)):
            image = load_image_rgb(os.fspath(image))
        return self.predict_batch([image])[0]


def load_predictor(cfg: Config, weights: Optional[str] = None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Predictor:
    """Build a predictor from ``weights`` or ``cfg.weights``: a
    ``save_params_npz`` checkpoint or a torch ``.pth`` state dict mapped
    onto the fresh model's params (``engine/checkpoint.py::load_weights``).
    A Trainer-written ``config.json`` beside the file (or in its parent
    directory) supplies the MODEL section first, so the graph matches the
    trained params."""
    path = weights or cfg.weights
    if not path:
        return Predictor(cfg, None, device=device)
    adopt_checkpoint_model_cfg(cfg, os.path.dirname(os.path.abspath(path)))
    pred = Predictor(cfg, None, device=device)
    pred.set_params(load_weights(path, pred.model, cfg.model))
    return pred


# Inference-budget / runtime-backend knobs are never adopted from a
# checkpoint's saved config: they do not define the trained params.
_RUNTIME_MODEL_FIELDS = model_fields_by_scope("runtime")


def adopt_checkpoint_model_cfg(cfg: Config, ckpt_dir: str) -> bool:
    """Adopt the MODEL section of the Trainer-written config.json in
    ``ckpt_dir`` or its parent, in place; True if one was adopted.  The
    caller's non-default model fields win over the saved ones, and
    ``_RUNTIME_MODEL_FIELDS`` keep the process's values."""
    for d in (ckpt_dir, os.path.dirname(os.path.normpath(ckpt_dir))):
        cfg_json = os.path.join(d, "config.json")
        if not os.path.exists(cfg_json):
            continue
        with open(cfg_json) as f:
            saved = json.load(f)
        if "model" not in saved:
            continue
        default = type(cfg.model)()
        caller_diff = {k: getattr(cfg.model, k) for k in vars(cfg.model)
                       if getattr(cfg.model, k) != getattr(default, k)}
        before = cfg.model
        cfg.model = Config.from_dict({"model": saved["model"]}).model
        for k in _RUNTIME_MODEL_FIELDS:
            setattr(cfg.model, k, getattr(before, k))
        for k, v in caller_diff.items():
            setattr(cfg.model, k, v)
        return True
    return False
