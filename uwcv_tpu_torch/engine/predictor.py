"""Predictor: folder/batch inference on one GPU, or data-parallel over a
mesh of GPUs (port of ``uwcv_tpu/engine/predictor.py``).

The host decodes, resizes (antialiased bilinear, no PIL) and pads a batch;
the device runs the optional resample, Mask R-CNN inference, the head-
resolution mask cleanup, the full-canvas paste, overlap claim, min-pixel
filter and bit-pack; the host pulls the valid prefix and builds padded
``Instances``.  ``Predictor.from_exported`` serves an exported program
(``engine/export.py``) through the same host API.

With a ``mesh`` (``parallel/mesh.py``) one process holds a replica of the
model on the first device of each data row: a batch staged as one is
split into contiguous slices, each row runs the device program on its
slice from its own thread (the morphology loops wait on the host each
pass, so one thread would serialize the rows), and the results merge in
batch order.  Over a model axis (m > 1) a row's trunk runs on its m
devices, the image's height split over them (``parallel/spatial.py``:
halo rows and the FPN levels move by copies, ``DeviceRow``); the row's
first device gathers the levels and runs the heads and the mask tail.
"""

from __future__ import annotations

import contextlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from uwcv_tpu_torch.config import Config, model_fields_by_scope
from uwcv_tpu_torch.data.augment import pack_bitmasks
from uwcv_tpu_torch.data.loader import load_image_rgb
from uwcv_tpu_torch.models.rcnn import MaskRCNN, compute_dtype
from uwcv_tpu_torch.ops.mask_paste import paste_masks, paste_select_pack
from uwcv_tpu_torch.ops.morphology import clean_head_masks, remove_overlaps
from uwcv_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    replicate,
    shard_batch,
    to_device,
)
from uwcv_tpu_torch.parallel.spatial import DeviceRow
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


@torch.no_grad()
def device_program(model: MaskRCNN, cfg: Config, images: torch.Tensor,
                   scales: torch.Tensor, out_sizes: torch.Tensor, canvas,
                   unit_scale: Optional[bool] = None, model_axis=None):
    """The predictor's device program: the optional resample, Mask R-CNN
    inference, the head-resolution mask cleanup, the paste, overlap claim,
    min-pixel filter and bit-pack.  ``Predictor._run`` runs it eagerly and
    ``engine/export.py`` traces it.

    images [B,Hc,Wc,3|1] uint8 host-padded; scales [B] f32; out_sizes [B,2]
    (true resized h, w); canvas (h, w): the canvas the model runs at →
    (Detections, packed masks [B,D,H,W/8] uint8 | None, keep [B,D] bool).
    ``unit_scale`` says whether every scale is 1 (the host already
    resampled, so the device resample is an identity); None decides it on
    the device with ``torch.cond``, as the JAX package's ``lax.cond``
    (predictor.py:199-209) does, which is how an exported program runs.
    ``model_axis`` (a ``DeviceRow``) runs the trunk on row shards."""
    mch, mcw = canvas
    if images.shape[-1] == 1:
        # grayscale transfer: one channel shipped, re-broadcast to RGB
        images = images.expand(images.shape[:-1] + (3,))
    dev = images.device
    yy = torch.arange(mch, device=dev)[None, :, None]
    xx = torch.arange(mcw, device=dev)[None, None, :]
    inside = ((yy < out_sizes[:, 0][:, None, None])
              & (xx < out_sizes[:, 1][:, None, None]))          # [B,H,W]

    def as_is(images, scales, inside):
        return images.float() * inside[..., None]

    def resample(images, scales, inside):
        return torch.stack([
            device_resize(images[i], scales[i], mch, mcw)
            for i in range(images.shape[0])]) * inside[..., None]

    operands = (images, scales, inside)
    if images.shape[1:3] != (mch, mcw):
        resized = resample(*operands)
    elif unit_scale is None:
        resized = torch.cond(torch.all(scales == 1.0), as_is, resample,
                             operands)
    else:
        resized = (as_is if unit_scale else resample)(*operands)

    dets, mask_probs = model.inference(resized, model_axis)
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
        mark(model.marks, "mask tail")
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
    mark(model.marks, "mask tail")
    return dets, packed, keep


class Predictor:
    """predictor = Predictor(cfg, flat_flax_params); insts =
    predictor.predict_batch(images_rgb)

    ``params`` is a flat ``/``-joined Flax param dict (``weights.load_npz``)
    or None to keep the model's own initialisation.  ``device`` defaults to
    ``cuda`` and raises when there is none; tests pass ``device="cpu"``.

    ``mesh`` (``parallel/mesh.py::build_mesh``): a replica on the first
    device of each data row, which replaces ``device``; a batch must then
    be a multiple of the data axis (``run_batch_inference`` pads its
    tail).  A model axis above 1 splits each image's height over its row's
    devices; the canvas must then give each of them rows
    (``mesh.height_shards``)."""

    def __init__(self, cfg: Config, params=None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        bkt = cfg.input.canvas_bucket
        if bkt <= 0 or bkt % cfg.input.size_divisibility:
            raise ValueError(
                f"input.canvas_bucket must be a positive multiple of "
                f"size_divisibility={cfg.input.size_divisibility}, got {bkt}")
        # host seconds per stage, collected only when a caller sets it
        self.stages: Optional[HostStages] = None
        self.mesh = mesh
        self.devices = ([resolve_device(d) for d in mesh.devices[:, 0]]
                        if mesh is not None else [resolve_device(device)])
        self.device = self.devices[0]
        model = MaskRCNN(cfg.model).to(dtype=compute_dtype(cfg.model)).eval()
        self.replicas = (replicate(model, mesh) if mesh is not None
                         else [model.to(self.device)])
        self.model = self.replicas[0]
        # each data row's model axis, where it has one
        self.row_axes = ([DeviceRow(row) for row in mesh.devices]
                         if mesh is not None and mesh.devices.shape[1] > 1
                         else [None] * len(self.devices))
        # a thread per data row drives its replica
        self._pool = (ThreadPoolExecutor(len(self.devices))
                      if mesh is not None else None)
        if params is not None:
            self.set_params(params)
        self.pad_h, self.pad_w = cfg.input.pad_size_test

    def set_params(self, params) -> None:
        """Swap flat Flax params into the existing model (every replica of
        a mesh) in place: it keeps its dtype and device, and is not
        rebuilt.  HPO reuses one eval predictor across trials this way."""
        if self.model is None:
            raise ValueError("an exported program's weights are baked into "
                             "it: export again to change them")
        state = params_from_flax(params)
        for replica in self.replicas:
            replica.load_state_dict(state, strict=True)

    @classmethod
    def from_exported(cls, cfg: Config, path: str,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> "Predictor":
        """Serve an exported inference program (``engine/export.py``): the
        same host API, but the device program, weights included, loads
        from ``path`` with no model built.  Batches smaller than the
        exported batch are padded in and sliced out; images must fit the
        exported canvas, which is also the canvas the model runs at."""
        from uwcv_tpu_torch.engine.export import load_exported

        self = cls.__new__(cls)
        self.cfg = cfg
        self.stages = None
        self.mesh = None
        self.device = resolve_device(device)
        self.devices = [self.device]
        self.model = None
        self.replicas = []
        self.row_axes = [None]
        self._pool = None
        self.pad_h, self.pad_w = cfg.input.pad_size_test
        self._run, self.exported_batch, self.exported_canvas = \
            load_exported(path, self.device)
        return self

    # -------- device program --------

    def _run(self, images: torch.Tensor, scales: np.ndarray,
             out_sizes: torch.Tensor, model_canvas=None, model=None,
             model_axis=None):
        """images [B,Hc,Wc,3|1] uint8 host-padded (on the device); scales
        [B] host floats; out_sizes [B,2] (true resized h, w) → (Detections,
        packed masks [B,D,H,W/8] uint8 | None, keep [B,D] bool).  The host
        knows the scales, so it picks the unit-scale fast path itself.
        ``model``: the replica to run (default the first); ``model_axis``:
        its row's ``DeviceRow``, if any."""
        return device_program(
            model or self.model, self.cfg, images,
            torch.as_tensor(scales, dtype=torch.float32), out_sizes,
            model_canvas or (self.pad_h, self.pad_w),
            unit_scale=bool(np.all(np.asarray(scales) == 1.0)),
            model_axis=model_axis)

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
        out_sizes)`` maps results back to original-image coordinates.
        Over a mesh the batch is staged as one (one canvas) and
        ``device_ops`` is a list: each device's contiguous slice
        (``batch_sharding``) on that device."""
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
        unmap = ([p[2] for p in prepped], [p[3] for p in prepped])
        if self.mesh is None:
            return ((to_device(batch, self.device), scales,
                     to_device(out_sizes, self.device), (mch, mcw)), unmap)
        shards = shard_batch({"images": batch, "out_sizes": out_sizes},
                             self.mesh)
        return ([(sh["images"], scales[s], sh["out_sizes"], (mch, mcw))
                 for sh, s in zip(shards, batch_sharding(self.mesh,
                                                          len(batch)))],
                unmap)

    def predict_batch_device(self, images_rgb: Sequence[np.ndarray],
                             block: bool = True):
        """Run a batch, returning device-resident results: (Detections,
        packed masks | None, keep, unmap scales, out sizes), over a mesh a
        list of them, one a data row in batch order.  Waits for the device
        to finish unless ``block=False``, which lets a caller pipeline
        batches (``start_pull`` then ``to_instances``)."""
        with host_stage(self.stages, "stage_batch"):
            device_ops, unmap = self.stage_batch(images_rgb)
        with host_stage(self.stages, "_run"):
            if self.mesh is None:
                out = self._run(*device_ops) + unmap
            else:
                runs = [self._pool.submit(self._run_replica, i, ops)
                        for i, ops in enumerate(device_ops)]
                shards = batch_sharding(self.mesh, len(images_rgb))
                out = [r.result() + (unmap[0][s], unmap[1][s])
                       for r, s in zip(runs, shards)]
        if block:
            for dev in set(self.mesh.devices.flat if self.mesh is not None
                           else self.devices):
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
        return out

    def _run_replica(self, i: int, ops):
        """``_run`` of data row ``i``'s replica on its first device (a
        mesh's thread), over the row's model axis."""
        dev = self.devices[i]
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            return self._run(*ops, model=self.replicas[i],
                             model_axis=self.row_axes[i])

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
        a sync); ``to_instances`` unpacks only the valid prefix.  A mesh's
        result gives a list, one a device."""
        if isinstance(device_out, list):
            return [self.start_pull(o) for o in device_out]
        dets, masks_packed, keep, scales, out_sizes = device_out
        fields = [dets.boxes, dets.scores, dets.classes, dets.valid & keep,
                  masks_packed]
        ready = None
        dev = dets.boxes.device
        if dev.type == "cuda":
            fields = [None if t is None else torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True).copy_(
                    t, non_blocking=True) for t in fields]
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        mark(getattr(self.model, "marks", None), "d2h")
        return PulledBatch(*fields, scales, out_sizes, ready)

    def to_instances(self, out) -> List[Instances]:
        """Host Instances of a ``predict_batch_device`` result or of a
        ``start_pull`` of one (then waiting for that copy only); of the
        masks only the valid-slot prefix is unpacked (detection slots are
        score-sorted).  A mesh's pieces merge in batch order."""
        if isinstance(out, list):
            return [inst for piece in out
                    for inst in self.to_instances(piece)]
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
                   device: Optional[Union[str, torch.device]] = None,
                   mesh: Optional[Mesh] = None) -> Predictor:
    """Build a predictor (over ``mesh`` when given) from ``weights`` or
    ``cfg.weights``: a ``save_params_npz`` checkpoint or a torch ``.pth``
    state dict mapped onto the fresh model's params
    (``engine/checkpoint.py::load_weights``).  A Trainer-written
    ``config.json`` beside the file (or in its parent directory) supplies
    the MODEL section first, so the graph matches the trained params."""
    path = weights or cfg.weights
    if not path:
        return Predictor(cfg, None, device=device, mesh=mesh)
    adopt_checkpoint_model_cfg(cfg, os.path.dirname(os.path.abspath(path)))
    pred = Predictor(cfg, None, device=device, mesh=mesh)
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
