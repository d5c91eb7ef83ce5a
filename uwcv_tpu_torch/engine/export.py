"""Ahead-of-time export of the inference program (port of
``uwcv_tpu/engine/export.py``).

The whole device program of ``Predictor._run`` (``device_program``:
resample → ResNet-FPN → RPN → box pooler → box head and NMS → mask pooler
→ mask head → cleanup floods → paste → overlap claim → bit-pack) is traced
by ``torch.export`` at one (batch, canvas) and saved, weights included, to
one ``.pt2`` file.  A serving process calls ``Predictor.from_exported(cfg,
path)`` and gets the same host API without building the model:

- the CUDA kernels stay in the program as the ops
  ``uwcv::roi_align_windows``, ``uwcv::nms_greedy``,
  ``uwcv::paste_claim_pack`` and ``uwcv::frozen_bn_act`` (the trunk's conv
  epilogues); loading needs only the modules that register them
  (``ops/roi_align.py``, ``ops/nms.py``, ``ops/mask_paste.py``,
  ``ops/frozen_bn.py``);
- the morphology floods are ``while_loop``s and the unit-scale fast path a
  ``torch.cond``, so no host check is baked in;
- smaller batches and canvases are zero-padded in and sliced out;
- the program's outputs are a flat tuple of tensors (boxes, scores,
  classes, valid, keep, and the packed masks when the config has masks),
  from which the loader rebuilds ``Detections``: nothing of the model's
  types has to be registered for serialization;
- an artifact runs on the device type it was exported for (its constants
  and kernels live there); any other device raises.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

# the ops' registrations, which a loaded program calls
import uwcv_tpu_torch.ops.frozen_bn  # noqa: F401
import uwcv_tpu_torch.ops.mask_paste  # noqa: F401
import uwcv_tpu_torch.ops.nms  # noqa: F401
import uwcv_tpu_torch.ops.roi_align  # noqa: F401
from uwcv_tpu_torch.structures.boxes import Detections
from uwcv_tpu_torch.utils.device import resolve_device
from uwcv_tpu_torch.utils.image import bucket_up

META = "uwcv_export.json"   # the artifact's own record, an extra file


class _Program(torch.nn.Module):
    """``device_program`` at a fixed canvas as a module for
    ``torch.export``: the model is a submodule, so its weights become the
    program's state, and the outputs are flat."""

    def __init__(self, predictor, canvas: Tuple[int, int]):
        super().__init__()
        self.model = predictor.model
        self.cfg = predictor.cfg
        self.canvas = canvas

    def forward(self, images, scales, out_sizes):
        from uwcv_tpu_torch.engine.predictor import device_program

        dets, packed, keep = device_program(self.model, self.cfg, images,
                                            scales, out_sizes, self.canvas)
        out = (dets.boxes, dets.scores, dets.classes, dets.valid, keep)
        return out if packed is None else out + (packed,)


def export_predictor(predictor, path: str, batch_size: int = 8,
                     canvas: Optional[Tuple[int, int]] = None) -> str:
    """Export ``predictor``'s device program with its weights to ``path``
    on the predictor's device.  Inputs: images [batch_size, ch, cw, 3]
    uint8, scales [batch_size] f32, out_sizes [batch_size, 2] int32.
    ``canvas`` (ch, cw) defaults to the test pad canvas; either is rounded
    up to ``input.canvas_bucket``.  The model runs at the canvas clipped to
    the pad canvas, as the live predictor's model canvas is."""
    cfg = predictor.cfg
    bkt = cfg.input.canvas_bucket
    ch, cw = canvas or cfg.input.pad_size_test
    ch, cw = bucket_up(ch, bkt), bucket_up(cw, bkt)
    model_canvas = (min(ch, predictor.pad_h), min(cw, predictor.pad_w))
    dev = predictor.device
    args = (torch.zeros((batch_size, ch, cw, 3), dtype=torch.uint8,
                        device=dev),
            torch.ones((batch_size,), dtype=torch.float32, device=dev),
            torch.tensor([[ch, cw]] * batch_size, dtype=torch.int32,
                         device=dev))
    # the anchors are built and cached eagerly, so the trace reads them as
    # constants (built inside the trace, fake tensors would be cached)
    predictor.model._anchors(model_canvas, args[0].device)
    with torch.no_grad():
        program = torch.export.export(_Program(predictor, model_canvas),
                                      args, strict=False)
    meta = {"device": dev.type, "batch": batch_size, "canvas": [ch, cw]}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path, extra_files={META: json.dumps(meta)})
    return path


def read_meta(path: str) -> dict:
    """The artifact's own record (device type, batch, canvas), read without
    loading the program."""
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist()
                 if n.endswith(f"/extra/{META}") or n == f"extra/{META}"]
        if not names:
            raise ValueError(f"{path} is not an artifact of export_predictor")
        return json.loads(z.read(names[0]))


def load_exported(path: str,
                  device: Optional[Union[str, torch.device]] = None):
    """Load an exported inference program → ``(run, batch, (ch, cw))``.
    ``run(images, scales, out_sizes, model_canvas=None)`` has the signature
    of ``Predictor._run``: it re-broadcasts 1-channel batches, pads smaller
    batches and canvases in, slices the results out, and raises for a
    batch or canvas larger than the artifact's.  ``device`` defaults to
    ``cuda``; it must be of the type the artifact was exported for."""
    dev = resolve_device(device)
    meta = read_meta(path)
    if meta["device"] != dev.type:
        raise ValueError(f"{path} was exported for {meta['device']} and runs "
                         f"only there, not on {dev.type}: export it again "
                         f"on {dev.type}")
    call = torch.export.load(path).module()
    b = meta["batch"]
    ch, cw = meta["canvas"]

    def run(images, scales, out_sizes, model_canvas=None):
        # the program's canvas is fixed: model_canvas, the live
        # predictor's per-batch choice, does not apply
        n, h, w = images.shape[:3]
        if n > b:
            raise ValueError(f"exported for batch {b}, got {n}")
        if h > ch or w > cw:
            raise ValueError(f"exported for canvas {(ch, cw)}, got {(h, w)}")
        if images.shape[-1] == 1:
            images = images.expand(images.shape[:-1] + (3,))
        scales = torch.as_tensor(scales, dtype=torch.float32,
                                 device=images.device)
        if (n, h, w) != (b, ch, cw):
            images = F.pad(images, (0, 0, 0, cw - w, 0, ch - h, 0, b - n))
            scales = F.pad(scales, (0, b - n), value=1.0)
            out_sizes = F.pad(out_sizes, (0, 0, 0, b - n))
        with torch.no_grad():
            out = [t[:n] for t in call(images, scales, out_sizes)]
        packed = out[5] if len(out) > 5 else None
        return Detections(*out[:4]), packed, out[4]

    return run, b, (ch, cw)
