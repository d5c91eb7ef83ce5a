"""Folder-watching inference service (port of ``uwcv_tpu/engine/serve.py``).

Watches a directory for new images, batches them through a Predictor and
writes one JSON result per image (boxes in original pixels, scores,
classes, masks RLE-encoded in the reference CSV codec).  Results already in
the output directory are not served again, so a restarted service resumes
where it stopped.  The predictor may be a live one or one that serves an
exported program (``Predictor.from_exported``); batches never exceed the
exported batch.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

from uwcv_tpu_torch.data.loader import load_image_rgb
from uwcv_tpu_torch.engine.batch_inference import resize_masks_to_original
from uwcv_tpu_torch.measure.rle import rle_encoding


def _result_record(path: str, inst_np: Dict[str, np.ndarray]) -> Dict:
    masks = inst_np.get("masks")
    rles = []
    if masks is not None:
        for m in masks:
            rles.append(" ".join(str(v) for v in rle_encoding(m)))
    return {
        "file": os.path.basename(path),
        "num_instances": int(len(inst_np["scores"])),
        "boxes_xyxy": np.round(inst_np["boxes"], 2).tolist(),
        "scores": np.round(inst_np["scores"], 4).tolist(),
        "classes": inst_np["classes"].tolist(),
        "masks_rle": rles,
    }


def serve_forever(
    cfg,
    predictor,
    watch_dir: str,
    out_dir: str,
    batch_size: int = 4,
    poll_s: float = 1.0,
    once: bool = False,
    progress=print,
) -> int:
    """Poll ``watch_dir``; for every new image write
    ``out_dir/<name>.json``.  ``once=True`` drains the current backlog and
    returns; otherwise the loop runs until interrupted.  Returns the number
    of images served."""
    os.makedirs(out_dir, exist_ok=True)
    exts = tuple(cfg.data.image_ext)
    # keys are full file names (a.png and a.tif are distinct inputs); the
    # answer for <name>.<ext> is <name>.<ext>.json
    done = {f[:-len(".json")] for f in os.listdir(out_dir)
            if f.endswith(".json")}
    n_total = 0
    cap = getattr(predictor, "exported_batch", None)
    if cap is not None:
        batch_size = min(batch_size, cap)
    while True:
        fresh = sorted(
            os.path.join(watch_dir, f) for f in os.listdir(watch_dir)
            if f.lower().endswith(exts) and f not in done)
        for start in range(0, len(fresh), batch_size):
            chunk = fresh[start:start + batch_size]
            images = [load_image_rgb(p) for p in chunk]
            instances = predictor.predict_batch(images)
            for path, img, inst in zip(chunk, images, instances):
                inst_np = resize_masks_to_original(inst.to_numpy(),
                                                   img.shape[:2])
                rec = _result_record(path, inst_np)
                name = os.path.basename(path)
                with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
                    json.dump(rec, f)
                done.add(name)
                n_total += 1
                progress(f"served {name}: {rec['num_instances']} instances")
        if once:
            return n_total
        time.sleep(poll_s)
