"""SuperAnnotate vector-export parser (port of
``uwcv_tpu/data/superannotate.py``; image sizes missing from an export are
read with the port's own decoder instead of PIL).

Rebuilds the reference's ``get_superannotate_dicts`` (nn_train.py:58-128)
without shapely: ellipse instances are sampled parametrically instead of
buffer/scale/rotate through GEOS (SURVEY.md N13), polygons are de-interleaved
directly (the reference's slice-and-append dance at nn_train.py:100-103
reconstructs exactly the same vertex pairing).

Output schema is the Detectron2-style "dataset dict" the rest of the stack
consumes:
    {"file_name", "image_id", "height", "width",
     "annotations": [{"bbox" XYXY_ABS, "segmentation": [flat xy...],
                      "category_id"}]}
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from uwcv_tpu_torch.data.classes import ClassRegistry

# The reference's shapely Point.buffer(1) uses quad_segs=8 → 16 segments per
# quarter circle → 64 unique vertices on the ring.
ELLIPSE_SEGMENTS = 64


def ellipse_to_polygon(
    cx: float, cy: float, rx: float, ry: float, angle_deg: float,
    segments: int = ELLIPSE_SEGMENTS,
) -> np.ndarray:
    """Sample an ellipse boundary as [segments, 2] float64 vertices.

    Matches the reference's construction (nn_train.py:84-98): unit circle at
    (cx,cy), scaled by (int(rx), int(ry)) about its center, rotated by
    `angle_deg` counter-clockwise in xy (shapely.affinity.rotate default) —
    which, with the image y-axis pointing down, is clockwise on screen.
    """
    rx_i, ry_i = float(int(rx)), float(int(ry))
    t = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    x = rx_i * np.cos(t)
    y = ry_i * np.sin(t)
    a = np.deg2rad(angle_deg)
    xr = x * np.cos(a) - y * np.sin(a)
    yr = x * np.sin(a) + y * np.cos(a)
    return np.stack([xr + cx, yr + cy], axis=1)


def parse_instance(anno: Dict, registry: ClassRegistry) -> Optional[Dict]:
    """One SA instance → one annotation dict, or None for unsupported types
    (the reference explicitly skips polylines — COLAB_PORT.py:82-88 comments
    them out; it would KeyError on them, we skip cleanly)."""
    typ = anno.get("type")
    if typ == "ellipse":
        try:
            pts = ellipse_to_polygon(
                float(anno["cx"]), float(anno["cy"]),
                float(anno["rx"]), float(anno["ry"]),
                float(anno.get("angle", 0.0)))
        except (KeyError, TypeError, ValueError):
            return None      # malformed ellipse record: skip, don't crash
    elif typ == "polygon":
        try:
            flat = np.asarray(anno["points"], dtype=np.float64).reshape(-1)
        except (KeyError, TypeError, ValueError):
            return None      # points in an unexpected nesting/dtype
        if flat.size < 6 or flat.size % 2 != 0:
            return None
        pts = flat.reshape(-1, 2)
    else:
        return None

    if not np.isfinite(pts).all():
        return None          # NaN/inf coordinates would silently poison
                             # bbox targets downstream
    if "className" not in anno:
        return None
    category_id = registry.id_of(anno["className"])

    # +0.5 px center offset, as the reference applies to the polygon
    # (nn_train.py:105).  Unlike the reference — which computes the bbox from
    # the *unshifted* points (nn_train.py:120) — we keep bbox consistent with
    # the shifted polygon (a 0.5 px intent-preserving fix, SURVEY.md §2a).
    pts = pts + 0.5
    poly = pts.reshape(-1).tolist()
    bbox = [float(pts[:, 0].min()), float(pts[:, 1].min()),
            float(pts[:, 0].max()), float(pts[:, 1].max())]
    return {
        "bbox": bbox,
        "bbox_mode": "XYXY_ABS",
        "segmentation": [poly],
        "category_id": category_id,
    }


def get_superannotate_dicts(
    img_dir: str,
    label_dir: Optional[str] = None,
    registry: Optional[ClassRegistry] = None,
) -> List[Dict]:
    """Walk ``label_dir`` for ``*.json`` SA exports (nn_train.py:61-68).

    In the reference img_dir == label_dir (nn_train.py:188); we default the
    same way.
    """
    label_dir = label_dir or img_dir
    registry = registry or ClassRegistry()
    dataset_dicts: List[Dict] = []
    idx = 0
    for root, _dirs, files in sorted(os.walk(label_dir)):
        for fname in sorted(files):
            if not fname.endswith(".json"):
                continue
            try:
                with open(os.path.join(root, fname)) as f:
                    payload = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue     # unreadable/truncated export: skip the file
            if not isinstance(payload, dict):
                continue     # e.g. SA's classes.json is a LIST — real
                             # exports ship it next to the per-image jsons
            meta = payload.get("metadata", {})
            if not isinstance(meta, dict) or "name" not in meta:
                continue     # not a per-image SA export (config jsons etc.)
            height, width = meta.get("height"), meta.get("width")
            if height is None or width is None:
                # old exports sometimes omit dims; recover them from the
                # image itself when it exists, else skip the record
                try:
                    from uwcv_tpu_torch.data.loader import load_image_rgb

                    height, width = load_image_rgb(
                        os.path.join(img_dir, meta["name"])).shape[:2]
                except Exception:
                    continue
            record = {
                "file_name": os.path.join(img_dir, meta["name"]),
                "image_id": idx,
                "height": int(height),
                "width": int(width),
            }
            idx += 1
            objs = []
            instances = payload.get("instances", [])
            if not isinstance(instances, list):
                instances = []
            for anno in instances:
                if not isinstance(anno, dict):
                    continue
                parsed = parse_instance(anno, registry)
                if parsed is not None:
                    objs.append(parsed)
            record["annotations"] = objs
            dataset_dicts.append(record)
    return dataset_dicts
