"""Synthetic SEM-style dataset generator (port of
``uwcv_tpu/data/synthetic.py``).

The reference's dataset (polyHIPE foam micrographs annotated in
SuperAnnotate) is not shipped; for tests, smoke training and HPO demos the
generator draws images with the same four-class schema: a bright
rectangular "Scale bar", thin-wall ellipse rings ("Wall thickness"), small
dark ellipses ("Pore throats") and large ellipses ("Pores"), annotated in
the SuperAnnotate vector-export JSON schema the parser reads.  The draws
are the JAX package's, in its order, so one seed gives the same pixels and
JSONs; the PNGs are written by ``data/imageio.py::write_png`` (no PIL).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from uwcv_tpu_torch.data.classes import DEFAULT_CLASSES, ClassRegistry
from uwcv_tpu_torch.data.imageio import write_png


def _ellipse_instance(cls_name: str, cx, cy, rx, ry, angle) -> Dict:
    return {"type": "ellipse", "className": cls_name,
            "cx": float(cx), "cy": float(cy), "rx": float(rx),
            "ry": float(ry), "angle": float(angle)}


def _rect_polygon_instance(cls_name: str, x, y, w, h) -> Dict:
    pts = [x, y, x + w, y, x + w, y + h, x, y + h]
    return {"type": "polygon", "className": cls_name,
            "points": [float(p) for p in pts]}


def _draw_ellipse(img: np.ndarray, cx, cy, rx, ry, angle, value, ring=0.0):
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.deg2rad(angle)
    dx, dy = xx - cx, yy - cy
    u = (dx * np.cos(a) + dy * np.sin(a)) / max(rx, 1e-3)
    v = (-dx * np.sin(a) + dy * np.cos(a)) / max(ry, 1e-3)
    r2 = u * u + v * v
    if ring > 0:
        inner = (1.0 - ring) ** 2
        sel = (r2 <= 1.0) & (r2 >= inner)
    else:
        sel = r2 <= 1.0
    img[sel] = value


def generate_dataset(
    root: str,
    num_train: int = 6,
    num_test: int = 2,
    num_inference: int = 2,
    image_size: Tuple[int, int] = (256, 256),
    seed: int = 0,
) -> Dict[str, str]:
    """Create ``{Train,Test,INFERENCE}`` + ``classes.csv`` under ``root``
    (the reference's layout: labels beside the images; RGB PNGs).
    Returns the split directory paths."""
    rng = np.random.default_rng(seed)
    h, w = image_size
    paths = {}
    for split, count, with_labels in (
        ("Train", num_train, True),
        ("Test", num_test, True),
        ("INFERENCE", num_inference, False),
    ):
        split_dir = os.path.join(root, split)
        os.makedirs(split_dir, exist_ok=True)
        paths[split] = split_dir
        for i in range(count):
            img = np.full((h, w), 40, dtype=np.uint8)
            img += rng.integers(0, 12, (h, w), dtype=np.uint8)  # noise floor
            instances: List[Dict] = []

            # Scale bar: bright rectangle near the bottom
            bw = int(rng.uniform(0.25, 0.4) * w)
            bh = max(4, int(0.02 * h))
            bx = int(rng.uniform(0.05, 0.5) * w)
            by = int(rng.uniform(0.85, 0.92) * h)
            img[by:by + bh, bx:bx + bw] = 250
            instances.append(_rect_polygon_instance(
                DEFAULT_CLASSES[0], bx, by, bw, bh))

            # Pores: large bright ellipses
            for _ in range(rng.integers(2, 5)):
                cx, cy = rng.uniform(0.15, 0.85, 2) * (w, h)
                rx, ry = rng.uniform(0.06, 0.13, 2) * min(h, w)
                ang = rng.uniform(0, 180)
                _draw_ellipse(img, cx, cy, rx, ry, ang, 190)
                instances.append(_ellipse_instance(
                    DEFAULT_CLASSES[3], cx, cy, rx, ry, ang))

            # Pore throats: small dark ellipses
            for _ in range(rng.integers(2, 4)):
                cx, cy = rng.uniform(0.1, 0.9, 2) * (w, h)
                rx, ry = rng.uniform(0.02, 0.04, 2) * min(h, w)
                ang = rng.uniform(0, 180)
                _draw_ellipse(img, cx, cy, rx, ry, ang, 15)
                instances.append(_ellipse_instance(
                    DEFAULT_CLASSES[2], cx, cy, rx, ry, ang))

            # Wall thickness: one ellipse ring
            cx, cy = rng.uniform(0.3, 0.7, 2) * (w, h)
            rx, ry = rng.uniform(0.1, 0.16, 2) * min(h, w)
            ang = rng.uniform(0, 180)
            _draw_ellipse(img, cx, cy, rx, ry, ang, 120, ring=0.25)
            instances.append(_ellipse_instance(
                DEFAULT_CLASSES[1], cx, cy, rx, ry, ang))

            name = f"synthetic_{split.lower()}_{i:03d}.png"
            write_png(os.path.join(split_dir, name),
                      np.stack([img] * 3, axis=-1))
            if with_labels:
                payload = {
                    "metadata": {"name": name, "height": h, "width": w},
                    "instances": instances,
                }
                with open(os.path.join(split_dir, name + ".json"), "w") as f:
                    json.dump(payload, f)

    ClassRegistry().to_csv(os.path.join(root, "classes.csv"))
    paths["classes_csv"] = os.path.join(root, "classes.csv")
    return paths
