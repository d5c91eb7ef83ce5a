"""COCO-instance-format ingestion and export (a copy of
``uwcv_tpu/data/coco.py``).

The reference consumes COCO format only implicitly (Detectron2's zoo config +
COCOEvaluator import, nn_train.py:49).  BASELINE.json config #2 requires
"batch box-only inference on a COCO-format folder", so we support the format
natively in both directions — load a ``annotations.json`` into dataset dicts,
and dump predictions/datasets back out for evaluation.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence


def load_coco_json(
    json_file: str,
    image_root: str,
) -> List[Dict]:
    """COCO instances JSON → dataset dicts (same schema as superannotate.py).

    Category ids are remapped to a contiguous [0, C) range ordered by the
    original id, as Detectron2 does.
    """
    with open(json_file) as f:
        coco = json.load(f)

    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}

    anns_by_image: Dict[int, List[Dict]] = {}
    for ann in coco.get("annotations", []):
        anns_by_image.setdefault(ann["image_id"], []).append(ann)

    records = []
    for img in sorted(coco.get("images", []), key=lambda im: im["id"]):
        record = {
            "file_name": os.path.join(image_root, img["file_name"]),
            "image_id": img["id"],
            "height": int(img["height"]),
            "width": int(img["width"]),
            "annotations": [],
        }
        for ann in anns_by_image.get(img["id"], []):
            x, y, w, h = ann["bbox"]  # COCO XYWH
            seg = ann.get("segmentation", [])
            crowd = int(ann.get("iscrowd", 0))
            entry = {
                "bbox": [float(x), float(y), float(x + w), float(y + h)],
                "bbox_mode": "XYXY_ABS",
                "category_id": id_map[ann["category_id"]],
                # crowd annotations are KEPT with the flag: the train
                # loader drops them (the reference mapper's convention,
                # nn_train.py:150 / Detectron2 DatasetMapper iscrowd==0
                # filter) while the evaluator consumes them as
                # pycocotools ignore-matches (eval/coco_eval.py)
                "iscrowd": crowd,
            }
            if isinstance(seg, dict):
                # uncompressed COCO RLE (the crowd-region format): decoded
                # lazily by rasterize.annotations_to_arrays via
                # measure/rle.py
                entry["segmentation"] = []
                entry["segmentation_rle"] = seg
            else:
                entry["segmentation"] = [list(map(float, p)) for p in seg]
            record["annotations"].append(entry)
        records.append(record)
    return records


def dataset_dicts_to_coco(
    dicts: Sequence[Dict],
    class_names: Sequence[str],
) -> Dict:
    """Dataset dicts → COCO instances JSON structure (for the evaluator)."""
    images, annotations = [], []
    ann_id = 1
    for rec in dicts:
        images.append({
            "id": rec["image_id"],
            "file_name": os.path.basename(rec["file_name"]),
            "height": rec["height"],
            "width": rec["width"],
        })
        for ann in rec.get("annotations", []):
            x1, y1, x2, y2 = ann["bbox"]
            annotations.append({
                "id": ann_id,
                "image_id": rec["image_id"],
                "category_id": int(ann["category_id"]),
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "area": float(max(x2 - x1, 0) * max(y2 - y1, 0)),
                "iscrowd": int(ann.get("iscrowd", 0)),
                "segmentation": (ann["segmentation_rle"]
                                 if ann.get("segmentation_rle") is not None
                                 else ann.get("segmentation", [])),
            })
            ann_id += 1
    return {
        "images": images,
        "annotations": annotations,
        "categories": [
            {"id": i, "name": n} for i, n in enumerate(class_names)
        ],
    }


def save_coco_json(dicts: Sequence[Dict], class_names: Sequence[str],
                   path: str) -> None:
    with open(path, "w") as f:
        json.dump(dataset_dicts_to_coco(dicts, class_names), f)
