"""Folder inference and the measurement sweep (port of
``uwcv_tpu/engine/batch_inference.py``).

Folder of images → predictor → RLE CSV, then the per-class measurement
sweep over the same predictions (each image is inferred once).  pandas is
not needed: the CSVs are written by ``measure/reports.py::write_csv``,
byte for byte as the JAX package's pandas writes them.  The ground-truth
gallery (``save_gt_visualizations``) writes its PNGs with
``data/imageio.py::write_png`` and needs no PIL; the prediction overlays and
union-mask JPEGs still need PIL.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from uwcv_tpu_torch.config import Config
from uwcv_tpu_torch.data.classes import ClassRegistry
from uwcv_tpu_torch.data.imageio import write_png
from uwcv_tpu_torch.data.loader import list_inference_images, load_image_rgb
from uwcv_tpu_torch.data.rasterize import polygons_to_mask
from uwcv_tpu_torch.engine.predictor import Predictor
from uwcv_tpu_torch.measure.reports import MeasurementReport, write_csv
from uwcv_tpu_torch.measure.rle import rle_encoding
from uwcv_tpu_torch.utils.device import host_stage


def resize_masks_to_original(inst_np: Dict[str, np.ndarray],
                             orig_hw: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """Predicted masks live in the resized frame; the RLE CSV and the
    measurements are in original image pixels: nearest upsample back (one
    combined host gather)."""
    masks = inst_np.get("masks")
    if masks is None or len(masks) == 0:
        return inst_np
    mh, mw = masks.shape[1:]
    oh, ow = orig_hw
    if (mh, mw) == (oh, ow):
        return inst_np
    ys = np.clip((np.arange(oh) * mh / oh).astype(np.int64), 0, mh - 1)
    xs = np.clip((np.arange(ow) * mw / ow).astype(np.int64), 0, mw - 1)
    out = dict(inst_np)
    out["masks"] = masks[:, ys[:, None], xs[None, :]]
    return out


def apply_class_filters(
    inst_np: Dict[str, np.ndarray],
    thresholds: Sequence[float],
    min_pixels: Sequence[int],
) -> Dict[str, np.ndarray]:
    """Per-class score threshold + minimum mask size (reference C9
    ``get_masks``, nn_inference.py:204-219): an instance is kept if
    score ≥ thresholds[class] and mask pixel count ≥ min_pixels[class].
    Classes beyond the configured lists pass unfiltered."""
    classes = inst_np["classes"]
    keep = np.ones(len(classes), bool)
    thr = np.asarray(thresholds, float)
    mpx = np.asarray(min_pixels, float)
    in_range = classes < len(thr)
    keep[in_range] &= inst_np["scores"][in_range] >= thr[classes[in_range]]
    masks = inst_np.get("masks")
    if masks is not None and len(masks):
        sizes = masks.reshape(len(masks), -1).sum(axis=1)
        in_range_m = classes < len(mpx)
        keep[in_range_m] &= sizes[in_range_m] >= mpx[classes[in_range_m]]
    return {k: (v[keep] if isinstance(v, np.ndarray) and len(v) == len(keep)
                else v) for k, v in inst_np.items()}


def run_batch_inference(
    cfg: Config,
    predictor: Predictor,
    image_dir: Optional[str] = None,
    batch_size: int = 8,
    csv_name: str = "R50_flip_.csv",
    registry: Optional[ClassRegistry] = None,
    with_measurements: bool = True,
    with_plots: bool = False,
    progress=print,
) -> Dict[str, object]:
    """Folder → predictions → ``<output_dir>/<csv_name>`` RLE CSV (+ the
    measurement artifacts).  Returns {"csv": path, "report":
    MeasurementReport | None, "num_images": int, "predictions": {path:
    instances_np}}.  When ``predictor.stages`` is set, the host seconds of
    decode, RLE, measurement and the CSV writes are added to it beside the
    predictor's own stages."""
    image_dir = image_dir or cfg.data.inference_dir
    registry = registry or ClassRegistry.load(cfg.data.classes_csv)
    paths = list_inference_images(image_dir, cfg.data.image_ext)
    if not paths:
        raise FileNotFoundError(f"no images found under {image_dir}")
    os.makedirs(cfg.output_dir, exist_ok=True)
    stages = predictor.stages

    report = MeasurementReport(registry, cfg.measure, cfg.output_dir)
    rows: List[Tuple[str, str]] = []
    predictions: Dict[str, Dict[str, np.ndarray]] = {}

    def consume(chunk, images, pulled) -> None:
        for path, img, inst in zip(chunk, images,
                                   predictor.to_instances(pulled)):
            inst_np = inst.to_numpy()
            with host_stage(stages, "resize_masks_to_original"):
                inst_np = resize_masks_to_original(inst_np, img.shape[:2])
            if cfg.postprocess.use_class_filters:
                inst_np = apply_class_filters(
                    inst_np, cfg.postprocess.class_thresholds,
                    cfg.postprocess.class_min_pixels)
            predictions[path] = inst_np
            name = os.path.basename(path)
            masks = inst_np.get("masks")
            n = 0 if masks is None else len(masks)
            # one CSV row per instance mask (nn_inference.py:330-332)
            with host_stage(stages, "rle"):
                for i in range(n):
                    rle = rle_encoding(masks[i])
                    if rle:
                        rows.append((name, " ".join(str(v) for v in rle)))
            if with_measurements:
                with host_stage(stages, "measurement"):
                    report.add_image(inst_np)
            progress(f"{name}: {n} instances")

    def decode(chunk):
        with host_stage(stages, "decode"):
            return [load_image_rgb(p) for p in chunk]

    # Pipeline: a worker thread decodes batch i+1 while batch i runs; batch
    # i's device → host copy is enqueued right after its dispatch, so the
    # host pulls and post-processes batch i-1 without waiting for batch i.
    chunks = [paths[s:s + batch_size]
              for s in range(0, len(paths), batch_size)]
    with ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(decode, chunks[0])
        pending = None
        for ci, chunk in enumerate(chunks):
            images = nxt.result()
            if ci + 1 < len(chunks):
                nxt = pool.submit(decode, chunks[ci + 1])
            run_images = images
            if predictor.mesh is not None:
                # a batch over a mesh must tile its data axis: the tail
                # repeats its last image, and consume() zips that away
                d = predictor.mesh.devices.shape[0]
                run_images = images + [images[-1]] * (-len(images) % d)
            pulled = predictor.start_pull(
                predictor.predict_batch_device(run_images, block=False))
            if pending is not None:
                consume(*pending)
            pending = (chunk, images, pulled)
        consume(*pending)

    csv_path = os.path.join(cfg.output_dir, csv_name)
    with host_stage(stages, "csv writes"):
        write_csv(csv_path, ["ImageId", "EncodedPixels"], rows)

    out: Dict[str, object] = {
        "csv": csv_path,
        "num_images": len(paths),
        "predictions": predictions,
        "report": None,
    }
    if with_measurements:
        with host_stage(stages, "csv writes"):
            report.write_shape_descriptor_csv()
            report.write_results_csvs()
        if with_plots:
            report.write_distribution_plots()
        progress(f"class totals: {report.summary()}")
        out["report"] = report
    return out


def save_gt_visualizations(
    dataset_dicts: Sequence[Dict],
    registry: ClassRegistry,
    output_dir: str,
    max_images: int = 5,
    alpha: float = 0.4,
) -> List[str]:
    """Ground-truth overlays of dataset dicts (the reference's random-sample
    GT gallery, COLAB_PORT.py:167-174): the annotation polygons rasterized
    (``data/rasterize.py``) and blended in their class colours, one
    ``<image>_gt.png`` per record."""
    os.makedirs(output_dir, exist_ok=True)
    out_paths = []
    for rec in list(dataset_dicts)[:max_images]:
        img = load_image_rgb(rec["file_name"]).astype(np.float32)
        h, w = img.shape[:2]
        for ann in rec.get("annotations", []):
            color = np.asarray(
                registry.colors[int(ann["category_id"]) %
                                len(registry.colors)], np.float32)
            mask = polygons_to_mask(ann["segmentation"], h, w)
            img[mask] = (1 - alpha) * img[mask] + alpha * color
        name = os.path.splitext(os.path.basename(rec["file_name"]))[0]
        out = write_png(os.path.join(output_dir, f"{name}_gt.png"),
                        img.clip(0, 255).astype(np.uint8))
        out_paths.append(out)
    return out_paths


def save_visualizations(
    predictions: Dict[str, Dict[str, np.ndarray]],
    registry: ClassRegistry,
    output_dir: str,
    alpha: float = 0.45,
) -> List[str]:
    """Instance overlays (the reference's Visualizer path,
    nn_inference.py:343-350): per-class colours blended over the image, box
    outlines, and a "<class> <score>%" label per instance.  Needs PIL for
    the text and the PNG encoder."""
    from PIL import Image, ImageDraw

    os.makedirs(output_dir, exist_ok=True)
    out_paths = []
    for path, inst in predictions.items():
        img = load_image_rgb(path).astype(np.float32)
        masks = inst.get("masks")
        if masks is not None:
            for mask, cls in zip(masks, inst["classes"]):
                color = np.asarray(registry.colors[int(cls) %
                                                   len(registry.colors)],
                                   np.float32)
                img[mask] = (1 - alpha) * img[mask] + alpha * color
        for box, cls in zip(inst["boxes"], inst["classes"]):
            color = registry.colors[int(cls) % len(registry.colors)]
            x1, y1, x2, y2 = [int(round(v)) for v in box]
            x1, x2 = np.clip([x1, x2], 0, img.shape[1] - 1)
            y1, y2 = np.clip([y1, y2], 0, img.shape[0] - 1)
            img[y1:y2 + 1, [x1, x2]] = color
            img[[y1, y2], x1:x2 + 1] = color
        pil = Image.fromarray(img.clip(0, 255).astype(np.uint8))
        draw = ImageDraw.Draw(pil)
        scores = inst.get("scores")
        for i, (box, cls) in enumerate(zip(inst["boxes"], inst["classes"])):
            name = registry.names[int(cls) % len(registry.names)]
            label = (f"{name} {100 * float(scores[i]):.0f}%"
                     if scores is not None else name)
            x1, y1 = int(round(box[0])), int(round(box[1]))
            ty = max(y1 - 11, 0)
            tw = int(draw.textlength(label))
            draw.rectangle([x1, ty, x1 + tw + 2, ty + 11], fill=(0, 0, 0))
            draw.text((x1 + 1, ty), label, fill=(255, 255, 255))
        name = os.path.splitext(os.path.basename(path))[0] + "_pred.png"
        out = os.path.join(output_dir, name)
        pil.save(out)
        out_paths.append(out)
    return out_paths


def save_union_masks(
    predictions: Dict[str, Dict[str, np.ndarray]],
    output_dir: str,
    classes_of_interest: Optional[Sequence[int]] = None,
) -> List[str]:
    """Binary union-mask canvases (the reference's ``predicted_masks.jpg``
    dumps, nn_inference.py:394-405): black, 255 wherever an instance of the
    selected classes is predicted; one ``<image>_masks.jpg`` per input.
    Needs PIL for the JPEG encoder."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    out_paths = []
    for path, inst in predictions.items():
        masks = inst.get("masks")
        if masks is None:
            continue
        classes = np.asarray(inst["classes"])
        sel = (np.isin(classes, np.asarray(list(classes_of_interest)))
               if classes_of_interest is not None
               else np.ones(len(classes), bool))
        if not (len(masks) and sel.any()):
            continue
        union = np.any(np.asarray(masks)[sel], axis=0)
        canvas = np.where(union[..., None], 255, 0).astype(np.uint8)
        canvas = np.repeat(canvas, 3, axis=-1)
        name = os.path.splitext(os.path.basename(path))[0] + "_masks.jpg"
        out = os.path.join(output_dir, name)
        Image.fromarray(canvas).save(out)
        out_paths.append(out)
    return out_paths
