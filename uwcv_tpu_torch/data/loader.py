"""Image loading for inference (port of the inference half of
``uwcv_tpu/data/loader.py``).

``load_image_rgb`` gives, value for value, what the JAX package's loader
gives for the same file: PNG and TIFF decode through the port's own
``data/imageio.py`` (the card's machine has no PIL), then the JAX loader's
mode rules apply (16-bit → ``>> 8``, 32-bit ``I`` by its observed peak,
alpha dropped, a palette expanded, gray replicated to RGB).  Other formats
(JPEG above all) decode through PIL where it is installed, exactly as the
JAX loader does, and raise where it is not.  The training half (decode →
resize → rasterize → pack, ``TrainLoader``) comes with the training slice.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from uwcv_tpu_torch.data.imageio import decode_image, sniff_format


def _gray_to_uint8(arr: np.ndarray, mode: str) -> np.ndarray:
    """The JAX loader's rules for PIL's 16-bit and 32-bit gray modes."""
    if mode == "I;16":
        return np.right_shift(arr.astype(np.uint32), 8).clip(0, 255).astype(
            np.uint8)
    # 32-bit int container: scale by the observed range
    arr = arr.astype(np.int64).clip(0, None)
    peak = int(arr.max()) if arr.size else 0
    if peak > 65535:
        arr = arr * (255.0 / peak)
    elif peak > 255:
        arr = np.right_shift(arr, 8)
    return arr.clip(0, 255).astype(np.uint8)


def _to_rgb(pixels: np.ndarray, mode: str, palette=None) -> np.ndarray:
    """PIL's ``convert("RGB")`` for the modes ``decode_image`` returns."""
    if mode in ("I;16", "I"):
        pixels, mode = _gray_to_uint8(pixels, mode), "L"
    if mode == "P":
        return palette[pixels]
    if mode == "L":
        return np.repeat(pixels[..., None], 3, axis=-1)
    if mode == "LA":
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])      # RGB, RGBA


def _load_with_pil(path: str, fmt: str) -> np.ndarray:
    """The JAX loader itself, for formats the port does not decode."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: reading {fmt} images needs PIL (Pillow), which is not "
            f"installed; uwcv_tpu_torch reads PNG and TIFF itself") from e
    with Image.open(path) as im:
        if im.mode in ("I;16", "I;16B", "I;16L", "I;16N"):
            im = Image.fromarray(_gray_to_uint8(np.asarray(im), "I;16"))
        elif im.mode == "I":
            im = Image.fromarray(_gray_to_uint8(np.asarray(im), "I"))
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def load_image_rgb(path: str) -> np.ndarray:
    """Decode an image file to HWC uint8 RGB.

    SEM micrographs are commonly 16-bit grayscale TIFFs, scaled 16 → 8 bit
    by ``>> 8`` (what the reference's ``cv2.imread`` does)."""
    with open(path, "rb") as f:
        data = f.read()
    fmt = sniff_format(data[:8])
    if fmt not in ("PNG", "TIFF"):
        return _load_with_pil(path, fmt)
    return _to_rgb(*decode_image(data))


def list_inference_images(directory: str,
                          exts: Sequence[str] = (".tif", ".tiff", ".png",
                                                 ".jpg", ".jpeg")) -> List[str]:
    """Image files in a folder, sorted."""
    return [os.path.join(directory, f) for f in sorted(os.listdir(directory))
            if os.path.splitext(f)[1].lower() in exts]
