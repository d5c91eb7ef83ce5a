"""Image loading and the training input pipeline (port of
``uwcv_tpu/data/loader.py``).

``load_image_rgb`` gives, value for value, what the JAX package's loader
gives for the same file: PNG and TIFF decode through the port's own
``data/imageio.py`` (the card's machine has no PIL), then the JAX loader's
mode rules apply (16-bit → ``>> 8``, 32-bit ``I`` by its observed peak,
alpha dropped, a palette expanded, gray replicated to RGB).  Other formats
(JPEG above all) decode through PIL where it is installed, exactly as the
JAX loader does, and raise where it is not.

Training: worker threads decode, resize to ``input.train_size`` (the
PIL-free ``utils/image.py::host_resize``, within 2 gray levels of the JAX
loader's PIL resize), rasterize the gt polygons (scanline fill) and
bit-pack the masks; every sample has a static shape.  ``TrainLoader`` keeps
prepared samples in RAM, tightens the gt capacity to the dataset
(``input.auto_gt_cap``), stages a fine-tune-sized dataset on the device
(``device_dataset``) and yields index batches in the JAX loader's order for
the same seed (``index_batches``).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from uwcv_tpu_torch.config import Config
from uwcv_tpu_torch.data.imageio import decode_image, sniff_format
from uwcv_tpu_torch.data.rasterize import polygons_to_mask
from uwcv_tpu_torch.utils.image import host_resize


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


# ---------------------------------------------------------------- training

def prepare_train_sample(record: Dict, cfg: Config,
                         n_max: Optional[int] = None) -> Dict[str, np.ndarray]:
    """One dataset dict → a fixed-shape numpy sample at the train size:
    boxes and polygons scaled by (out/in) per axis and clipped, masks
    rasterized at the output size, crowd and empty instances dropped
    (loader.py:70-132).  ``n_max`` overrides the padded gt capacity."""
    s_h, s_w = cfg.input.train_size
    img = load_image_rgb(record["file_name"])
    in_h, in_w = img.shape[:2]
    if (in_h, in_w) != (s_h, s_w):
        img = host_resize(img, s_h, s_w)
    sx, sy = s_w / in_w, s_h / in_h

    n_max = n_max if n_max is not None else cfg.input.max_gt_instances
    boxes = np.zeros((n_max, 4), np.float32)
    classes = np.zeros((n_max,), np.int32)
    valid = np.zeros((n_max,), bool)
    masks = np.zeros((n_max, s_h, s_w), bool)
    i = 0
    for ann in record.get("annotations", []):
        if i >= n_max:
            break
        if ann.get("iscrowd", 0):
            continue        # crowd regions are eval-side ignore-matches
        bx = np.asarray(ann["bbox"], np.float64) * [sx, sy, sx, sy]
        bx = np.clip(bx, [0, 0, 0, 0], [s_w, s_h, s_w, s_h])
        if bx[2] - bx[0] <= 1e-3 or bx[3] - bx[1] <= 1e-3:
            continue
        polys = [(np.asarray(p, np.float64).reshape(-1, 2)
                  * [sx, sy]).reshape(-1) for p in ann["segmentation"]]
        m = polygons_to_mask(polys, s_h, s_w)
        if not m.any():
            continue        # empty after the transform
        boxes[i] = bx
        classes[i] = ann["category_id"]
        masks[i] = m
        valid[i] = True
        i += 1
    return {"image": img, "boxes": boxes, "classes": classes, "valid": valid,
            "masks_packed": np.packbits(masks, axis=-1),
            "num_instances": np.int32(i)}


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


# the arrays a training step reads
TRAIN_KEYS = ("image", "boxes", "classes", "valid", "masks_packed")


class TrainLoader:
    """Infinite shuffled loader with threaded decode workers, yielding host
    numpy batches (``start``/``__iter__``/``stop``), or, for a dataset that
    fits on the device, ``device_dataset`` + ``index_batches``.

    Prepared samples (decode → resize → rasterize → pack, deterministic:
    augmentation runs on the device) are cached in RAM up to
    ``data.cache_prepared_mb`` when ``data.cache_prepared`` is on."""

    def __init__(self, dataset: List[Dict], cfg: Config, seed: int = 0,
                 num_workers: Optional[int] = None,
                 process_index: int = 0, process_count: int = 1):
        """``process_index`` / ``process_count``: the rank's share of a
        data-parallel run (``parallel/mesh.py``).  Every process draws the
        same permutation and takes ``order[process_index::process_count]``;
        ``solver.ims_per_batch`` stays the global batch, of which each
        process yields its ``ims_per_batch // process_count`` rows."""
        if not dataset:
            raise ValueError("empty dataset")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} not in "
                             f"[0, {process_count})")
        if len(dataset) < process_count:
            # a process with no sample would spin in _index_stream forever
            raise ValueError(
                f"dataset has {len(dataset)} samples < process_count "
                f"{process_count}: every process needs at least one")
        if process_count > 1 and cfg.solver.ims_per_batch % process_count:
            raise ValueError(
                f"global batch {cfg.solver.ims_per_batch} must divide by "
                f"process_count {process_count}")
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = cfg.solver.ims_per_batch // process_count
        self.process_index = process_index
        self.process_count = process_count
        self.num_workers = max(1, num_workers if num_workers is not None
                               else cfg.data.num_workers)
        # dataset-tightened gt capacity: the most annotations of a record,
        # rounded up to 8, at most the config's cap
        self.n_max = cfg.input.max_gt_instances
        if cfg.input.auto_gt_cap:
            observed = max(len(r.get("annotations", [])) for r in dataset)
            self.n_max = min(self.n_max, max(8, -(-observed // 8) * 8))
        self.rng = np.random.default_rng(seed)
        # one index stream for index_batches and the workers
        self._indices = self._index_stream()
        self._idx_lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.data.prefetch_depth)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._cache_lock = threading.Lock()
        self._cache_bytes = 0
        self._cache_budget = (int(cfg.data.cache_prepared_mb) * (1 << 20)
                              if cfg.data.cache_prepared else 0)

    def _prepared(self, idx: int) -> Dict[str, np.ndarray]:
        """prepare_train_sample through the RAM cache, which keeps only the
        ``num_instances`` mask rows (the rest re-pad for free)."""
        if self._cache_budget <= 0:
            return prepare_train_sample(self.dataset[idx], self.cfg,
                                        n_max=self.n_max)
        with self._cache_lock:
            hit = self._cache.get(idx)
        if hit is not None:
            full = dict(hit)
            mp = hit["masks_packed"]
            full["masks_packed"] = np.zeros((self.n_max,) + mp.shape[1:],
                                            mp.dtype)
            full["masks_packed"][:mp.shape[0]] = mp
            return full
        sample = prepare_train_sample(self.dataset[idx], self.cfg,
                                      n_max=self.n_max)
        compact = dict(sample)
        compact["masks_packed"] = sample["masks_packed"][
            :int(sample["num_instances"])].copy()
        nb = sum(int(np.asarray(v).nbytes) for v in compact.values())
        with self._cache_lock:
            if idx not in self._cache \
                    and self._cache_bytes + nb <= self._cache_budget:
                self._cache[idx] = compact
                self._cache_bytes += nb
        return sample

    def _index_stream(self) -> Iterator[int]:
        while True:
            order = self.rng.permutation(len(self.dataset))
            for idx in order[self.process_index::self.process_count]:
                yield int(idx)

    def _next_batch_indices(self) -> List[int]:
        with self._idx_lock:
            return [next(self._indices) for _ in range(self.batch_size)]

    def skip(self, n_batches: int) -> None:
        """Advance the index stream past ``n_batches`` batches: a run
        resumed at step n then sees the batches an uninterrupted run
        sees from step n on."""
        for _ in range(n_batches):
            self._next_batch_indices()

    def device_dataset(self, device):
        """Prepare every record once, stack, and place the arrays on
        ``device``: {image [N,S,S,3] uint8, boxes, classes, valid,
        masks_packed}.  None when they exceed ``data.device_dataset_mb``
        (the caller then streams).  A step then ships one [B] index vector
        instead of its batch."""
        import torch

        budget = self.cfg.data.device_dataset_mb
        if budget <= 0:
            return None
        samples = [self._prepared(i) for i in range(len(self.dataset))]
        stacked = {k: np.stack([s[k] for s in samples]) for k in TRAIN_KEYS}
        if sum(v.nbytes for v in stacked.values()) > budget * (1 << 20):
            return None
        return {k: torch.from_numpy(v).to(device) for k, v in stacked.items()}

    def index_batches(self) -> Iterator[np.ndarray]:
        """Infinite [batch_size] int32 index batches, in the order of the
        streaming path (the same index stream)."""
        while True:
            yield np.array(self._next_batch_indices(), np.int32)

    def start(self) -> "TrainLoader":
        def worker():
            while not self._stop.is_set():
                batch = collate([self._prepared(i)
                                 for i in self._next_batch_indices()])
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue

        for _ in range(self.num_workers):
            t = threading.Thread(target=worker, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def __iter__(self):
        if not self._threads:
            self.start()
        while True:
            yield self._q.get()

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()
        while not self._q.empty():
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
