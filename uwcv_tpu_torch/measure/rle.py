"""Run-length-encoding codecs (port of ``uwcv_tpu/measure/rle.py``).

(a) ``binary_mask_to_rle``: COCO uncompressed dict {counts, size},
    Fortran-order run lengths starting with a zero-run;
(b) ``rle_encode``: C-order 1-indexed "start length ..." string;
(c) ``rle_encoding``: Fortran-order 1-indexed start/length list — the
    variant the reference exports to its CSV; the port's host C++ encodes
    it (``utils/native.py``), ``rle_encoding_reference`` is its plain
    numpy version;
(d) ``rle_decode``: inverse of (c)/(b) given the order.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

from uwcv_tpu_torch.utils import native


def _runs(flat: np.ndarray):
    """Start indices (0-based) and lengths of the nonzero runs of a flat
    array (binarized first: a 0/255 mask cast to int8 would wrap)."""
    padded = np.concatenate([[0], (flat != 0).astype(np.int8), [0]])
    diff = np.diff(padded)
    starts = np.flatnonzero(diff == 1)
    ends = np.flatnonzero(diff == -1)
    return starts, ends - starts


def binary_mask_to_rle(mask: np.ndarray) -> Dict:
    """COCO uncompressed RLE: counts alternate 0-runs/1-runs, column-major."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    n = flat.size
    starts, lengths = _runs(flat)
    counts: List[int] = []
    prev_end = 0
    for s, l in zip(starts, lengths):
        counts.append(int(s - prev_end))   # zero run (0 for a leading 1-run)
        counts.append(int(l))
        prev_end = s + l
    counts.append(int(n - prev_end))
    if counts and counts[-1] == 0:
        counts.pop()
    return {"counts": counts, "size": list(mask.shape)}


def rle_from_coco(rle: Dict) -> np.ndarray:
    """Inverse of binary_mask_to_rle."""
    h, w = rle["size"]
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in rle["counts"]:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F").astype(bool)


def rle_encode(mask: np.ndarray) -> str:
    """C-order 1-indexed 'start length' pairs string."""
    flat = np.asarray(mask, np.uint8).flatten(order="C")
    starts, lengths = _runs(flat)
    return " ".join(f"{s + 1} {l}" for s, l in zip(starts, lengths))


def rle_encoding_reference(mask: np.ndarray) -> List[int]:
    """Plain numpy version of :func:`rle_encoding`."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    starts, lengths = _runs(flat)
    out: List[int] = []
    for s, l in zip(starts, lengths):
        out.extend((int(s + 1), int(l)))
    return out


def rle_encoding(mask: np.ndarray) -> List[int]:
    """Fortran-order 1-indexed flat [start, length, ...] list of a 2-D mask
    — the format of the reference's EncodedPixels CSV column — encoded in
    one pass by the host C++ (no transposed copy)."""
    if mask.ndim != 2:
        return rle_encoding_reference(mask)
    return native.rle_encode_fortran(mask)


def rle_decode(
    rle: Union[str, List[int]],
    shape,
    order: str = "F",
) -> np.ndarray:
    """'start length ...' string or flat list → bool mask of ``shape``."""
    if isinstance(rle, str):
        vals = [int(x) for x in rle.split()]
    else:
        vals = [int(x) for x in rle]
    starts = np.asarray(vals[0::2], np.int64) - 1
    lengths = np.asarray(vals[1::2], np.int64)
    flat = np.zeros(int(np.prod(shape)), np.uint8)
    for s, l in zip(starts, lengths):
        flat[s:s + l] = 1
    return flat.reshape(shape, order=order).astype(bool)
