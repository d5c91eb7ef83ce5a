"""ctypes wrappers of the port's host C++ (``csrc/host/uwcv_native.cpp``).

The port's counterpart of ``uwcv_tpu/utils/native.py``, with one rule that
differs: the library is built at first use by ``uwcv_tpu_torch.kernels``
(``g++`` into ``build/uwcv_tpu_torch/<hash>/``), and a failed build raises
instead of falling back to numpy.  The numpy versions live beside their
callers as plain versions for the tests (``measure/rle.py``,
``measure/contours.py``, ``data/imageio.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from uwcv_tpu_torch import kernels


def _lib():
    return kernels.library("uwcv_native")


def rle_encode_fortran(mask: np.ndarray) -> List[int]:
    """[H, W] mask → Fortran-order 1-indexed flat [start, length, ...]."""
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    h, w = m.shape
    cap = m.size // 2 + 2          # at most one run per two pixels
    out = np.empty(cap * 2, np.int64)
    n = _lib().rle_encode_f(m.ctypes.data, h, w, out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("rle_encode_f: run capacity exceeded")
    return out[: n * 2].tolist()


def label_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """8-connected labels [H, W] int32 (0 = background, 1..n in raster
    order of each component's first pixel) and n."""
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    h, w = m.shape
    labels = np.zeros((h, w), np.int32)
    n = _lib().label_components(m.ctypes.data, h, w, labels.ctypes.data)
    return labels, int(n)


def moore_trace(labels: np.ndarray, comp: int) -> np.ndarray:
    """Clockwise boundary of component ``comp`` → [K, 2] float64 (x, y)."""
    lab = np.ascontiguousarray(labels, dtype=np.int32)
    h, w = lab.shape
    cap = 4 * (h + w) + 16
    while True:
        out = np.empty(cap * 2, np.int32)
        n = _lib().moore_trace(lab.ctypes.data, h, w, comp, out.ctypes.data,
                               cap)
        if n >= 0:
            return out[: n * 2].reshape(-1, 2).astype(np.float64)
        cap *= 4       # a boundary visits each pixel at most 8 times


def tiff_lzw_decode(data: bytes, n_out: int) -> np.ndarray:
    """One LZW-compressed TIFF strip → its first ``n_out`` decoded bytes."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(n_out, np.uint8)
    n = _lib().tiff_lzw_decode(src.ctypes.data, src.size, out.ctypes.data,
                               n_out)
    if n < 0:
        raise ValueError("malformed LZW data in a TIFF strip")
    if n < n_out:
        raise ValueError(f"LZW strip decodes to {n} bytes, expected {n_out}")
    return out


def png_unfilter(data: np.ndarray, h: int, stride: int, bpp: int
                 ) -> np.ndarray:
    """Inflated PNG scanlines (``h`` rows of a filter byte + ``stride``
    bytes) → the unfiltered [h, stride] uint8 rows."""
    src = np.ascontiguousarray(data, dtype=np.uint8)
    if src.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {src.size} bytes, expected "
                         f"{h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    if _lib().png_unfilter(src.ctypes.data, h, stride, bpp,
                           out.ctypes.data) != 0:
        raise ValueError("PNG row with an unknown filter type")
    return out
