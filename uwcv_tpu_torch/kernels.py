"""Build and load the port's hand-written CUDA kernels and its host C++.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``; each ``csrc/host/<name>.cpp`` (the
folder path's host loops: RLE, contours, LZW, PNG unfiltering) is compiled
by ``g++`` the same way.  Libraries live under ``build/uwcv_tpu_torch/<hash>/``
next to the package, keyed by a hash of the source, of every shared header
``csrc/*.cuh`` (CUDA sources only) and of the flags, so a fresh checkout
builds them at first use and an edit of either rebuilds them.
No ``--use_fast_math``: the NMS kernel's IoU must round exactly as the
plain PyTorch version does.

Nothing here runs at import: the CPU tests import every module of the port
on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "uwcv_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
# C entry points of each CUDA source: name → argtypes (every one returns
# the cudaError_t of its launch as an int)
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "roi_align": {
        # canvas, slab, y0, x0, wy, wx, tasks and weights scratch, out,
        # R, P, H, W, C, window, stream
        "uwcv_roi_align_windows_f32": (_P,) * 9 + (_I,) * 6 + (_P,),
        "uwcv_roi_align_windows_bf16": (_P,) * 9 + (_I,) * 6 + (_P,),
    },
    "roi_align_bwd": {
        # g, slab, y0, x0, wy, wx, tasks and weights scratch, canvas
        # gradient, R, P, S, H, W, C, window, stream
        "uwcv_roi_align_windows_bwd_f32": (_P,) * 9 + (_I,) * 7 + (_P,),
        "uwcv_roi_align_windows_bwd_bf16": (_P,) * 9 + (_I,) * 7 + (_P,),
    },
    "nms": {
        # boxes, valid, keep, mask scratch, P, N, threshold, stream
        "uwcv_nms_greedy": (_P, _P, _P, _P, _I, _I, _F, _P),
    },
    "mask_tail": {
        # masks, geo, keep, scores, out_sizes, counts and owner scratch,
        # packed, keep_out, B, D, M, H, W, min_pixels, overlaps, bf16,
        # stream
        "uwcv_paste_claim_pack": (_P,) * 9 + (_I,) * 8 + (_P,),
    },
    "frozen_bn": {
        # x, residual, scale, bias, residual scale and bias, out, vectors,
        # channel vectors a pixel, residual mode, bf16, stream
        "uwcv_frozen_bn_act": (_P,) * 7 + (_I,) * 4 + (_P,),
    },
}
# C entry points of each host source: name → (restype, argtypes)
HOST_SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "uwcv_native": {
        "rle_encode_f": (_I64, (_P, _I64, _I64, _P, _I64)),
        "label_components": (_I32, (_P, _I64, _I64, _P)),
        "moore_trace": (_I64, (_P, _I64, _I64, _I32, _P, _I64)),
        "tiff_lzw_decode": (_I64, (_P, _I64, _P, _I64)),
        "png_unfilter": (_I32, (_P, _I64, _I64, _I64, _P)),
    },
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name → {"seconds": build time (0 when cached), "ptxas": compiler report}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of uwcv_tpu_torch "
                           "are built from csrc/ at first use")
    return path


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the host C++ of uwcv_tpu_torch "
                           "(csrc/host/) is built at first use")
    return path


def _source(name: str):
    """(source path, the shared headers hashed with it, whether it is host
    C++)."""
    if name in HOST_SIGNATURES:
        return os.path.join(CSRC_DIR, "host", f"{name}.cpp"), [], True
    return (os.path.join(CSRC_DIR, f"{name}.cu"),
            sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))), False)


def _lib_path(name: str) -> str:
    """Build path keyed by the source, its shared headers and the flags."""
    src, headers, host = _source(name)
    h = hashlib.sha256()
    for path in [src] + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(GXX_FLAGS if host else NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], f"lib{name}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named sources (all CUDA and host sources by default) that
    are not built yet, one compiler process per source, all started
    together.  Raises with the compiler's output when a build fails."""
    names = list(names or (*SIGNATURES, *HOST_SIGNATURES))
    pending = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            build_info.setdefault(name, {"seconds": 0.0, "ptxas": "",
                                         "path": out})
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        src, _, host = _source(name)
        compiler = [_gxx(), *GXX_FLAGS] if host else [_nvcc(), *NVCC_FLAGS]
        cmd = compiler + ["-o", tmp, src]
        pending[name] = (out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (out, tmp, t0, proc) in pending.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"build failed for "
                          f"{os.path.relpath(proc.args[-1], CSRC_DIR)}:\n{log}")
            continue
        os.replace(tmp, out)
        build_info[name] = {"seconds": time.perf_counter() - t0,
                            "ptxas": log, "path": out}
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: build_info[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``csrc/host/<name>.cpp``,
    built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(build_info[name]["path"])
            if name in HOST_SIGNATURES:
                entries = HOST_SIGNATURES[name].items()
            else:
                entries = ((fn, (ctypes.c_int, args))
                           for fn, args in SIGNATURES[name].items())
            for fn, (restype, argtypes) in entries:
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``: the threads of a mesh predictor
    launch concurrently, and ``+=`` on an attribute is not atomic."""
    with _count_lock:
        wrapper.launches += 1


def launch_counts() -> Dict[str, int]:
    """This process's kernel launches so far, by wrapper (the counters are
    per process)."""
    from uwcv_tpu_torch.ops.frozen_bn import frozen_bn_act
    from uwcv_tpu_torch.ops.mask_paste import paste_claim_pack
    from uwcv_tpu_torch.ops.nms import nms_greedy
    from uwcv_tpu_torch.ops.roi_align import (
        roi_align_windows,
        roi_align_windows_backward,
    )

    return {f.__name__: f.launches for f in (
        roi_align_windows, roi_align_windows_backward, nms_greedy,
        paste_claim_pack, frozen_bn_act)}


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
