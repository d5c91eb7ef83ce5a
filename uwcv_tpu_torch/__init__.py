"""uwcv_tpu_torch — the PyTorch/CUDA port of ``uwcv_tpu`` for NVIDIA Hopper.

The JAX package ``uwcv_tpu`` stays the reference; this package mirrors its
module names (``models/rcnn.py``, ``ops/roi_align.py``, ...) so each
counterpart is easy to find.  It imports ``torch`` and never ``jax`` or
anything from ``uwcv_tpu``.

The two Pallas TPU kernels are hand-written CUDA C++ kernels here
(``csrc/``), built with ``nvcc`` at first use (``uwcv_tpu_torch/kernels.py``):
the fused windowed RoIAlign (``ops/roi_align.py::roi_align_windows``) and
the greedy NMS (``ops/nms.py::nms_greedy``); so is RoIAlign's backward
(``ops/roi_align.py::roi_align_windows_backward``), which training pools
through.  Each wrapper runs its plain PyTorch version only for CPU
tensors; on a CUDA tensor it launches the kernel or raises.  The two
inference kernels are ``torch.library`` ops (``uwcv::roi_align_windows``,
``uwcv::nms_greedy``), so an exported program (``engine/export.py``) keeps
calling them.
"""

__version__ = "0.1.0"
