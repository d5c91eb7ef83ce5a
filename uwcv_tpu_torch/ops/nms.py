"""Fixed-shape non-maximum suppression (port of ``uwcv_tpu/ops/nms.py``).

NMS works on padded [N] box sets (invalid entries carry score NEG_INF) and
returns a fixed-size keep *mask*.  The greedy walk itself is the CUDA code
``csrc/nms.cu`` (the port of the Pallas kernel
``uwcv_tpu/ops/pallas/nms_kernel.py``): one call, two kernels (suppression
bits, then a scan), for a whole batch of problems through
``nms_mask_batched``.  The call is the ``torch.library`` op
``uwcv::nms_greedy``, which an exported program records and makes again.
"""

from __future__ import annotations

import torch

from uwcv_tpu_torch import kernels
from uwcv_tpu_torch.structures.boxes import box_iou

NEG_INF = -1e10
# the scan warp holds ceil(N/64) ≤ 128 words of `removed`, 4 a lane
NMS_MAX_N = 8192


def nms_greedy_reference(boxes_sorted: torch.Tensor, valid: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch greedy NMS: boxes_sorted [P,N,4] f32 (descending score
    within each problem), valid [P,N] bool → keep [P,N] bool.  Box j > i is
    cleared when i is still kept and IoU(i, j) > threshold."""
    n = boxes_sorted.shape[1]
    suppress = box_iou(boxes_sorted, boxes_sorted) > iou_threshold  # [P,N,N]
    later = torch.ones(n, n, dtype=torch.bool,
                       device=boxes_sorted.device).triu_(1)
    suppress &= later
    keep = valid.clone()
    for i in range(n):
        keep &= ~(suppress[:, i, :] & keep[:, i:i + 1])
    return keep


def nms_greedy(boxes_sorted: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over P independent problems of N score-sorted boxes:
    boxes_sorted [P,N,4] f32, valid [P,N] bool → keep [P,N] bool.

    Calls the op ``uwcv::nms_greedy``, so ``torch.export`` records the
    kernel call and an exported program makes it again.  CPU tensors take
    the plain version; CUDA tensors launch the kernels (a suppression bit
    matrix over all SMs, then one warp scan per problem) or raise."""
    return torch.ops.uwcv.nms_greedy(boxes_sorted, valid, float(iou_threshold))


nms_greedy.launches = 0   # kernel launches, counted by the op

# defined and implemented directly, as ``ops/roi_align.py``'s op is
torch.library.define(
    "uwcv::nms_greedy",
    "(Tensor boxes_sorted, Tensor valid, float iou_threshold) -> Tensor")


@torch.library.impl("uwcv::nms_greedy", "default")
def _nms_greedy_op(boxes_sorted, valid, iou_threshold):
    if boxes_sorted.device.type == "cpu":
        return nms_greedy_reference(boxes_sorted, valid, iou_threshold)
    p, n = valid.shape
    if boxes_sorted.shape != (p, n, 4) or boxes_sorted.dtype != torch.float32:
        raise ValueError(f"boxes_sorted must be [P,N,4] float32, got "
                         f"{tuple(boxes_sorted.shape)} {boxes_sorted.dtype}")
    if valid.dtype != torch.bool or valid.device != boxes_sorted.device:
        raise ValueError("valid must be a bool tensor on the boxes' device")
    if n > NMS_MAX_N:
        raise ValueError(f"nms_greedy supports N <= {NMS_MAX_N}, got {n}")
    if p > 65535:
        raise ValueError(f"nms_greedy supports at most 65535 problems, got {p}")
    boxes_sorted = boxes_sorted.contiguous()
    valid = valid.contiguous()
    keep = torch.empty_like(valid)
    if p == 0 or n == 0:
        return keep
    # suppression bits [P, N, ceil(N/64)]: word k of row i covers j in
    # [64k, 64k+64); the scan reads only words at or right of the diagonal
    mask = torch.empty((p, n, (n + 63) // 64), dtype=torch.int64,
                       device=boxes_sorted.device)
    lib = kernels.library("nms")
    with torch.cuda.device(boxes_sorted.device):
        rc = lib.uwcv_nms_greedy(boxes_sorted.data_ptr(), valid.data_ptr(),
                                 keep.data_ptr(), mask.data_ptr(), p, n,
                                 float(iou_threshold),
                                 kernels.stream_ptr(boxes_sorted.device))
    kernels.check(rc, "nms_greedy")
    kernels.count_launch(nms_greedy)
    return keep


@torch.library.register_fake("uwcv::nms_greedy")
def _(boxes_sorted, valid, iou_threshold):
    return torch.empty_like(valid)


def _argsort_desc(scores: torch.Tensor) -> torch.Tensor:
    """Descending order with ties broken by the lower index, along the last
    axis.  Parity trap: ``torch.topk`` (and an unstable sort) on CUDA do not
    promise an order among ties, while ``jnp.argsort(-s, stable=True)`` and
    ``lax.top_k`` put the lower index first — and the NEG_INF padding slots
    are ties by construction.  Sorting the negated scores stably is exactly
    the JAX formulation."""
    return torch.sort(-scores, dim=-1, stable=True).indices


def topk_stable(scores: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: (values, indices), ties to the
    lower index."""
    idx = _argsort_desc(scores)[..., :k]
    return torch.gather(scores, -1, idx), idx


def nms_mask_batched(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """Exact greedy NMS over P padded problems in ONE ``nms_greedy`` call.

    boxes [P,N,4], scores [P,N] (padding = NEG_INF scores) → keep [P,N]
    bool in the original order.  Greedy order = descending score, ties
    broken by lower index.  Problems of unequal size are padded to a common
    N with NEG_INF scores by the caller; padded slots never suppress."""
    order = _argsort_desc(scores)                             # nms.py:79
    boxes_sorted = torch.gather(
        boxes, 1, order[..., None].expand(-1, -1, 4)).float()
    scores_sorted = torch.gather(scores, 1, order)
    valid = scores_sorted > NEG_INF / 2
    keep_sorted = nms_greedy(boxes_sorted, valid, iou_threshold)
    keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    return keep & (scores > NEG_INF / 2)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Single-problem ``nms_mask``: boxes [N,4], scores [N] → keep [N]."""
    return nms_mask_batched(boxes[None], scores[None], iou_threshold)[0]


def batched_class_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                           classes: torch.Tensor,
                           iou_threshold: float) -> torch.Tensor:
    """Per-class NMS via the coordinate-offset trick (torchvision
    batched_nms), for B images at once: boxes [B,N,4], scores [B,N],
    classes [B,N] → keep [B,N].  Each image's classes are shifted to
    disjoint regions by ``max|boxes| + 1`` of that image, so one pass never
    crosses classes; all B problems share one ``nms_greedy`` call."""
    max_coord = boxes.abs().amax(dim=(1, 2)) + 1.0            # [B]
    offsets = classes.to(boxes.dtype)[..., None] * (max_coord[:, None, None]
                                                    * 2.0)
    return nms_mask_batched(boxes + offsets, scores, iou_threshold)
