"""IoU matcher + fixed-size balanced subsampler (port of
``uwcv_tpu/ops/matcher.py``).

- ``match``: [..., A anchors/proposals × G padded gt] IoU → labels (1 fg,
  0 bg, -1 ignore) and the matched gt index; padded gt never match.
  ``allow_low_quality`` (RPN) forces every gt's best anchors to fg,
  all ties included (Detectron2's set_low_quality_matches_).
- ``subsample_labels``: exactly ``num_samples`` picks, positives first,
  through random priorities and a stable top-k, so every step has the same
  shapes.

Every function takes a leading batch of problems.  The random numbers come
from ``sampler_uniforms`` (a ``torch.Generator``) or from the caller, so a
test can hand both packages the same draws: ``jax.random`` and torch give
different numbers from one seed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from uwcv_tpu_torch.ops.nms import topk_stable
from uwcv_tpu_torch.structures.boxes import box_iou

# the weighted (Gumbel) draw's floor, jax.random.uniform(minval=1e-20)
_WEIGHTED_MIN = 1e-20


class MatchResult(NamedTuple):
    matched_idx: torch.Tensor   # [..., A] int64, index of the matched gt (0 if none)
    labels: torch.Tensor        # [..., A] int64, 1 fg / 0 bg / -1 ignore


def match(iou: torch.Tensor, gt_valid: torch.Tensor, fg_threshold: float,
          bg_threshold: float, allow_low_quality: bool = False) -> MatchResult:
    """iou [..., A, G] (rows anchors, columns gt), gt_valid [..., G] bool."""
    iou = torch.where(gt_valid[..., None, :], iou, torch.full_like(iou, -1.0))
    matched_vals = iou.amax(dim=-1)
    # argmax takes the first maximum, as jnp.argmax does
    matched_idx = iou.argmax(dim=-1)
    one, zero = torch.ones_like(matched_idx), torch.zeros_like(matched_idx)
    labels = torch.where(matched_vals >= fg_threshold, one,
                         torch.where(matched_vals < bg_threshold, zero, -one))
    if allow_low_quality:
        # for each valid gt, every anchor achieving its max IoU becomes fg
        best_per_gt = iou.amax(dim=-2)                          # [..., G]
        is_best = ((iou == best_per_gt[..., None, :])
                   & gt_valid[..., None, :] & (best_per_gt[..., None, :] > 0))
        force_fg = is_best.any(dim=-1)
        labels = torch.where(force_fg, one, labels)
        # torch.argmax rejects bool: cast first (matcher.py:53)
        forced_idx = is_best.to(torch.uint8).argmax(dim=-1)
        matched_idx = torch.where(force_fg & (matched_vals < fg_threshold),
                                  forced_idx, matched_idx)
    # anchors matched to nothing valid are background
    labels = torch.where(matched_vals < 0, zero, labels)
    return MatchResult(matched_idx, labels)


def match_boxes(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                gt_valid: torch.Tensor, fg_threshold: float,
                bg_threshold: float, allow_low_quality: bool = False
                ) -> MatchResult:
    """anchors [..., A, 4] (broadcast over the batch), gt_boxes [..., G, 4]."""
    return match(box_iou(anchors, gt_boxes), gt_valid, fg_threshold,
                 bg_threshold, allow_low_quality)


def sampler_uniforms(shape, weighted: bool, generator: Optional[torch.Generator],
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two uniform draws ``subsample_labels`` consumes: (for the
    positive priorities, for the negative ones), each [*shape] f32 in
    [0, 1); the positive draw is floored at 1e-20 when ``weighted`` (its
    Gumbel transform takes two logs)."""
    u_pos = torch.rand(shape, generator=generator, device=device)
    u_neg = torch.rand(shape, generator=generator, device=device)
    if weighted:
        u_pos = u_pos.clamp_min(_WEIGHTED_MIN)
    return u_pos, u_neg


def subsample_labels(labels: torch.Tensor, num_samples: int,
                     positive_fraction: float, u_pos: torch.Tensor,
                     u_neg: torch.Tensor,
                     fg_weights: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A fixed-size balanced sample of labels [..., N]: up to
    num_samples·positive_fraction positives (random among fg), the rest
    backgrounds (random among bg); slots beyond what is available repeat
    the first pick.  ``fg_weights`` [..., N] weights the positive draw
    without replacement (Gumbel top-k: priority = log w + Gumbel noise;
    weight ≤ 0 excludes).  ``u_pos``/``u_neg`` [..., N] are the uniform
    draws (``sampler_uniforms``).  → (idx [..., num_samples] int64,
    is_positive [..., num_samples] bool)."""
    n = labels.shape[-1]
    max_pos = int(num_samples * positive_fraction)
    is_fg = labels == 1
    is_bg = labels == 0
    neg_inf = torch.full_like(u_pos, -torch.inf)
    if fg_weights is None:
        pos_prio = torch.where(is_fg, u_pos, neg_inf)
    else:
        gumbel = -torch.log(-torch.log(u_pos))
        logw = torch.log(fg_weights.float().clamp_min(_WEIGHTED_MIN))
        pos_prio = torch.where(is_fg & (fg_weights > 0), logw + gumbel, neg_inf)
    neg_prio = torch.where(is_bg, u_neg, neg_inf)

    pos_vals, pos_idx = topk_stable(pos_prio, min(max_pos, n))
    pos_take = pos_vals > -torch.inf
    num_pos = pos_take.sum(dim=-1, keepdim=True)
    k_neg = min(num_samples, n)
    neg_vals, neg_idx = topk_stable(neg_prio, k_neg)
    neg_rank = torch.arange(k_neg, device=labels.device)
    neg_take = (neg_vals > -torch.inf) & (neg_rank < num_samples - num_pos)

    # positives first, then negatives; stable-compact the taken ones
    all_idx = torch.cat([pos_idx, neg_idx], dim=-1)
    all_take = torch.cat([pos_take, neg_take], dim=-1)
    all_pos = torch.cat([torch.ones_like(pos_take),
                         torch.zeros_like(neg_take)], dim=-1)
    order = torch.sort((~all_take).to(torch.uint8), dim=-1,
                       stable=True).indices[..., :num_samples]
    idx = torch.gather(all_idx, -1, order)
    taken = torch.gather(all_take, -1, order)
    is_pos = torch.gather(all_pos, -1, order) & taken
    # the untaken tail repeats the first pick
    idx = torch.where(taken, idx, idx[..., :1])
    return idx, is_pos
