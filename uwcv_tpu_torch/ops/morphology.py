"""Binary mask morphology on [..., H, W] stacks (port of
``uwcv_tpu/ops/morphology.py``).

- dilate/erode: cross (4-connected, skimage's default footprint) or full
  3×3 max/min pooling; pooling pads with the identity of the reduction, so
  erosion does not eat in from the border (skimage ``border_value=1``);
- fill_holes: flood the background from the border with 4-connected
  dilation constrained to ~mask (scipy ``binary_fill_holes``);
- connected components: 8-connected label-min propagation.

The floods are loops (the JAX ``lax.while_loop``s of morphology.py:103-112
and :133-145) whose carry holds the state and a changed flag: under
``torch.export`` a ``while_loop``, which the exported program keeps as a
loop; run eagerly, the same condition and body in a Python loop that reads
the flag on the host once a pass.  The converged state is the loop's fixed
point, so the result equals the JAX package's whatever the iteration
count, and a whole batch of masks converges in one loop.  At head
resolution (28×28) each pass is cheap.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# public as torch.while_loop on recent releases only
from torch._higher_order_ops.while_loop import while_loop


def _max_pool(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """Windowed max over the last two dims of a float [..., H, W] stack,
    padded with -inf (the identity of max)."""
    lead = x.shape[:-2]
    y = F.max_pool2d(x.reshape((-1, 1) + x.shape[-2:]), window, stride=1,
                     padding=(window[0] // 2, window[1] // 2))
    return y.reshape(lead + y.shape[-2:])


def _pool(x: torch.Tensor, op: str, window: Tuple[int, int]) -> torch.Tensor:
    return _max_pool(x, window) if op == "max" else -_max_pool(-x, window)


def _pool_cross(x: torch.Tensor, op: str) -> torch.Tensor:
    """Cross-shaped (4-connected) max/min: N/S/E/W neighbours + centre."""
    comb = torch.maximum if op == "max" else torch.minimum
    return comb(_pool(x, op, (3, 1)), _pool(x, op, (1, 3)))


def dilate(mask: torch.Tensor, connectivity: int = 1) -> torch.Tensor:
    """Binary dilation of bool [..., H, W]; connectivity 1 = cross, 2 = 3×3."""
    x = mask.float()
    y = _pool_cross(x, "max") if connectivity == 1 else _pool(x, "max", (3, 3))
    return y > 0.5


def erode(mask: torch.Tensor, connectivity: int = 1) -> torch.Tensor:
    """Binary erosion of bool [..., H, W] (footprint as in :func:`dilate`)."""
    x = mask.float()
    y = _pool_cross(x, "min") if connectivity == 1 else _pool(x, "min", (3, 3))
    return y > 0.5


def close_open_smooth(mask: torch.Tensor) -> torch.Tensor:
    """erosion(dilation(mask)) — the reference's smoothing."""
    return erode(dilate(mask))


def _loop(cond_fn, body_fn, carry):
    """``while_loop(cond_fn, body_fn, carry)``.  Eagerly it runs as a Python
    loop: torch's eager ``while_loop`` would first compile the body with
    dynamo, and again for each new shape."""
    if torch.compiler.is_exporting():
        return while_loop(cond_fn, body_fn, carry)
    while cond_fn(*carry):
        carry = body_fn(*carry)
    return carry


def _changed(state, changed):
    """The floods' loop condition: the last pass changed the state (a
    copy: a loop's condition may not return one of its inputs)."""
    return changed.clone()


def _true(like: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.bool, device=like.device)


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """``scipy.ndimage.binary_fill_holes`` for bool [..., H, W] stacks:
    background unreachable from the border through 4-connected background
    is a hole and gets filled."""
    inv = ~mask
    border = torch.zeros_like(mask)
    border[..., 0, :] = True
    border[..., -1, :] = True
    border[..., :, 0] = True
    border[..., :, -1] = True

    def body(flood, _):
        new = dilate(flood, connectivity=1) & inv
        return new, (new != flood).any()

    flood, _ = _loop(_changed, body, (border & inv, _true(mask)))
    return mask | (~flood & inv)


def connected_components(mask: torch.Tensor) -> torch.Tensor:
    """Label the 8-connected components of each bool [..., H, W] mask →
    int64 labels (0 = background; a component carries the minimum seed id
    of its pixels).  Labels are < H·W + 3, exact in the float32 pooling
    used for the min-propagation."""
    h, w = mask.shape[-2:]
    seeds = torch.arange(1, h * w + 1, device=mask.device,
                         dtype=torch.float32).reshape(h, w)
    big = float(h * w + 2)
    labels = torch.where(mask, seeds, torch.full_like(seeds, big))

    def body(labels, _):
        prop = _pool(labels, "min", (3, 3))
        new = torch.where(mask, torch.minimum(labels, prop), labels)
        return new, (new != labels).any()

    labels, _ = _loop(_changed, body, (labels, _true(mask)))
    return torch.where(mask, labels, torch.zeros_like(labels)).to(torch.int64)


def count_components(mask: torch.Tensor) -> torch.Tensor:
    """Number of 8-connected components of each [..., H, W] mask: pixels
    whose label equals their own seed id are the roots."""
    h, w = mask.shape[-2:]
    labels = connected_components(mask)
    seeds = torch.arange(1, h * w + 1, device=mask.device).reshape(h, w)
    return (mask & (labels == seeds)).sum(dim=(-2, -1))


def remove_overlaps(masks: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Zero pixels already claimed by higher-priority masks.

    masks [..., N, H, W] bool; order [..., N] priority ranking (order[0] is
    the first painter).  Each pixel goes to the best-ranked mask covering
    it, identical to the sequential first-painter scan."""
    n = masks.shape[-3]
    ranks = torch.arange(n, device=masks.device).expand_as(order)
    inv = torch.empty_like(order).scatter_(-1, order, ranks)   # rank per mask
    rank_dtype = torch.uint8 if n < 255 else torch.int32
    eff = torch.where(masks, inv.to(rank_dtype)[..., None, None],
                      torch.tensor(n, dtype=rank_dtype, device=masks.device))
    winner = eff.amin(dim=-3, keepdim=True)
    return masks & (eff == winner)


def clean_head_masks(probs: torch.Tensor, threshold: float = 0.5,
                     do_fill_holes: bool = True, do_smooth: bool = True,
                     drop_fragmented: bool = True):
    """Mask cleanup at head resolution: probs [..., M, M] float →
    (cleaned [..., M, M] bool, single_component [...] bool)."""
    m = probs > threshold
    if do_fill_holes:
        m = fill_holes(m)
    if do_smooth:
        m = close_open_smooth(m)
    single = torch.ones(m.shape[:-2], dtype=torch.bool, device=m.device)
    if drop_fragmented:
        single = count_components(m) <= 1
        m = m & single[..., None, None]
    return m, single
