"""Windowed multi-level RoIAlign (port of ``uwcv_tpu/ops/roi_align.py``).

Semantics are Detectron2's ``aligned=True`` with a static 2×2 sample grid
per bin and FPN-paper eq. 1 level assignment; rois whose extent would
overflow the window on their level are bumped to a coarser level, up to a
virtual level 6 (the edge-padded, 2×-average-pooled p5), so image-wide
scale bars keep full coverage.

Each roi pools from one ``window``² neighbourhood of a padded level canvas:
``window_geometry`` places the window and folds the 2×2 bin average into
per-roi interpolation weights ``wy``/``wx``, and ``roi_align_windows`` (the
CUDA kernel ``csrc/roi_align.cu``, port of the Pallas kernel
``uwcv_tpu/ops/pallas/roi_align_kernel.py``, called through the
``torch.library`` op ``uwcv::roi_align_windows`` so that an exported
program records and makes the call) contracts each window with them.  The
Mosaic 8-column x alignment of the TPU path is not ported: the window is
``window`` wide in x too (x_align=1), which moves only where the nonzero
weights sit, not the result.

Pooling is differentiable with respect to the canvas (``PoolWindows``, the
port of the ``custom_vjp`` ``pool_windows``): the backward
``roi_align_windows_backward`` (the CUDA kernel ``csrc/roi_align_bwd.cu``,
which replaces the XLA scatter-add ``_pool_windows_bwd``) sums the rois'
back-interpolated window cotangents tile by tile of the canvas gradient,
each tile written once, and ``level_canvas`` passes that gradient back to
the levels through plain autograd.  Rois carry no gradient, as in the JAX
package.

Public functions keep the JAX package's NHWC layout.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from uwcv_tpu_torch import kernels

LEVEL_NAMES = ("p2", "p3", "p4", "p5")
MAX_WINDOW = 32        # largest window side the kernel stages
POOL_SIZES = (7, 14)   # output resolutions the kernel is instantiated for
REF_CHUNK = 512        # rois per step of the plain versions (bounds temps)


def fpn_level_assignment(boxes: torch.Tensor, min_level: int = 2,
                         max_level: int = 5, canonical_size: float = 224.0,
                         canonical_level: int = 4) -> torch.Tensor:
    """FPN paper eq. 1: level = floor(k0 + log2(sqrt(area)/224)), clamped."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0)
    size = torch.sqrt(w * h)
    lvl = torch.floor(canonical_level + torch.log2(
        size.clamp_min(1e-6) / canonical_size))
    return lvl.clamp(min_level, max_level).to(torch.int64)


def _interp_matrix(coords: torch.Tensor, dim: int) -> torch.Tensor:
    """[..., S] continuous coords → [..., S, dim] bilinear weight rows:
    (1-frac) at floor(c) and frac at floor(c)+1, clamped to the border."""
    c = coords.clamp(0.0, dim - 1.0)
    lo = torch.floor(c)
    frac = c - lo
    lo_i = lo.to(torch.int64)
    hi_i = (lo_i + 1).clamp_max(dim - 1)
    cols = torch.arange(dim, device=coords.device)
    return ((cols == lo_i[..., None]) * (1.0 - frac)[..., None]
            + (cols == hi_i[..., None]) * frac[..., None]).float()


def _sample_grid(rois: torch.Tensor, stride: torch.Tensor, output_size: int,
                 samples_per_bin: int):
    """Continuous sample coords in feature space: rois [R,4], stride [R] →
    (xs, ys) each [R, output_size·samples_per_bin]."""
    s = output_size * samples_per_bin
    x1 = rois[:, 0] / stride - 0.5
    y1 = rois[:, 1] / stride - 0.5
    x2 = rois[:, 2] / stride - 0.5
    y2 = rois[:, 3] / stride - 0.5
    t = (torch.arange(s, dtype=torch.float32, device=rois.device) + 0.5) / s
    xs = x1[:, None] + t[None, :] * (x2 - x1).clamp_min(1e-6)[:, None]
    ys = y1[:, None] + t[None, :] * (y2 - y1).clamp_min(1e-6)[:, None]
    return xs, ys


def level_shapes(shapes4: Sequence[Sequence[int]]) -> List[Tuple[int, ...]]:
    """4 level shapes (H, W, C) → 5 (appends the virtual pooled-p5 level)."""
    shapes4 = [tuple(s) for s in shapes4]
    h5, w5, c = shapes4[3]
    return shapes4 + [((h5 + 1) // 2, (w5 + 1) // 2, c)]


def level_strides(strides: Dict[str, int]) -> List[float]:
    return [float(strides[n]) for n in LEVEL_NAMES] + [2.0 * strides["p5"]]


def level_canvas(features: Dict[str, torch.Tensor], window: int):
    """Batched {level: [B,H,W,C]} → ([5B, Hmax, Wmax, C] slab canvas, the 5
    level shapes).  Slab 5b+4 is image b's virtual level 6: p5 edge-padded
    to even size and 2×2-average-pooled (in f32, cast back to the feature
    dtype), so cell j represents position (j+0.5)·2·stride₅."""
    shapes = level_shapes([features[n].shape[1:] for n in LEVEL_NAMES])
    p2 = features["p2"]
    b, c, dtype = p2.shape[0], shapes[0][-1], p2.dtype
    hmax = max(max(s[0] for s in shapes), window)
    wmax = max(max(s[1] for s in shapes), window)
    p5 = features["p5"]
    if p5.shape[1] % 2:
        p5 = torch.cat([p5, p5[:, -1:]], dim=1)
    if p5.shape[2] % 2:
        p5 = torch.cat([p5, p5[:, :, -1:]], dim=2)
    h6, w6 = shapes[4][:2]
    p6v = p5.reshape(b, h6, 2, w6, 2, c).float().mean(dim=(2, 4)).to(dtype)
    canvas = p2.new_zeros((b, 5, hmax, wmax, c))
    for i, f in enumerate([features[n] for n in LEVEL_NAMES] + [p6v]):
        canvas[:, i, :f.shape[1], :f.shape[2]] = f
    return canvas.reshape(b * 5, hmax, wmax, c), shapes


def window_geometry(rois: torch.Tensor, shapes, strides_vals, output_size: int,
                    canonical_size: float, canonical_level: int,
                    samples_per_bin: int, window: int):
    """Per-roi window placement + bin-folded interpolation weights.

    rois [R,4] → (li [R] int64 in 0..4, y0 [R], x0 [R] int64 window origins,
    wy [R,P,window], wx [R,P,window] f32).  Averaging the spb×spb sample
    WEIGHTS equals averaging the samples (interpolation is linear)."""
    levels = fpn_level_assignment(rois, 2, 5, canonical_size, canonical_level)
    # smallest level whose stride fits max(w,h) inside the window
    span_px = torch.maximum(rois[:, 2] - rois[:, 0], rois[:, 3] - rois[:, 1])
    fit = torch.ceil(torch.log2((span_px / (window - 2.0)).clamp_min(1e-6)))
    levels = torch.maximum(levels, fit.to(torch.int64)).clamp(2, 6)
    li = levels - 2
    dev = rois.device
    tbl = lambda vals: torch.tensor(vals, dtype=torch.float32, device=dev)[li]
    level_w = tbl([s[1] for s in shapes])
    level_h = tbl([s[0] for s in shapes])
    xs, ys = _sample_grid(rois, tbl(list(strides_vals)), output_size,
                          samples_per_bin)
    # clamp samples into the level extent (border replication, aligned=True)
    xs = torch.minimum(xs.clamp_min(0.0), level_w[:, None] - 1.0)
    ys = torch.minimum(ys.clamp_min(0.0), level_h[:, None] - 1.0)

    def origin(coords, extent):
        # center the sample span, clamp into the level
        lo = torch.floor((coords[:, 0] + coords[:, -1]) / 2.0
                         - window / 2.0 + 0.5)
        return torch.minimum(lo.clamp_min(0.0),
                             (extent - window).clamp_min(0.0))

    x0 = origin(xs, level_w)
    y0 = origin(ys, level_h)
    xs_rel = (xs - x0[:, None]).clamp(0.0, window - 1.0)
    ys_rel = (ys - y0[:, None]).clamp(0.0, window - 1.0)
    r, p, spb = rois.shape[0], output_size, samples_per_bin
    wy = _interp_matrix(ys_rel, window).reshape(r, p, spb, window).mean(dim=2)
    wx = _interp_matrix(xs_rel, window).reshape(r, p, spb, window).mean(dim=2)
    return li, y0.to(torch.int64), x0.to(torch.int64), wy, wx


def roi_align_windows_reference(canvas, slab, y0, x0, wy, wx) -> torch.Tensor:
    """Plain PyTorch version of the kernel: canvas [S,Hmax,Wmax,C], slab/y0/
    x0 [R] window origins, wy/wx [R,P,win] → [R,P,P,C] in the canvas dtype.
    Both contractions take the feature dtype, and ``rows`` is rounded back
    to it in between, as roi_align.py:79/:371 of the JAX package do."""
    r, p, win = wy.shape
    c = canvas.shape[-1]
    wdt = canvas.dtype
    ar = torch.arange(win, device=canvas.device)
    out = canvas.new_empty((r, p, p, c))
    for s in range(0, r, REF_CHUNK):
        e = min(s + REF_CHUNK, r)
        sl = slab[s:e].long()[:, None, None]
        yy = y0[s:e].long()[:, None, None] + ar[None, :, None]
        xx = x0[s:e].long()[:, None, None] + ar[None, None, :]
        patch = canvas[sl, yy, xx]                           # [r,win,win,C]
        rows = torch.einsum("rph,rhwc->rpwc", wy[s:e].to(wdt), patch)
        out[s:e] = torch.einsum("rqw,rpwc->rpqc", wx[s:e].to(wdt), rows)
    return out


def subwindow_extent(w: torch.Tensor):
    """First index and length of the nonzero extent of [R, P, win] weights
    along ``win`` (the union over P): the rows (of ``wy``) or columns (of
    ``wx``) of each window that the kernel copies.  Pass the weights in the
    canvas dtype, as the kernel tests them.  → (lo [R], n [R]) int64; n = 0
    and lo = 0 when every weight is zero."""
    nz = (w != 0).any(dim=1)                                 # [R, win]
    idx = torch.arange(w.shape[-1], device=w.device)
    lo = torch.where(nz, idx, w.shape[-1]).amin(dim=1)
    hi = torch.where(nz, idx, -1).amax(dim=1)
    n = (hi - lo + 1).clamp_min(0)
    return torch.where(n > 0, lo, 0), n


def roi_align_windows(canvas, slab, y0, x0, wy, wx) -> torch.Tensor:
    """Fused windowed RoIAlign: canvas [S,Hmax,Wmax,C] f32|bf16, slab/y0/x0
    [R] int32, wy/wx [R,P,win] f32 → pooled [R,P,P,C] in the canvas dtype.

    Calls the op ``uwcv::roi_align_windows``, so ``torch.export`` records
    the kernel call and an exported program makes it again.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise; the
    kernel needs C % 8 == 0 and win <= 32).  Every window must lie inside
    the canvas, which ``window_geometry`` guarantees."""
    return torch.ops.uwcv.roi_align_windows(canvas, slab, y0, x0, wy, wx)


roi_align_windows.launches = 0   # kernel launches, counted by the op

# defined and implemented directly: ``torch.library.custom_op`` would wrap
# the implementation in Python layers that add to every call's dispatch
torch.library.define(
    "uwcv::roi_align_windows",
    "(Tensor canvas, Tensor slab, Tensor y0, Tensor x0, Tensor wy, "
    "Tensor wx) -> Tensor")


@torch.library.impl("uwcv::roi_align_windows", "default")
def _roi_align_windows_op(canvas, slab, y0, x0, wy, wx):
    if canvas.device.type == "cpu":
        return roi_align_windows_reference(canvas, slab, y0, x0, wy, wx)
    if canvas.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"canvas dtype {canvas.dtype} not supported")
    if canvas.dim() != 4:
        raise ValueError("canvas must be [S, Hmax, Wmax, C]")
    r, p, win = wy.shape
    _, h, w, c = canvas.shape
    if p not in POOL_SIZES:
        raise ValueError(f"output size {p} not in {POOL_SIZES}")
    if c % 8:
        raise ValueError(f"the kernel copies 16-byte channel chunks: C={c} "
                         f"is not a multiple of 8")
    if wx.shape != (r, p, win) or win > MAX_WINDOW or win > h or win > w:
        raise ValueError(f"bad window weights {tuple(wy.shape)} / "
                         f"{tuple(wx.shape)} for canvas {tuple(canvas.shape)}")
    for t in (slab, y0, x0):
        if t.dtype != torch.int32 or t.shape != (r,):
            raise ValueError("slab/y0/x0 must be [R] int32")
    args = [canvas.contiguous()] + [t.contiguous() for t in (slab, y0, x0)] \
        + [t.float().contiguous() for t in (wy, wx)]
    if any(t.device != canvas.device for t in args):
        raise ValueError("all inputs must be on the canvas' device")
    out = torch.empty((r, p, p, c), dtype=canvas.dtype, device=canvas.device)
    if r == 0:
        return out
    if args[0].data_ptr() % 16:
        raise ValueError("the canvas must start on a 16-byte boundary")
    # per roi, written by the kernel: a 16-byte task (its sub-window) and
    # its weights rounded to the canvas dtype, shifted to the sub-window
    tasks = torch.empty((r, 4), dtype=torch.int32, device=canvas.device)
    weights = torch.empty((r, 2, 16, 32), dtype=canvas.dtype,
                          device=canvas.device)
    lib = kernels.library("roi_align")
    fn = (lib.uwcv_roi_align_windows_f32 if canvas.dtype == torch.float32
          else lib.uwcv_roi_align_windows_bf16)
    # the launch goes to the calling thread's current device: make it the
    # canvas' one
    with torch.cuda.device(canvas.device):
        rc = fn(*[t.data_ptr() for t in args], tasks.data_ptr(),
                weights.data_ptr(), out.data_ptr(), r, p, h, w, c, win,
                kernels.stream_ptr(canvas.device))
    kernels.check(rc, "roi_align_windows")
    kernels.count_launch(roi_align_windows)
    return out


@torch.library.register_fake("uwcv::roi_align_windows")
def _(canvas, slab, y0, x0, wy, wx):
    r, p, _ = wy.shape
    return canvas.new_empty((r, p, p, canvas.shape[-1]))


def roi_align_windows_backward_reference(g, slab, y0, x0, wy, wx,
                                         canvas_shape) -> torch.Tensor:
    """Plain PyTorch version of the backward: g [R,P,P,C] (the pooled
    output's gradient) → the canvas gradient [S,Hmax,Wmax,C] in g's dtype.
    Per roi d_rows = wxᵀ·g and d_patch = wyᵀ·d_rows, with the weights in
    g's dtype (the JAX vjp of ``_pool_windows_xla``, roi_align.py:353-375),
    added into a zero canvas with ``index_put_(accumulate=True)``."""
    r, p, win = wy.shape
    wdt = g.dtype
    ar = torch.arange(win, device=g.device)
    dcanvas = g.new_zeros(canvas_shape)
    for s in range(0, r, REF_CHUNK):
        e = min(s + REF_CHUNK, r)
        d_rows = torch.einsum("rqw,rpqc->rpwc", wx[s:e].to(wdt), g[s:e])
        d_patch = torch.einsum("rph,rpwc->rhwc", wy[s:e].to(wdt), d_rows)
        sl = slab[s:e].long()[:, None, None]
        yy = y0[s:e].long()[:, None, None] + ar[None, :, None]
        xx = x0[s:e].long()[:, None, None] + ar[None, None, :]
        dcanvas.index_put_((sl, yy, xx), d_patch, accumulate=True)
    return dcanvas


def roi_align_windows_backward(g, slab, y0, x0, wy, wx,
                               canvas_shape) -> torch.Tensor:
    """The RoIAlign backward: g [R,P,P,C] f32|bf16, slab/y0/x0 [R] int32,
    wy/wx [R,P,win] f32 → the canvas gradient [S,Hmax,Wmax,C] in g's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise): a task pass finds each roi's nonzero sub-window, then a tile
    kernel sums, for each 8×8-cell tile of the canvas gradient, the rois
    that overlap it in f32 and in roi order and writes the tile once in g's
    dtype (zeros where no roi reaches), so two calls give bit-identical
    results."""
    if g.device.type == "cpu":
        return roi_align_windows_backward_reference(g, slab, y0, x0, wy, wx,
                                                    canvas_shape)
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gradient dtype {g.dtype} not supported")
    if len(canvas_shape) != 4:
        raise ValueError("canvas_shape must be (S, Hmax, Wmax, C)")
    r, p, win = wy.shape
    s, h, w, c = (int(v) for v in canvas_shape)
    if p not in POOL_SIZES:
        raise ValueError(f"output size {p} not in {POOL_SIZES}")
    if tuple(g.shape) != (r, p, p, c):
        raise ValueError(f"gradient {tuple(g.shape)} does not match "
                         f"{(r, p, p, c)}")
    if wx.shape != (r, p, win) or win > MAX_WINDOW or win > h or win > w:
        raise ValueError(f"bad window weights {tuple(wy.shape)} / "
                         f"{tuple(wx.shape)} for canvas {tuple(canvas_shape)}")
    for t in (slab, y0, x0):
        if t.dtype != torch.int32 or t.shape != (r,):
            raise ValueError("slab/y0/x0 must be [R] int32")
    args = [g.contiguous()] + [t.contiguous() for t in (slab, y0, x0)] \
        + [t.float().contiguous() for t in (wy, wx)]
    if any(t.device != g.device for t in args):
        raise ValueError("all inputs must be on the gradient's device")
    if r == 0:
        return g.new_zeros((s, h, w, c))
    out = torch.empty((s, h, w, c), dtype=g.dtype, device=g.device)
    # per roi, written by the task pass: a 16-byte task (its sub-window)
    # and its weights rounded to g's dtype, shifted to the sub-window; one
    # more row holds the tile kernel's work counters
    tasks = torch.empty((r + 1, 4), dtype=torch.int32, device=g.device)
    weights = torch.empty((r, 2, p, MAX_WINDOW), dtype=g.dtype,
                          device=g.device)
    lib = kernels.library("roi_align_bwd")
    fn = (lib.uwcv_roi_align_windows_bwd_f32 if g.dtype == torch.float32
          else lib.uwcv_roi_align_windows_bwd_bf16)
    with torch.cuda.device(g.device):
        rc = fn(*[t.data_ptr() for t in args], tasks.data_ptr(),
                weights.data_ptr(), out.data_ptr(), r, p, s, h, w, c, win,
                kernels.stream_ptr(g.device))
    kernels.check(rc, "roi_align_windows_backward")
    kernels.count_launch(roi_align_windows_backward)
    return out


roi_align_windows_backward.launches = 0


class PoolWindows(torch.autograd.Function):
    """``roi_align_windows`` with ``roi_align_windows_backward`` as its
    gradient.  The gradient flows to the canvas only: the window geometry
    and weights are functions of rois that carry no gradient
    (roi_align.py:411-415 of the JAX package)."""

    @staticmethod
    def forward(ctx, canvas, slab, y0, x0, wy, wx):
        ctx.save_for_backward(slab, y0, x0, wy, wx)
        ctx.canvas_shape = tuple(canvas.shape)
        return roi_align_windows(canvas, slab, y0, x0, wy, wx)

    @staticmethod
    def backward(ctx, g):
        slab, y0, x0, wy, wx = ctx.saved_tensors
        dcanvas = roi_align_windows_backward(g.contiguous(), slab, y0, x0,
                                             wy, wx, ctx.canvas_shape)
        return dcanvas, None, None, None, None, None


def pool_level_canvas(canvas: torch.Tensor, shapes, rois: torch.Tensor,
                      strides: Dict[str, int], output_size: int,
                      canonical_size: float = 224.0, canonical_level: int = 4,
                      samples_per_bin: int = 2, window: int = 32
                      ) -> torch.Tensor:
    """Pool rois [B,R,4] from a ``level_canvas`` → [B,R,P,P,C].  One kernel
    launch for the whole batch."""
    b, r = rois.shape[:2]
    c = canvas.shape[-1]
    li, y0, x0, wy, wx = window_geometry(
        rois.reshape(b * r, 4).float(), shapes, level_strides(strides),
        output_size, canonical_size, canonical_level, samples_per_bin, window)
    slab = (torch.arange(b, device=rois.device)[:, None] * 5
            + li.reshape(b, r)).reshape(-1)
    pooled = PoolWindows.apply(canvas, slab.to(torch.int32),
                               y0.to(torch.int32), x0.to(torch.int32), wy, wx)
    return pooled.reshape(b, r, output_size, output_size, c)


def multilevel_roi_align_batched(features: Dict[str, torch.Tensor],
                                 rois: torch.Tensor, strides: Dict[str, int],
                                 output_size: int,
                                 canonical_size: float = 224.0,
                                 canonical_level: int = 4,
                                 samples_per_bin: int = 2,
                                 window: int = 32) -> torch.Tensor:
    """Batched pooler: features {level: [B,H,W,C]}, rois [B,R,4] →
    [B,R,P,P,C]."""
    canvas, shapes = level_canvas(features, window)
    return pool_level_canvas(canvas, shapes, rois, strides, output_size,
                             canonical_size, canonical_level, samples_per_bin,
                             window)
