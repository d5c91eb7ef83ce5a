"""The port's ops (``uwcv_tpu_torch``) against the JAX package's, on the CPU.

The same numpy inputs go through the JAX function and its port; Pallas
kernels run in interpret mode, as tests/test_pallas_kernels.py runs them.
On the CPU each kernel wrapper takes its plain PyTorch version, so these
tests hold the plain versions (and the geometry around the kernels) against
the TPU kernels' semantics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from tests.test_ops_morphology_paste import _ring, _snake
from tests.test_ops_nms_roialign import _ramp_feats, roi_align_oracle
from uwcv_tpu.data.augment import pack_bitmasks as j_pack
from uwcv_tpu.models.anchors import generate_anchors as j_anchors
from uwcv_tpu.ops import mask_paste as j_paste
from uwcv_tpu.ops import morphology as j_morph
from uwcv_tpu.ops.nms import NEG_INF, nms_mask as j_nms_mask
from uwcv_tpu.ops.pallas.nms_kernel import nms_fixpoint_pallas
from uwcv_tpu.ops.roi_align import (
    multilevel_roi_align,
    multilevel_roi_align_batched as j_pool_batched,
)
from uwcv_tpu.structures import boxes as j_boxes
from uwcv_tpu.utils.image import device_resize as j_device_resize
from uwcv_tpu_torch.data.augment import pack_bitmasks
from uwcv_tpu_torch.models.anchors import generate_anchors
from uwcv_tpu_torch.ops import morphology as morph
from uwcv_tpu_torch.ops.mask_paste import (
    paste_claim_pack,
    paste_masks,
    paste_select_pack,
)
from uwcv_tpu_torch.ops.nms import (
    batched_class_nms_mask,
    nms_greedy,
    nms_greedy_reference,
    nms_mask,
    nms_mask_batched,
)
from uwcv_tpu_torch.ops.roi_align import (
    level_canvas,
    level_strides,
    multilevel_roi_align_batched,
    roi_align_windows_backward_reference,
    roi_align_windows_reference,
    subwindow_extent,
    window_geometry,
)
from uwcv_tpu_torch.structures import boxes as t_boxes
from uwcv_tpu_torch.utils.image import device_resize, host_resize

T = torch.from_numpy
STRIDES = {f"p{l}": 2 ** l for l in range(2, 6)}


def _random_boxes(rng, n, lo=20, hi=200, smin=10, smax=60):
    c = rng.uniform(lo, hi, (n, 2))
    s = rng.uniform(smin, smax, (n, 2))
    return np.concatenate([c - s / 2, c + s / 2], 1).astype(np.float32)


# ---------------------------------------------------------------- NMS (B2)

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_mask_matches_jax(seed):
    """N=300 (not a multiple of 128) with NEG_INF padding and tied
    scores: the port's keep mask equals the XLA fixpoint's."""
    rng = np.random.default_rng(seed)
    n = 300
    boxes = _random_boxes(rng, n)
    scores = rng.uniform(0.1, 1.0, n).astype(np.float32)
    scores[40:60] = scores[40]            # ties: lower index wins
    scores[-25:] = NEG_INF
    want = np.asarray(j_nms_mask(jnp.asarray(boxes), jnp.asarray(scores), 0.5))
    got = nms_mask(T(boxes), T(scores), 0.5).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [3, 4])
def test_nms_plain_matches_pallas_interpret(seed):
    """The kernel's plain version against the Pallas greedy kernel in
    interpret mode, on score-sorted boxes padded to the 128-lane tile."""
    rng = np.random.default_rng(seed)
    n, n_pad = 200, 256
    boxes = np.zeros((n_pad, 4), np.float32)
    boxes[:n] = _random_boxes(rng, n)
    valid = np.zeros(n_pad, bool)
    valid[:n - 17] = True
    want = np.asarray(nms_fixpoint_pallas(jnp.asarray(boxes),
                                          jnp.asarray(valid), 0.7,
                                          interpret=True))
    got = nms_greedy_reference(T(boxes)[None], T(valid)[None], 0.7)[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_nms_chain_suppression():
    # A overlaps B, B overlaps C, A∩C small: greedy keeps A and C
    boxes = np.asarray([[0, 0, 10, 10], [6, 0, 16, 10], [12, 0, 22, 10]],
                       np.float32)
    want = np.asarray(nms_fixpoint_pallas(jnp.asarray(boxes),
                                          jnp.ones(3, bool), 0.2,
                                          interpret=True))
    got = nms_greedy(T(boxes)[None], torch.ones(1, 3, dtype=torch.bool), 0.2)
    assert list(want) == [True, False, True]
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_nms_batched_unequal_sizes():
    """Problems of unequal N padded with NEG_INF entries into one batched
    call give each problem's own keep mask."""
    rng = np.random.default_rng(7)
    sizes = [300, 77, 5, 1]
    n = max(sizes)
    boxes = np.zeros((len(sizes), n, 4), np.float32)
    scores = np.full((len(sizes), n), NEG_INF, np.float32)
    for i, k in enumerate(sizes):
        boxes[i, :k] = _random_boxes(rng, k)
        scores[i, :k] = rng.uniform(0, 1, k)
    got = nms_mask_batched(T(boxes), T(scores), 0.6).numpy()
    for i, k in enumerate(sizes):
        want = np.asarray(j_nms_mask(jnp.asarray(boxes[i, :k]),
                                     jnp.asarray(scores[i, :k]), 0.6))
        np.testing.assert_array_equal(got[i, :k], want)
        assert not got[i, k:].any()


def test_batched_class_nms_matches_jax():
    from uwcv_tpu.ops.nms import batched_class_nms_mask as j_batched

    rng = np.random.default_rng(8)
    b, n = 3, 120
    boxes = np.stack([_random_boxes(rng, n) for _ in range(b)])
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    classes = rng.integers(0, 4, (b, n)).astype(np.int32)
    got = batched_class_nms_mask(T(boxes), T(scores), T(classes), 0.5).numpy()
    for i in range(b):
        want = np.asarray(j_batched(jnp.asarray(boxes[i]),
                                    jnp.asarray(scores[i]),
                                    jnp.asarray(classes[i]), 0.5))
        np.testing.assert_array_equal(got[i], want)


def _nms_bitmatrix_scan(boxes, valid, thr):
    """numpy mirror of csrc/nms.cu: words [N, ceil(N/64)] of IoU(i, j) > thr
    bits for j > i (f32, the kernel's operation order), then the scan that
    walks each 64-box block from ~valid, keeps the lowest undecided box and
    ORs its row into the block's word and, once the block is decided, into
    every later word."""
    n = len(boxes)
    words = -(-n // 64)
    b = boxes.astype(np.float32)
    zero = np.float32(0)
    area = (np.maximum(b[:, 2] - b[:, 0], zero)
            * np.maximum(b[:, 3] - b[:, 1], zero))
    iw = np.maximum(np.minimum(b[:, None, 2], b[None, :, 2])
                    - np.maximum(b[:, None, 0], b[None, :, 0]), zero)
    ih = np.maximum(np.minimum(b[:, None, 3], b[None, :, 3])
                    - np.maximum(b[:, None, 1], b[None, :, 1]), zero)
    inter = iw * ih
    uni = (area[:, None] + area[None, :]) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(uni > 0, inter / np.maximum(uni, np.float32(1e-12)),
                       zero)
    over = np.zeros((n, words * 64), bool)
    over[:, :n] = (iou > np.float32(thr)) & np.triu(np.ones((n, n), bool), 1)
    pow2 = np.uint64(1) << np.arange(64, dtype=np.uint64)
    mask = (over.reshape(n, words, 64) * pow2).sum(-1, dtype=np.uint64)
    vpad = np.zeros(words * 64, bool)
    vpad[:n] = valid
    removed = [int((~vpad[64 * k:64 * k + 64] * pow2).sum(dtype=np.uint64))
               for k in range(words)]
    keep = np.zeros(n, bool)
    for k in range(words):
        cur = removed[k]
        in_range = (1 << min(64, n - 64 * k)) - 1
        todo = ~cur & in_range
        while todo:
            bit = (todo & -todo).bit_length() - 1
            d = int(mask[64 * k + bit, k])
            cur |= d
            todo &= todo - 1
            todo &= ~d
        kept = [bit for bit in range(64) if (~cur & in_range) >> bit & 1]
        keep[[64 * k + bit for bit in kept]] = True
        for w in range(k + 1, words):
            for bit in kept:
                removed[w] |= int(mask[64 * k + bit, w])
    return keep


def _nms_case(kind, n):
    rng = np.random.default_rng(n)
    if kind == "chain":           # each box overlaps only its neighbours
        x = np.arange(n, dtype=np.float32) * 6
        boxes = np.stack([x, 0 * x, x + 10, 0 * x + 10], 1)
        return boxes, np.ones(n, bool)
    # clusters around a few objects, score-sorted order, NEG_INF padding
    ctr = rng.uniform(0, 300, (8, 2))[rng.integers(0, 8, n)]
    ctr += rng.normal(0, 4, (n, 2))
    size = rng.uniform(10, 60, (n, 2))
    boxes = np.concatenate([ctr - size / 2, ctr + size / 2], 1)
    valid = np.ones(n, bool)
    if kind == "padded":
        valid[n - n // 5:] = False
        boxes[n - n // 5:] = 0.0
    elif kind == "invalid":
        valid[:] = False
    return boxes.astype(np.float32), valid


@pytest.mark.parametrize("kind", ["padded", "chain", "invalid"])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000])
def test_nms_bitmatrix_scan_mirror_matches(n, kind):
    """The algorithm of the CUDA kernel (bit matrix + block scan), mirrored
    in numpy, gives the keep masks of the plain version and of the Pallas
    greedy kernel in interpret mode, at word and block edges."""
    boxes, valid = _nms_case(kind, n)
    for thr in (0.0, 0.5, 1.0):
        got = _nms_bitmatrix_scan(boxes, valid, thr)
        want = nms_greedy_reference(T(boxes)[None], T(valid)[None], thr)[0]
        np.testing.assert_array_equal(got, want.numpy())
        if n > 1:
            pallas = np.asarray(nms_fixpoint_pallas(
                jnp.asarray(boxes), jnp.asarray(valid), thr, interpret=True))
            np.testing.assert_array_equal(got, pallas)
        if kind == "chain" and thr == 0.0 and n >= 4:
            assert list(got[:4]) == [True, False, True, False]


# ------------------------------------------------------------ RoIAlign (B1)

def _pool_subwindows(canvas, slab, y0, x0, wy, wx):
    """``roi_align_windows_reference``'s arithmetic on each roi's nonzero
    wy × wx extent only: the sub-window the CUDA kernel copies."""
    dt = canvas.dtype
    hlo, nh = subwindow_extent(wy.to(dt))
    wlo, nw = subwindow_extent(wx.to(dt))
    r, p, _ = wy.shape
    out = canvas.new_zeros((r, p, p, canvas.shape[-1]))
    for i in range(r):
        h0, hn, w0, wn = int(hlo[i]), int(nh[i]), int(wlo[i]), int(nw[i])
        ys, xs = int(y0[i]) + h0, int(x0[i]) + w0
        patch = canvas[int(slab[i]), ys:ys + hn, xs:xs + wn]
        rows = torch.einsum("ph,hwc->pwc", wy[i, :, h0:h0 + hn].to(dt), patch)
        out[i] = torch.einsum("qw,pwc->pqc", wx[i, :, w0:w0 + wn].to(dt), rows)
    return out, nh, nw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [7, 14])
def test_roi_align_subwindow_matches_full_window(dtype, p):
    """The kernel's premise: pooling each roi over its nonzero sub-window
    only gives the full-window plain version (f32 within 1e-5·max|ref|;
    bf16 within 2^-7·max|ref|: fewer terms in the sums, one rounding of
    ``rows``).  Proposal-like rois, an image-wide 20:1 bar, zero boxes and
    windows clamped at the canvas edges."""
    rng = np.random.default_rng(p)
    b, h, w, c = 2, 256, 320, 16
    feats = {f"p{l}": T(rng.standard_normal((b, h >> l, w >> l, c),
                                            dtype=np.float32)).to(dtype)
             for l in range(2, 6)}
    canvas, shapes = level_canvas(feats, 32)
    side = np.exp(rng.uniform(np.log(8), np.log(300), (60, 2)))
    ctr = rng.uniform(0, 1, (60, 2)) * [w, h]
    rois = np.concatenate([ctr - side / 2, ctr + side / 2], -1)
    rois[:, 0::2] = rois[:, 0::2].clip(0, w)
    rois[:, 1::2] = rois[:, 1::2].clip(0, h)
    rois[0] = [10, h / 2 - 7, w - 10, h / 2 + 7]       # ~20:1 bar
    rois[1] = rois[2] = 0.0                            # invalid slots
    rois[3] = [0, 0, 12, 9]                            # canvas corners
    rois[4] = [w - 40, h - 30, w, h]
    rois[5] = [w - 200, 0, w, 150]
    rois = T(rois.astype(np.float32))
    li, y0, x0, wy, wx = window_geometry(
        rois, shapes, level_strides(STRIDES), p, 224.0, 4, 2, 32)
    slab = (torch.arange(60) % b) * 5 + li
    args = (canvas, slab, y0, x0, wy, wx)
    want = roi_align_windows_reference(*args).float()
    got, nh, nw = _pool_subwindows(*args)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert (got.float() - want).abs().max() <= tol * want.abs().max()
    # the extents fit the kernel's 32×32 tile, and the edge windows touch
    # the canvas border
    assert int(nh.max()) <= 32 and int(nw.max()) <= 32 and int(nh.min()) > 0
    assert int(y0[3]) == 0 and int(x0[3]) == 0
    assert int(x0[4]) + 32 == shapes[int(li[4])][1]


@pytest.mark.parametrize("whole", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chip_smoke_roi_bound_counts_covered_cells(dtype, whole):
    """``chip_smoke._roi_bound`` reads each canvas cell that some roi's
    sub-window (or whole window) covers once: its byte count equals a
    cell-by-cell mask of those rectangles, and its operations are the two
    contractions over them."""
    import chip_smoke

    rng = np.random.default_rng(11)
    b, h, w, c, p, win = 2, 256, 320, 8, 7, 32
    feats = {f"p{l}": T(np.zeros((b, h >> l, w >> l, c), np.float32))
             .to(dtype) for l in range(2, 6)}
    canvas, shapes = level_canvas(feats, win)
    side = np.exp(rng.uniform(np.log(8), np.log(300), (40, 2)))
    ctr = rng.uniform(0, 1, (40, 2)) * [w, h]
    rois = np.concatenate([ctr - side / 2, ctr + side / 2], -1).clip(0, w)
    rois[:, 1::2] = rois[:, 1::2].clip(0, h)
    li, y0, x0, wy, wx = window_geometry(
        T(rois.astype(np.float32)), shapes, level_strides(STRIDES), p,
        224.0, 4, 2, win)
    slab = (torch.arange(40) % b) * 5 + li
    r = len(slab)
    if whole:
        hlo = wlo = torch.zeros(r, dtype=torch.int64)
        nh = nw = torch.full((r,), win)
    else:
        hlo, nh = subwindow_extent(wy.to(dtype))
        wlo, nw = subwindow_extent(wx.to(dtype))
        assert int(nh.sum()) < r * win and int(nw.sum()) < r * win
    mask = torch.zeros(canvas.shape[:3], dtype=torch.bool)
    for i in range(r):
        ys, xs = int(y0[i] + hlo[i]), int(x0[i] + wlo[i])
        mask[int(slab[i]), ys:ys + int(nh[i]), xs:xs + int(nw[i])] = True
    elem = canvas.element_size()
    want_bytes = (int(mask.sum()) * c * elem + 2 * r * p * win * 4 + 3 * r * 4
                  + r * p * p * c * elem)
    want_flops = sum(2.0 * p * c * (int(nh[i]) * int(nw[i]) + p * int(nw[i]))
                     for i in range(r))
    got = chip_smoke._roi_bound(canvas, slab, y0, x0, wy, wx,
                                whole_windows=whole)
    want = chip_smoke.bound(want_bytes, want_flops, dtype)
    assert got[1] == want[1]
    assert got[0] == pytest.approx(want[0], rel=1e-12)


# ------------------------------------------------- RoIAlign backward (B1-bwd)

def _bwd_problem(dtype, p, c=12, r=30, seed=0):
    """Proposal-like rois (an image-wide bar, zero boxes and corner boxes
    among them) on a small batch of 2, g drawn in ``dtype``.  → (g, (slab,
    y0, x0, wy, wx), canvas shape)."""
    rng = np.random.default_rng(seed + p)
    b, h, w, win = 2, 136, 168, 32
    feats = {f"p{l}": T(np.zeros((b, h >> l, w >> l, c), np.float32))
             for l in range(2, 6)}
    canvas, shapes = level_canvas(feats, win)
    side = np.exp(rng.uniform(np.log(4), np.log(150), (r, 2)))
    ctr = rng.uniform(0, 1, (r, 2)) * [w, h]
    rois = np.concatenate([ctr - side / 2, ctr + side / 2], -1)
    rois[:, 0::2] = rois[:, 0::2].clip(0, w)
    rois[:, 1::2] = rois[:, 1::2].clip(0, h)
    rois[0] = [5, h / 2 - 4, w - 5, h / 2 + 4]        # image-wide bar
    rois[1] = 0.0                                      # invalid slot
    rois[2] = [0, 0, 9, 7]                             # canvas corners
    rois[3] = [w - 30, h - 20, w, h]
    rois[4] = rois[5] = rois[6]                        # overlapping copies
    li, y0, x0, wy, wx = window_geometry(
        T(rois.astype(np.float32)), shapes, level_strides(STRIDES), p,
        224.0, 4, 2, win)
    slab = ((torch.arange(r) % b) * 5 + li).to(torch.int32)
    g = T(rng.standard_normal((r, p, p, c), dtype=np.float32)).to(dtype)
    return g, (slab, y0.to(torch.int32), x0.to(torch.int32), wy, wx), \
        tuple(canvas.shape)


def _bwd_tile_mirror(g, slab, y0, x0, wy, wx, canvas_shape, tile=8):
    """csrc/roi_align_bwd.cu's algorithm written out in torch: each roi's
    task (the nonzero sub-window of its weights rounded to g's dtype), then
    for each tile × tile block of each slab the rois whose sub-window
    overlaps it, in roi order, summed in f32 and rounded once to g's dtype.
    The output starts as NaN, so a cell that no tile writes shows."""
    dt = g.dtype
    ns, h, w, _ = canvas_shape
    wyr, wxr = wy.to(dt).float(), wx.to(dt).float()
    hlo, nh = subwindow_extent(wy.to(dt))
    wlo, nw = subwindow_extent(wx.to(dt))
    ys, xs = (y0.long() + hlo).tolist(), (x0.long() + wlo).tolist()
    hlo, nh, wlo, nw = hlo.tolist(), nh.tolist(), wlo.tolist(), nw.tolist()
    out = torch.full(canvas_shape, float("nan"), dtype=dt)
    gf = g.float()
    for s in range(ns):
        mine = [r for r in range(len(slab))
                if int(slab[r]) == s and nh[r] and nw[r]]
        for ty in range(0, h, tile):
            for tx in range(0, w, tile):
                th, tw = min(tile, h - ty), min(tile, w - tx)
                acc = torch.zeros((th, tw) + tuple(g.shape[3:]))
                for r in mine:
                    # the tile's rows and columns inside the sub-window
                    r0, r1 = max(ty, ys[r]), min(ty + th, ys[r] + nh[r])
                    c0, c1 = max(tx, xs[r]), min(tx + tw, xs[r] + nw[r])
                    if r0 >= r1 or c0 >= c1:
                        continue
                    wy_t = wyr[r][:, hlo[r] + r0 - ys[r]:hlo[r] + r1 - ys[r]]
                    wx_t = wxr[r][:, wlo[r] + c0 - xs[r]:wlo[r] + c1 - xs[r]]
                    d_rows = torch.einsum("qw,pqc->pwc", wx_t, gf[r])
                    acc[r0 - ty:r1 - ty, c0 - tx:c1 - tx] += torch.einsum(
                        "ph,pwc->hwc", wy_t, d_rows)
                out[s, ty:ty + th, tx:tx + tw] = acc.to(dt)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [7, 14])
def test_roi_align_backward_tiles_match_plain(dtype, p):
    """The backward kernel's premise: owning output tiles, each summing the
    rois whose sub-window overlaps it in roi order with one rounding, writes
    every cell and gives the plain version (``chip_smoke.check_bwd_result``:
    f32 within 1e-5·max|ref|, bf16 within one rounding elementwise); a
    canvas whose sides (34 × 42) are no multiple of 8 and C = 12."""
    import chip_smoke

    g, geo, shape = _bwd_problem(dtype, p)
    got = _bwd_tile_mirror(g, *geo, shape)
    assert not torch.isnan(got).any()
    err, top, ok = chip_smoke.check_bwd_result(got, g, geo, shape)
    assert ok and top > 0, (err, top)
    # the tiles agree with the JAX vjp's semantics as the plain version
    # states them, in f32
    if dtype == torch.float32:
        want = roi_align_windows_backward_reference(g, *geo, shape)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chip_smoke_bwd_check_rejects_a_wrong_cell(dtype):
    """``chip_smoke.check_bwd_result`` holds each cell: one cell moved by
    a few percent of its value, or the shape or dtype changed, fails."""
    import chip_smoke

    g, geo, shape = _bwd_problem(dtype, 7)
    good = _bwd_tile_mirror(g, *geo, shape)
    assert chip_smoke.check_bwd_result(good, g, geo, shape)[2]
    bad = good.clone()
    at = tuple(int(i) for i in np.unravel_index(
        int(good.float().abs().argmax()), shape))
    bad[at] = bad[at] * 1.05
    assert not chip_smoke.check_bwd_result(bad, g, geo, shape)[2]
    assert not chip_smoke.check_bwd_result(good.double(), g, geo, shape)[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [7, 14])
def test_chip_smoke_roi_bwd_bound_counts_tile_overlaps(dtype, p):
    """``chip_smoke._roi_bwd_bound``: the bound reads g, the weights and
    the origins once and writes the canvas gradient once; the design floor
    also writes the tasks and rounded weights once and reads each roi's g,
    task and weights once per 8×8 output tile that its sub-window overlaps,
    counted here cell by cell."""
    import chip_smoke

    g, (slab, y0, x0, wy, wx), shape = _bwd_problem(dtype, p, c=16)
    r, _, win = wy.shape
    hlo, nh = subwindow_extent(wy.to(dtype))
    wlo, nw = subwindow_extent(wx.to(dtype))
    pairs = 0
    for i in range(r):
        tiles = {((int(y0[i] + hlo[i]) + dy) // 8, (int(x0[i] + wlo[i]) + dx)
                  // 8) for dy in range(int(nh[i])) for dx in range(int(nw[i]))}
        pairs += len(tiles)
    assert r < pairs < 16 * r
    elem = g.element_size()
    c = shape[-1]
    inputs = 2 * r * p * win * 4 + 3 * r * 4
    n_out = int(np.prod(shape)) * elem
    per_roi = 16 + 2 * p * 32 * elem
    want_bound = chip_smoke.bound(
        r * p * p * c * elem + inputs + n_out,
        sum(2.0 * p * c * (p * int(nw[i]) + int(nh[i]) * int(nw[i]))
            for i in range(r)), dtype)
    want_floor = (inputs + r * per_roi + pairs * (p * p * c * elem + per_roi)
                  + n_out) / chip_smoke.HBM_BYTES_PER_S * 1e3
    b_ms, b_by, floor = chip_smoke._roi_bwd_bound(g, slab, y0, x0, wy, wx,
                                                  shape)
    assert b_by == want_bound[1]
    assert b_ms == pytest.approx(want_bound[0], rel=1e-12)
    assert floor == pytest.approx(want_floor, rel=1e-12)
    assert floor > b_ms


@pytest.mark.parametrize("c,p", [(8, 7), (8, 14), (64, 7), (64, 14)])
def test_roi_align_matches_pallas_interpret_and_xla(c, p):
    """Geometry + the kernel's plain version against the fused Pallas
    kernel (interpret mode) and the vmapped XLA pooler, incl. an
    image-wide bar (virtual-p6 bump) and a zero box (invalid detection)."""
    rng = np.random.default_rng(5)
    b = 2
    feats = {f"p{l}": rng.normal(0, 1, (b, 256 >> (l - 2), 320 >> (l - 2), c))
             .astype(np.float32) for l in range(2, 6)}
    rois = []
    for _ in range(b):
        ctr = rng.uniform(60, 900, (13, 2))
        wh = rng.uniform(16, 400, (13, 2))
        bx = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
        rois.append(np.concatenate([bx, [[10, 200, 1000, 230], [0, 0, 0, 0]]]))
    rois = np.stack(rois).astype(np.float32)
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    got = multilevel_roi_align_batched(
        {k: T(v) for k, v in feats.items()}, T(rois), STRIDES, p).numpy()
    for use_pallas, interpret in ((True, True), (False, False)):
        want = np.asarray(j_pool_batched(jf, jnp.asarray(rois), STRIDES, p,
                                         interpret=interpret,
                                         use_pallas=use_pallas))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_roi_align_image_wide_full_coverage():
    """The cases of test_ops_nms_roialign.py::test_image_wide_roi_full_coverage:
    a 1300×12 px scale bar and an image-sized box on exact linear ramps."""
    feats = _ramp_feats(1024, 1344)
    rois = np.array([[20.0, 500.0, 1320.0, 512.0],
                     [10.0, 10.0, 1334.0, 1014.0]], np.float32)
    want = np.asarray(multilevel_roi_align(feats, jnp.asarray(rois),
                                           STRIDES, 7))
    got = multilevel_roi_align_batched(
        {k: T(np.array(v))[None] for k, v in feats.items()},
        T(rois)[None], STRIDES, 7)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # and the coverage the JAX test demands of its oracle
    np.testing.assert_allclose(got[0], roi_align_oracle(
        np.asarray(feats["p3"]), rois[0], 8, 7), atol=15.0)
    np.testing.assert_allclose(got[1], roi_align_oracle(
        np.asarray(feats["p5"]), rois[1], 32, 7), atol=15.0)


# ------------------------------------------------------- boxes and anchors

def test_boxes_match_jax():
    rng = np.random.default_rng(9)
    a = _random_boxes(rng, 40, lo=-20, hi=300)
    b = _random_boxes(rng, 30, lo=-20, hi=300)
    a[3] = 0.0                                  # padded box → 0 IoU
    np.testing.assert_array_equal(
        t_boxes.box_iou(T(a), T(b)).numpy(),
        np.asarray(j_boxes.box_iou(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        t_boxes.clip_boxes(T(a), (200, 150)).numpy(),
        np.asarray(j_boxes.clip_boxes(jnp.asarray(a), (200, 150))))
    np.testing.assert_array_equal(
        t_boxes.nonempty_boxes(T(a), 1.0).numpy(),
        np.asarray(j_boxes.nonempty_boxes(jnp.asarray(a), 1.0)))
    deltas = rng.normal(0, 2, (40, 4)).astype(np.float32)
    deltas[0, 2:] = 50.0                        # hits the scale clamp
    # decode: XLA fuses multiply-adds and has its own exp, so coordinates
    # may differ in the last bit (f32 eps = 1.2e-7)
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        np.testing.assert_allclose(
            t_boxes.decode_deltas(T(deltas), T(a), w).numpy(),
            np.asarray(j_boxes.decode_deltas(jnp.asarray(deltas),
                                             jnp.asarray(a), w)),
            rtol=1e-6, atol=1e-5)


def test_anchors_match_jax_exactly():
    args = ((96, 160), (4, 8, 16, 32, 64),
            ((32.0,), (64.0,), (128.0,), (256.0,), (512.0,)),
            (0.1, 0.5, 1.0, 2.0, 10.0))
    for got, want in zip(generate_anchors(*args), j_anchors(*args)):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------- morphology, paste, bit-packing

def _morph_fixtures():
    rng = np.random.default_rng(5)
    m = [_ring(), _snake(21, 21), np.zeros((9, 9), bool)]
    m[2][2, 2:6] = True
    m[2][6, 2:7] = True
    m[2][2:7, 2] = True
    m[2][3, 6] = m[2][4:6, 6] = True
    m += [rng.random((20, 24)) > 0.6 for _ in range(4)]
    m += [rng.random((24, 24)) > 0.75]
    return m


def test_morphology_matches_jax_bit_exact():
    for m in _morph_fixtures():
        tm, jm = T(m), jnp.asarray(m)
        for conn in (1, 2):
            np.testing.assert_array_equal(morph.dilate(tm, conn).numpy(),
                                          np.asarray(j_morph.dilate(jm, conn)))
            np.testing.assert_array_equal(morph.erode(tm, conn).numpy(),
                                          np.asarray(j_morph.erode(jm, conn)))
        np.testing.assert_array_equal(morph.fill_holes(tm).numpy(),
                                      np.asarray(j_morph.fill_holes(jm)))
        np.testing.assert_array_equal(morph.fill_holes(tm).numpy(),
                                      ndi.binary_fill_holes(m))
        np.testing.assert_array_equal(
            morph.close_open_smooth(tm).numpy(),
            np.asarray(j_morph.close_open_smooth(jm)))
        np.testing.assert_array_equal(
            morph.connected_components(tm).numpy(),
            np.asarray(j_morph.connected_components(jm)))
        assert int(morph.count_components(tm)) == int(
            j_morph.count_components(jm))
    # batched stack: one flood for all masks
    stack = np.stack([_ring(), np.zeros((32, 32), bool)])
    np.testing.assert_array_equal(
        morph.fill_holes(T(stack)).numpy(),
        np.asarray(jax.vmap(j_morph.fill_holes)(jnp.asarray(stack))))


def test_remove_overlaps_and_clean_head_masks_match_jax():
    rng = np.random.default_rng(11)
    masks = rng.random((9, 40, 48)) > 0.5
    order = rng.permutation(9).astype(np.int32)
    np.testing.assert_array_equal(
        morph.remove_overlaps(T(masks), T(order).long()).numpy(),
        np.asarray(j_morph.remove_overlaps(jnp.asarray(masks),
                                           jnp.asarray(order))))
    # smooth blobs + noise: some fragment, some have holes
    yy, xx = np.mgrid[0:28, 0:28]
    probs = []
    for i in range(12):
        cy, cx, r = rng.uniform(8, 20), rng.uniform(8, 20), rng.uniform(4, 10)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        noise = rng.normal(0, 0.25 if i % 2 else 0.02, (28, 28))
        probs.append(np.clip(blob + noise, 0, 1))
    probs = np.stack(probs).astype(np.float32)
    got_m, got_s = morph.clean_head_masks(T(probs))
    want_m, want_s = j_morph.clean_head_masks(jnp.asarray(probs))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert not got_s.all() and got_s.any()


def test_paste_and_pack_match_jax_bit_exact():
    """The fixture of test_paste_select_pack_matches_unfused_pipeline."""
    rng = np.random.default_rng(11)
    d, m, h, w = 17, 28, 128, 160
    probs = rng.uniform(0, 1, (d, m, m)).astype(np.float32)
    x1 = rng.uniform(0, w - 30, d)
    y1 = rng.uniform(0, h - 30, d)
    boxes = np.stack([x1, y1, x1 + rng.uniform(10, 60, d),
                      y1 + rng.uniform(10, 60, d)], axis=1).astype(np.float32)
    want = np.asarray(j_paste.paste_masks(jnp.asarray(probs),
                                          jnp.asarray(boxes), (h, w)))
    got = paste_masks(T(probs), T(boxes), (h, w)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pack_bitmasks(T(got)).numpy(),
                                  np.asarray(j_pack(jnp.asarray(want))))
    np.testing.assert_array_equal(pack_bitmasks(T(got)).numpy(),
                                  np.packbits(want, axis=-1))


@pytest.mark.parametrize("overlaps", [True, False])
@pytest.mark.parametrize("chunk", [1, 10, 17])
def test_paste_select_pack_matches_jax_and_unfused(chunk, overlaps):
    """The fused tail on the fixture above, bit for bit against the JAX
    ``paste_select_pack`` and against the port's unfused chain (paste →
    extent → overlap claim → min-pixel filter → pack)."""
    rng = np.random.default_rng(11)
    d, m, h, w = 17, 28, 128, 160
    probs = rng.uniform(0, 1, (d, m, m)).astype(np.float32)
    x1 = rng.uniform(0, w - 30, d)
    y1 = rng.uniform(0, h - 30, d)
    boxes = np.stack([x1, y1, x1 + rng.uniform(10, 60, d),
                      y1 + rng.uniform(10, 60, d)], axis=1).astype(np.float32)
    keep = rng.random(d) > 0.2
    scores = rng.random(d).astype(np.float32)
    extent = np.zeros((h, w), bool)
    extent[:100, :140] = True
    args = dict(min_pixels=40, do_remove_overlaps=overlaps, chunk=chunk)
    want_p, want_k = j_paste.paste_select_pack(
        jnp.asarray(probs), jnp.asarray(boxes), jnp.asarray(keep),
        jnp.asarray(scores), (h, w), extent=jnp.asarray(extent), **args)
    got_p, got_k = paste_select_pack(T(probs), T(boxes), T(keep), T(scores),
                                     (h, w), extent=T(extent), **args)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    masks = paste_masks(T(probs), T(boxes), (h, w)) & T(extent)
    unfused_keep = T(keep)
    if overlaps:
        order = torch.sort(-torch.where(unfused_keep, T(scores), torch.tensor(
            -np.inf)), stable=True).indices
        masks = morph.remove_overlaps(masks, order)
    unfused_keep = unfused_keep & (masks.sum(dim=(1, 2)) >= 40)
    np.testing.assert_array_equal(
        got_p.numpy(), pack_bitmasks(masks & unfused_keep[:, None, None]).numpy())
    np.testing.assert_array_equal(got_k.numpy(), unfused_keep.numpy())
    # a leading batch axis runs each image as on its own
    got_b, keep_b = paste_select_pack(
        T(np.stack([probs, probs[::-1].copy()])),
        T(np.stack([boxes, boxes[::-1].copy()])),
        T(np.stack([keep, keep[::-1].copy()])),
        T(np.stack([scores, scores[::-1].copy()])), (h, w),
        extent=T(np.stack([extent, extent])), **args)
    np.testing.assert_array_equal(got_b[0].numpy(), got_p.numpy())
    np.testing.assert_array_equal(keep_b[0].numpy(), got_k.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("min_pixels", [0, 2, 50])
@pytest.mark.parametrize("overlaps", [True, False])
def test_paste_claim_pack_equals_chain_and_paste_select_pack(
        overlaps, min_pixels, dtype):
    """The op ``paste_claim_pack`` on the CPU, bit for bit against the
    unfused chain written out here (paste → extent → overlap claim →
    min-pixel filter → pack) and against ``paste_select_pack``, for two
    images whose extents are smaller than the canvas."""
    rng = np.random.default_rng(21)
    b, d, m, h, w = 2, 9, 28, 64, 80
    masks = T(rng.random((b, d, m, m)) < 0.7)
    x1 = rng.uniform(-10, w - 10, (b, d))
    y1 = rng.uniform(-10, h - 10, (b, d))
    boxes = T(np.stack([x1, y1, x1 + rng.uniform(0.5, 50, (b, d)),
                        y1 + rng.uniform(0.5, 50, (b, d))],
                       -1).astype(np.float32))
    keep = T(rng.random((b, d)) > 0.2)
    scores = T((rng.random((b, d)) * 4).round().astype(np.float32) / 4)
    out_sizes = torch.tensor([[50, 72], [64, 40]], dtype=torch.int32)
    got_p, got_k = paste_claim_pack(masks, boxes, keep, scores, out_sizes,
                                    (h, w), min_pixels=min_pixels,
                                    do_remove_overlaps=overlaps, dtype=dtype)
    extent = torch.zeros(b, h, w, dtype=torch.bool)
    for i, (eh, ew) in enumerate(out_sizes.tolist()):
        extent[i, :eh, :ew] = True
    chain = paste_masks(masks.float(), boxes, (h, w), dtype=dtype)
    chain &= extent[:, None]
    if overlaps:
        order = torch.sort(-torch.where(keep, scores, torch.tensor(
            -np.inf)), dim=-1, stable=True).indices
        chain = morph.remove_overlaps(chain, order)
    want_k = keep & (chain.sum(dim=(2, 3)) >= min_pixels)
    assert torch.equal(got_k, want_k)
    assert torch.equal(got_p, pack_bitmasks(chain & want_k[..., None, None]))
    sel_p, sel_k = paste_select_pack(
        masks.float(), boxes, keep, scores, (h, w), min_pixels=min_pixels,
        do_remove_overlaps=overlaps, chunk=4, dtype=dtype, extent=extent)
    assert torch.equal(sel_p, got_p) and torch.equal(sel_k, got_k)
    assert got_p.any() or min_pixels == 50


# ----------------------------------------------------------------- resize

@pytest.mark.parametrize("scale", [0.78125, 0.5, 1.0, 1.7])
def test_device_resize_matches_scale_and_translate(scale):
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    want = np.asarray(j_device_resize(jnp.asarray(img), jnp.float32(scale),
                                      128, 160))
    got = device_resize(T(img), torch.tensor(scale), 128, 160).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("shape,out", [((1024, 1280), (800, 1000)),
                                       ((300, 417), (256, 356))])
def test_host_resize_within_two_levels_of_pil(shape, out):
    from PIL import Image

    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(out[::-1], Image.BILINEAR))
    got = host_resize(img, *out)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
