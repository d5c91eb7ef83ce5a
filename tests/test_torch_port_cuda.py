"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device (marker ``cuda``) and skip without one.  The
file imports no JAX, so on a machine with a card and no JAX it runs without
the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from uwcv_tpu_torch.ops.nms import (
    NMS_MAX_N,
    nms_greedy,
    nms_greedy_reference,
)
from uwcv_tpu_torch.ops.roi_align import (
    level_canvas,
    level_strides,
    roi_align_windows,
    roi_align_windows_reference,
    window_geometry,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _clustered(g, problems, n):
    ctr = torch.rand(problems, n, 2, generator=g) * 800
    size = torch.rand(problems, n, 2, generator=g) * 120 + 4
    return torch.cat([ctr - size / 2, ctr + size / 2], -1)


@pytest.mark.parametrize("problems,n,thr", [(40, 1000, 0.7), (8, 1024, 0.5),
                                            (3, 4096, 0.7), (2, 1, 0.5)])
def test_nms_kernel_keep_masks_identical(dev, problems, n, thr):
    g = torch.Generator().manual_seed(n)
    boxes = _clustered(g, problems, n).to(dev)
    valid = (torch.rand(problems, n, generator=g) < 0.9).to(dev)
    torch.testing.assert_close(nms_greedy(boxes, valid, thr),
                               nms_greedy_reference(boxes, valid, thr),
                               rtol=0, atol=0)


@pytest.mark.parametrize("thr", [0.0, 1.0])
@pytest.mark.parametrize("n", [1, 65, 1000, 1024, 4096, 8192])
def test_nms_kernel_edge_cases(dev, n, thr):
    """Word and block edges of the bit matrix, thresholds 0 and 1, N copies
    of one box, and an all-invalid problem."""
    g = torch.Generator().manual_seed(n + 1)
    boxes = _clustered(g, 3, n)
    boxes[1] = boxes[1, :1]
    valid = torch.rand(3, n, generator=g) < 0.9
    valid[1] = True
    valid[2] = False
    boxes, valid = boxes.to(dev), valid.to(dev)
    got = nms_greedy(boxes, valid, thr)
    torch.testing.assert_close(got, nms_greedy_reference(boxes, valid, thr),
                               rtol=0, atol=0)
    assert not got[2].any()


def test_nms_kernel_rejects_too_many_boxes(dev):
    boxes = torch.zeros(1, NMS_MAX_N + 1, 4, device=dev)
    with pytest.raises(ValueError):
        nms_greedy(boxes, torch.ones(1, NMS_MAX_N + 1, dtype=torch.bool,
                                     device=dev), 0.5)


def _pool_args(dev, dtype, c, p, r):
    g = torch.Generator().manual_seed(c + p)
    feats = {f"p{l}": torch.randn(2, 128 >> (l - 2), 160 >> (l - 2), c,
                                  generator=g).to(dev, dtype)
             for l in range(2, 6)}
    canvas, shapes = level_canvas(feats, 32)
    ctr = torch.rand(r, 2, generator=g) * 600
    wh = torch.rand(r, 2, generator=g) * 300 + 4
    rois = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    if r > 1:
        rois[0] = torch.tensor([10.0, 200.0, 630.0, 230.0])   # image-wide bar
        rois[1] = 0.0                                          # invalid slot
    li, y0, x0, wy, wx = window_geometry(
        rois.to(dev), shapes, level_strides({f"p{l}": 2 ** l
                                             for l in range(2, 6)}),
        p, 224.0, 4, 2, 32)
    slab = (li + 5 * (torch.arange(r, device=dev) % 2)).to(torch.int32)
    return canvas, slab, y0.to(torch.int32), x0.to(torch.int32), wy, wx


@pytest.mark.parametrize("r", [0, 1, 8000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,p", [(64, 7), (64, 14), (256, 7), (256, 14)])
def test_roi_align_kernel_matches_plain(dev, dtype, c, p, r):
    """f32: max error <= 1e-4·max|ref|; bf16: <= 2e-2·max|ref| (the
    contraction order differs, and ``rows`` is rounded to bf16)."""
    args = _pool_args(dev, dtype, c, p, r)
    got = roi_align_windows(*args).float()
    want = roi_align_windows_reference(*args).float()
    assert got.shape == (r, p, p, c)
    if r:
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        assert (got - want).abs().max() <= tol * want.abs().max()


def test_roi_align_kernel_rejects_unaligned_channels(dev):
    args = _pool_args(dev, torch.bfloat16, 64, 7, 4)
    canvas = torch.zeros(args[0].shape[:-1] + (12,), dtype=torch.bfloat16,
                         device=dev)
    with pytest.raises(ValueError):
        roi_align_windows(canvas, *args[1:])


def test_chip_smoke_against_compares_two_packages(dev):
    """``chip_smoke.py --against DIR``'s comparison, with this checkout on
    both sides: each side's wrappers run in their own process on the same
    saved inputs, their outputs agree, and each wrapper gets four turns."""
    import chip_smoke

    roi = {p: _pool_args(dev, torch.bfloat16, 64, p, 200) for p in (7, 14)}
    g = torch.Generator().manual_seed(3)
    valid = torch.ones(4, 300, dtype=torch.bool, device=dev)
    nms = [(_clustered(g, 4, 300).to(dev), valid, 0.7)]
    got = chip_smoke.compare_against(chip_smoke.REPO, roi, nms)
    assert sorted(got) == ["nms_greedy (both calls)",
                           "roi_align_windows P=14", "roi_align_windows P=7"]
    for rec in got.values():
        assert len(rec["turns_ms"]) == 4
        assert all(t > 0 for t in rec["turns_ms"])
