"""The yardstick's operation and byte counts: the model's FLOPs against
``torch.utils.flop_counter.FlopCounterMode`` on the plain reference at a
small size, and the RoIAlign bounds against counts worked by hand."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import common, flops
from benchmark.harness import weights as W
from benchmark.reference import maskrcnn as R


@pytest.fixture(scope="module")
def small():
    m = dict(common.load_json(common.BENCH + "/configs/mask_rcnn_R50_FPN_3x"
                              ".json")["config"]["model"])
    m.update(depth=26, fpn_channels=32, box_fc_dim=64)
    init = {"cls_std": 0.1, "cls_bias0": 0.0, "mask_bias": 4.0,
            "stem_bn_scale": 1 / 64, "bn3_scale": 0.5}
    w = W.make(m, init, 3, torch.device("cpu"))
    return m, R.Net(w, m["depth"], m["num_classes"])


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("hw", [(128, 192), (160, 96)])
def test_trunk_fpn_rpn_flops(small, hw):
    m, net = small
    img = torch.rand((1,) + hw + (3,)) * 255

    def run():
        with torch.no_grad():
            net.rpn(net.features(img, m["pixel_mean"]))

    assert counted(run) == pytest.approx(
        sum(f for _, f in flops.trunk_layers(m, *hw)), rel=1e-9)


@pytest.mark.parametrize("rois", [1, 5])
def test_head_flops(small, rois):
    m, net = small
    c = m["fpn_channels"]
    pb = torch.rand(rois, 7, 7, c)
    pm = torch.rand(rois, 14, 14, c)
    with torch.no_grad():
        assert counted(lambda: net.box_head(pb)) == pytest.approx(
            flops.box_head(m, rois), rel=1e-9)
        assert counted(lambda: net.mask_head(pm)) == pytest.approx(
            flops.mask_head(m, rois), rel=1e-9)


def test_roi_align_bounds_by_hand():
    """One 28×28 px roi at the origin of a [5, 64, 64, 8] bf16 canvas: it
    pools from p2 (stride 4), its 14 samples a side fall in cells 0..7
    (the last with weight 0.25), so 8 × 8 cells are read."""
    rois = torch.tensor([[[0.0, 0.0, 28.0, 28.0]]])
    lv = [(64, 64), (32, 32), (16, 16), (8, 8), (4, 4)]
    by, fl = flops.roi_align_bound((5, 64, 64, 8), 2, rois, lv, 7, 32)
    assert by == 64 * 8 * 2 + 2 * 7 * 32 * 4 + 3 * 4 + 7 * 7 * 8 * 2
    assert fl == 2 * 7 * 8 * (8 * 8 + 7 * 8)
    by, fl = flops.roi_align_bwd_bound((5, 64, 64, 8), 2, rois, lv, 7, 32)
    assert by == 7 * 7 * 8 * 2 + 2 * 7 * 32 * 4 + 3 * 4 + 5 * 64 * 64 * 8 * 2
    assert fl == 2 * 7 * 8 * (7 * 8 + 8 * 8)


def test_train_step_counts_only_what_trains(small):
    m, _ = small
    solver = {"freeze_at": 2}
    fwd = sum(f for _, f in flops.trunk_layers(m, 64, 64))
    heads = flops.box_head(m, 4) + flops.mask_head(m, 1)
    step = flops.train_step(m, solver, 64, 1, 4, 1)
    frozen = sum(f for p, f in flops.trunk_layers(m, 64, 64)
                 if "stem_" in p or "res2_block" in p)
    # forward everything, the heads three times, no backward below res3
    assert fwd + 3 * heads < step < 3 * (fwd - frozen) + frozen + 3 * heads
