"""The cells' runs at a size the CPU holds (``tiny.py``), the look for a
card skipped: the program in float32 is correct; the control, the plain
reference in float8 in the program's place, is not; nor is a run with the
timed path broken underneath, once for each fault the cell can have.  The
limits are the configurations' own."""

import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import control
from benchmark.harness import common, predict_cell, train_cell
from benchmark.tests import tiny


def run_cell(workload, seed=2147483659):
    ctx = tiny.ctx(workload)
    driver = {tiny.TRAIN: train_cell, tiny.PREDICT: predict_cell}[workload]
    out = driver.run(ctx, tiny.args(seed=seed), time.perf_counter())
    checks = common.checks_block(out["numbers"], out["limits"])
    return common.passed(checks), checks, out


KIND = {tiny.TRAIN: "train", tiny.PREDICT: "predict"}


@pytest.mark.parametrize("workload", [tiny.PREDICT, tiny.TRAIN])
def test_program_is_correct(workload):
    ok, checks, out = run_cell(workload)
    assert ok, checks
    assert out["result"]["metrics"]["setup_s"]["value"] > 0
    assert set(checks) == set(
        common.cell(workload)["config"]["limits"][KIND[workload]])


def test_predict_checks_something():
    _, _, out = run_cell(tiny.PREDICT)
    assert out["numbers"]["rpn_logit_gap"] >= 0


@pytest.mark.parametrize("workload", [tiny.PREDICT, tiny.TRAIN])
def test_control_is_refused(workload):
    ctx = tiny.ctx(workload)
    fn = control.train_control if workload == tiny.TRAIN else \
        control.predict_control
    numbers = fn(ctx, 2147483659, "fp8", torch.device("cpu"))
    kind = "train" if workload == tiny.TRAIN else "predict"
    checks = common.checks_block(numbers, ctx["config"]["limits"][kind])
    assert not common.passed(checks), checks


def _alter_outputs(monkeypatch, how):
    from uwcv_tpu_torch.engine import predictor

    orig = predictor.device_program

    def broken(*args, **kwargs):
        dets, packed, keep = orig(*args, **kwargs)
        if how == "scores":
            dets = dets._replace(scores=dets.scores * 0.9)
        elif how == "boxes":
            dets = dets._replace(boxes=dets.boxes + 2.0)
        elif how == "masks":
            packed = packed ^ 0x10
        elif how == "none kept":
            dets = dets._replace(valid=torch.zeros_like(dets.valid))
        elif how == "half kept":
            valid = dets.valid.clone()
            valid[:, ::2] = False
            dets = dets._replace(valid=valid)
        return dets, packed, keep

    monkeypatch.setattr(predictor, "device_program", broken)


@pytest.mark.parametrize("how", ["scores", "boxes", "masks", "none kept",
                                 "half kept"])
def test_predict_answer_altered_is_refused(monkeypatch, how):
    _alter_outputs(monkeypatch, how)
    ok, checks, _ = run_cell(tiny.PREDICT)
    assert not ok, checks
    if how.endswith("kept"):
        assert checks["det_missed_gap"]["value"] > \
            checks["det_missed_gap"]["limit"]


@pytest.mark.parametrize("how", ["shifted", "half dropped"])
def test_predict_proposals_altered_is_refused(monkeypatch, how):
    """Proposals the RPN gets wrong where it makes them: boxes moved off
    their anchors' decodes, or half of them dropped."""
    from uwcv_tpu_torch.models import rcnn

    orig = rcnn.generate_proposals

    def broken(*args, **kwargs):
        out = orig(*args, **kwargs)
        if how == "shifted":
            return out._replace(boxes=out.boxes + 24.0)
        valid = out.valid.clone()
        valid[:, ::2] = False
        return out._replace(valid=valid)

    monkeypatch.setattr(rcnn, "generate_proposals", broken)
    ok, checks, _ = run_cell(tiny.PREDICT)
    assert not ok, checks
    assert checks["rpn_missed_gap"]["value"] > \
        checks["rpn_missed_gap"]["limit"]


def test_predict_mask_head_zeroed_is_refused(monkeypatch):
    """A mask head whose logits are all 0 where it makes them: no pixel
    clears 0.5, and the solid masks go missing."""
    from uwcv_tpu_torch.models.heads import MaskHead

    orig = MaskHead.forward
    monkeypatch.setattr(MaskHead, "forward",
                        lambda self, x: torch.zeros_like(orig(self, x)))
    ok, checks, _ = run_cell(tiny.PREDICT)
    assert not ok, checks
    assert checks["mask_gap"]["value"] > 0.5


def test_train_state_unchanged_is_refused(monkeypatch):
    from uwcv_tpu_torch.engine.trainer import Trainer

    monkeypatch.setattr(Trainer, "_apply_gradients", lambda self: None)
    ok, checks, _ = run_cell(tiny.TRAIN)
    assert not ok, checks
    assert checks["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_is_refused(monkeypatch):
    from uwcv_tpu_torch.models.rcnn import MaskRCNN

    orig = MaskRCNN.forward_train

    def half(self, images, boxes, classes, masks, valid, **kw):
        h = images.shape[0] // 2
        return orig(self, images[:h], boxes[:h], classes[:h], masks[:h],
                    valid[:h], **kw)

    monkeypatch.setattr(MaskRCNN, "forward_train", half)
    ok, checks, _ = run_cell(tiny.TRAIN)
    assert not ok, checks


def test_train_loss_altered_is_refused(monkeypatch):
    from uwcv_tpu_torch.models.rcnn import MaskRCNN

    orig = MaskRCNN.forward_train

    def altered(self, *args, **kw):
        losses = orig(self, *args, **kw)
        losses["mask"] = losses["mask"] * 1.05
        return losses

    monkeypatch.setattr(MaskRCNN, "forward_train", altered)
    ok, checks, _ = run_cell(tiny.TRAIN)
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [tiny.PREDICT, tiny.TRAIN])
def test_cell_on_the_card(workload, tmp_path):
    """The full cell, a short window, on a card: a result line with
    ``correct`` true."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(common.BENCH, "run.py"), "--workload",
         workload, "--seed", "2147483671", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=1200,
        env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-4000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]
