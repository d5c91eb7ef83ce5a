"""The port's predictor over a mesh of devices (``Predictor(mesh=...)``,
``run_batch_inference``'s tail rule) on the CPU: a mesh of two CPU
devices against the single-device predictor, with the committed gate
checkpoint in f32 on the gate split."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from torch_port_harness import hang_report, hang_report_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
SPLIT = os.path.join(REPO, "tests", "data", "gate_split")
GATE_CKPT = os.path.join(REPO, "assets", "gate", "gate_ckpt.npz")


def _cfg(output_dir):
    from uwcv_tpu_torch.config import Config

    with open(os.path.join(SPLIT, "jax", "gate_config.json")) as f:
        cfg = Config.from_dict(json.load(f))
    cfg.data.classes_csv = os.path.join(SPLIT, "classes.csv")
    cfg.output_dir = str(output_dir)
    return cfg


def _pngs():
    return sorted(os.path.join(SPLIT, "Test", f)
                  for f in os.listdir(os.path.join(SPLIT, "Test"))
                  if f.endswith(".png"))


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    from uwcv_tpu_torch.config import ParallelConfig
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.parallel.mesh import build_mesh
    from uwcv_tpu_torch.weights import load_npz

    cfg = _cfg(tmp_path_factory.mktemp("out"))
    params = load_npz(GATE_CKPT)
    mesh = build_mesh(ParallelConfig(), devices=["cpu", "cpu"])
    return (cfg, Predictor(cfg, params, mesh=mesh),
            Predictor(cfg, params, device="cpu"))


def test_mesh_predictor_equals_the_single_device_one_on_each_half(
        predictors):
    """A batch of 4 over ``[cpu, cpu]`` gives the single-device
    predictor's Instances on each half of 2: valid, classes and masks
    equal, boxes and scores within rtol 1e-5; each replica holds the
    weights; a batch that does not tile the data axis raises."""
    from uwcv_tpu_torch.data.loader import load_image_rgb

    _, pred, single = predictors
    assert len(pred.replicas) == 2 and pred.replicas[0] is not \
        pred.replicas[1]
    for a, b in zip(pred.replicas[0].parameters(),
                    pred.replicas[1].parameters()):
        assert torch.equal(a, b)
    images = [load_image_rgb(p) for p in _pngs()[:4]]
    got = pred.predict_batch(images)
    want = single.predict_batch(images[:2]) + single.predict_batch(images[2:])
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.valid, w.valid)
        np.testing.assert_array_equal(g.classes, w.classes)
        np.testing.assert_array_equal(g.masks, w.masks)
        np.testing.assert_allclose(g.boxes, w.boxes, rtol=1e-5)
        np.testing.assert_allclose(g.scores, w.scores, rtol=1e-5)
        assert g.image_size == w.image_size
    assert sum(int(g.valid.sum()) for g in got) > 0
    with pytest.raises(ValueError, match="does not tile"):
        pred.predict_batch(images[:3])


def test_set_params_refills_every_replica(predictors):
    from uwcv_tpu_torch.weights import load_npz, params_to_flax

    cfg, pred, _ = predictors
    params = load_npz(GATE_CKPT)
    key = next(k for k in params if k.endswith("kernel"))
    changed = dict(params)
    changed[key] = params[key] + 1.0
    try:
        pred.set_params(changed)
        for replica in pred.replicas:
            np.testing.assert_array_equal(params_to_flax(replica)[key],
                                          changed[key])
    finally:
        pred.set_params(params)


def test_batch_inference_pads_the_tail_to_the_data_axis(predictors,
                                                       tmp_path):
    """``run_batch_inference`` over 3 gate images at batch 3 on the
    two-device mesh runs the chunk as 4 (its last image repeated) and
    writes the single-device run's CSVs: the same ImageIds and row
    counts, each row's mask at IoU ≥ 0.99."""
    import chip_smoke
    from uwcv_tpu_torch.engine.batch_inference import run_batch_inference

    cfg, pred, single = predictors
    image_dir = tmp_path / "images"
    image_dir.mkdir()
    for p in _pngs()[:3]:
        shutil.copy(p, image_dir)
    seen = []
    run = pred.predict_batch_device

    def spy(images, block=True):
        seen.append(len(images))
        return run(images, block=block)

    pred.predict_batch_device = spy
    try:
        runs = {}
        for name, p in (("mesh", pred), ("single", single)):
            c = _cfg(tmp_path / name)
            runs[name] = run_batch_inference(
                c, p, image_dir=str(image_dir), batch_size=3,
                progress=lambda *_: None)
    finally:
        del pred.predict_batch_device
    assert seen == [4]
    assert runs["mesh"]["num_images"] == 3
    assert sorted(runs["mesh"]["predictions"]) == sorted(
        runs["single"]["predictions"])
    rec = chip_smoke.compare_folder_csvs(
        str(tmp_path / "mesh"), str(tmp_path / "single"),
        {os.path.basename(p): (256, 256) for p in _pngs()})
    assert rec["rows"] > 0 and rec["worst_iou"] >= 0.99
    assert chip_smoke.check_rows_decode(runs["mesh"]) == rec["rows"]
