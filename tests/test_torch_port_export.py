"""The port's export and artifact serving (``uwcv_tpu_torch/engine/
export.py``, ``Predictor.from_exported``) on the CPU, in f32.

The committed gate checkpoint (R26 / FPN-64 / box-FC-256) is exported once
for the module at batch 4 on the 256² canvas of the golden's config, saved
and loaded into a ``Predictor.from_exported`` that builds no model.  Its
outputs are held against the live port predictor (valid, classes and masks
equal; boxes and scores within ``tests/test_export.py``'s tolerances) and
against the JAX package's outputs committed in
``tests/data/torch_port_gate_golden.npz`` (the tolerances of
``tests/test_torch_port_predictor.py``).  The program's ops are checked
with ``torch.library.opcheck``.
"""

import json
import os
import shutil
import zipfile

import numpy as np
import pytest
import torch

from torch_port_harness import hang_report, hang_report_module  # noqa: F401
from uwcv_tpu_torch.config import Config
from uwcv_tpu_torch.engine.export import META, export_predictor, read_meta
from uwcv_tpu_torch.engine.predictor import Predictor
from uwcv_tpu_torch.weights import load_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_gate_golden.npz")
GATE_CKPT = os.path.join(REPO, "assets", "gate", "gate_ckpt.npz")
SPLIT = os.path.join(REPO, "tests", "data", "gate_split")
BATCH = 4
# served vs live port (tests/test_export.py:49-55)
BOX_TOL = dict(rtol=1e-5, atol=1e-4)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


def _golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _gate_cfg():
    return Config.from_dict(json.loads(str(_golden()["config_json"])))


def _rgb(gray):
    return np.repeat(gray, 3, axis=-1)


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    """One export for the module: the live predictor, the artifact, the
    served predictor and both sides' outputs on the golden's images."""
    cfg = _gate_cfg()
    live = Predictor(cfg, load_npz(GATE_CKPT), device="cpu")
    path = str(tmp_path_factory.mktemp("export") / "gate.pt2")
    export_predictor(live, path, batch_size=BATCH, canvas=(256, 256))
    served = Predictor.from_exported(cfg, path, device="cpu")
    images = [_rgb(im) for im in _golden()["images"]]
    return {"cfg": cfg, "live": live, "path": path, "served": served,
            "images": images, "want": live.predict_batch(images),
            "got": served.predict_batch(images)}


def _assert_same(got, want):
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_array_equal(got.classes, want.classes)
    np.testing.assert_array_equal(got.masks, want.masks)
    np.testing.assert_allclose(got.boxes, want.boxes, **BOX_TOL)
    np.testing.assert_allclose(got.scores, want.scores, **SCORE_TOL)
    assert got.image_size == want.image_size


def test_served_predictor_has_no_model(gate, monkeypatch):
    """``from_exported`` loads the program without building ``MaskRCNN``;
    its weights are baked in, so ``set_params`` raises."""
    from uwcv_tpu_torch.models import rcnn

    def no_model(*_args, **_kwargs):
        raise AssertionError("a served predictor built MaskRCNN")

    monkeypatch.setattr(rcnn.MaskRCNN, "__init__", no_model)
    served = Predictor.from_exported(gate["cfg"], gate["path"], device="cpu")
    assert served.model is None
    assert served.exported_batch == BATCH
    assert served.exported_canvas == (256, 256)
    assert read_meta(gate["path"])["device"] == "cpu"
    with pytest.raises(ValueError, match="baked"):
        served.set_params(load_npz(GATE_CKPT))
    insts = served.predict_batch(gate["images"][:1])
    _assert_same(insts[0], gate["want"][0])


def test_program_keeps_the_kernel_ops_and_the_loops(gate):
    """The saved program calls B1 twice (box and mask poolers) and B2
    twice (RPN and detections) as the ``uwcv`` ops, keeps the two floods
    as ``while_loop``s and the unit-scale branch as a ``cond``."""
    graph = torch.export.load(gate["path"]).graph
    targets = [str(n.target) for n in graph.nodes
               if n.op == "call_function"]
    count = lambda name: sum(t == name for t in targets)
    assert count("uwcv.roi_align_windows.default") == 2
    assert count("uwcv.nms_greedy.default") == 2
    assert count("while_loop") == 2
    assert count("cond") == 1


def test_program_keeps_the_trunk_epilogue_op(gate):
    """The saved program calls ``uwcv::frozen_bn_act`` once a conv
    epilogue of the gate's ResNet-26: the stem and three a block."""
    graph = torch.export.load(gate["path"]).graph
    assert sum(str(n.target) == "uwcv.frozen_bn_act.default"
               for n in graph.nodes if n.op == "call_function") == 13


@pytest.mark.parametrize("i", range(BATCH))
def test_served_matches_live_port_predictor(gate, i):
    assert gate["want"][i].valid.any()
    _assert_same(gate["got"][i], gate["want"][i])


@pytest.mark.parametrize("i", range(BATCH))
def test_served_matches_jax_golden(gate, i):
    """The exported program against the JAX package's committed outputs
    on the same images and weights: valid counts and classes equal, boxes
    within 1e-2 px, scores within 1e-4, mask IoU >= 0.99."""
    g = _golden()
    got = gate["got"][i]
    v, w = got.valid, g["valid"][i]
    assert v.sum() == w.sum() > 0
    np.testing.assert_array_equal(got.classes[v], g["classes"][i][w])
    np.testing.assert_allclose(got.boxes[v], g["boxes"][i][w], atol=1e-2)
    np.testing.assert_allclose(got.scores[v], g["scores"][i][w], atol=1e-4)
    want_masks = np.unpackbits(g["masks"][i][:int(w.sum())],
                               axis=-1).astype(bool)
    for a, b in zip(got.masks[v], want_masks):
        union = np.logical_or(a, b).sum()
        assert union == 0 or np.logical_and(a, b).sum() / union >= 0.99


def test_partial_batch_pads_in_and_slices_out(gate):
    got = gate["served"].predict_batch(gate["images"][:2])
    assert len(got) == 2
    for a, b in zip(got, gate["want"][:2]):
        _assert_same(a, b)


def test_grayscale_and_color_batches(gate):
    """Gray batches ship one channel, which the loader re-broadcasts; a
    color batch ships three.  Both match the live predictor."""
    served, live = gate["served"], gate["live"]
    ops, _ = served.stage_batch(gate["images"][:2])
    assert ops[0].shape[-1] == 1
    rng = np.random.default_rng(0)
    color = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8),
             gate["images"][0]]
    ops, _ = served.stage_batch(color)
    assert ops[0].shape[-1] == 3
    for a, b in zip(served.predict_batch(color), live.predict_batch(color)):
        _assert_same(a, b)


def test_smaller_canvas_and_scales_match_live(gate):
    """Images that ship on a smaller canvas than the artifact's, which the
    loader pads in: a 200×180 one is upscaled on the device (the host
    resizes only downscales), so the program's ``torch.cond`` takes the
    resample branch; a 150×256 one keeps scale 1 and takes the unit-scale
    branch.  Both match the live predictor run at the artifact's
    canvas."""
    live, served = gate["live"], gate["served"]
    rng = np.random.default_rng(1)
    for shape, scale in (((200, 180), 1.28), ((150, 256), 1.0)):
        img = _rgb(rng.integers(0, 256, shape + (1,), dtype=np.uint8))
        ops, unmap = live.stage_batch([img])
        assert ops[0].shape[1:3] != (256, 256)
        np.testing.assert_allclose(ops[1], [scale])
        out = live._run(ops[0], ops[1], ops[2], (256, 256))
        want = live.to_instances(out + tuple(unmap))[0]
        _assert_same(served.predict_batch([img])[0], want)


def test_oversized_batch_or_canvas_raises(gate):
    served = gate["served"]
    with pytest.raises(ValueError, match="batch"):
        served.predict_batch(gate["images"] + gate["images"][:1])
    images = torch.zeros((1, 320, 256, 1), dtype=torch.uint8)
    with pytest.raises(ValueError, match="canvas"):
        served._run(images, np.ones(1, np.float32),
                    torch.tensor([[256, 256]], dtype=torch.int32))


def test_artifact_runs_only_on_its_device_type(gate, tmp_path):
    """An artifact whose record names another device type than the one
    asked for raises with a message, before loading the program."""
    from uwcv_tpu_torch.engine.export import load_exported

    other = tmp_path / "cuda.pt2"
    with zipfile.ZipFile(gate["path"]) as src, \
            zipfile.ZipFile(other, "w") as dst:
        for item in src.infolist():
            data = src.read(item)
            if item.filename.endswith(META):
                meta = json.loads(data)
                meta["device"] = "cuda"
                data = json.dumps(meta).encode()
            dst.writestr(item, data)
    with pytest.raises(ValueError, match="exported for cuda"):
        load_exported(str(other), device="cpu")


def test_serve_forever_caps_the_batch_at_the_artifact(gate, tmp_path,
                                                      monkeypatch):
    from uwcv_tpu_torch.engine.serve import serve_forever

    watch = tmp_path / "watch"
    watch.mkdir()
    names = sorted(f for f in os.listdir(os.path.join(SPLIT, "Test"))
                   if f.endswith(".png"))[:6]
    for name in names:
        shutil.copy(os.path.join(SPLIT, "Test", name), watch / name)
    served = gate["served"]
    sizes = []
    predict = served.predict_batch

    def counted(images):
        sizes.append(len(images))
        return predict(images)

    monkeypatch.setattr(served, "predict_batch", counted)
    n = serve_forever(gate["cfg"], served, str(watch), str(tmp_path / "out"),
                      batch_size=16, once=True, progress=lambda *_: None)
    assert n == 6 and sizes == [BATCH, 2]
    assert len(list((tmp_path / "out").glob("*.json"))) == 6


def test_cli_export_then_serve_artifact(tmp_path, capsys):
    """``export`` and ``serve --artifact --once`` through the CLI on a
    ``synth`` folder of 256² images: the served JSONs equal those of a live
    ``serve --once`` over the same images."""
    from uwcv_tpu_torch.cli.main import main

    cli = lambda *argv: main([str(a) for a in argv])
    assert cli("synth", "--root", tmp_path / "ds", "--train", 0, "--test",
               0, "--infer", 3, "--size", 256) == 0
    watch = tmp_path / "ds" / "INFERENCE"
    assert len(list(watch.iterdir())) == 3
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    shutil.copy(GATE_CKPT, ckpt / "gate_ckpt.npz")
    (ckpt / "config.json").write_text(json.dumps(
        {"model": _gate_cfg().model.__dict__}, default=list))
    common = ["--device", "cpu", "-o", "input.test_short_edge=256",
              "-o", "input.test_max_size=256",
              "-o", "input.pad_size_test=256,256",
              "-o", "model.dtype=float32"]
    artifact = tmp_path / "gate.pt2"
    assert cli("export", "--weights", ckpt / "gate_ckpt.npz", "--path",
               artifact, "--batch-size", 2, *common) == 0
    assert f"wrote {artifact}" in capsys.readouterr().out
    assert cli("serve", "--artifact", artifact, "--watch-dir", watch,
               "--out-dir", tmp_path / "served", "--once", *common) == 0
    assert "served 3 images" in capsys.readouterr().out
    assert cli("serve", "--weights", ckpt / "gate_ckpt.npz", "--watch-dir",
               watch, "--out-dir", tmp_path / "live", "--batch-size", 2,
               "--once", *common) == 0
    served = sorted((tmp_path / "served").glob("*.json"))
    assert len(served) == 3
    for path in served:
        got = json.loads(path.read_text())
        want = json.loads((tmp_path / "live" / path.name).read_text())
        assert got == want
    assert any(json.loads(p.read_text())["num_instances"] for p in served)


def test_roi_align_op_passes_opcheck():
    from uwcv_tpu_torch.ops.roi_align import (
        level_shapes,
        level_strides,
        window_geometry,
    )

    g = torch.Generator().manual_seed(0)
    canvas = torch.randn(5, 32, 32, 8, generator=g)
    rois = torch.tensor([[4.0, 4.0, 40.0, 30.0], [0.0, 0.0, 100.0, 120.0],
                         [60.0, 50.0, 64.0, 58.0]])
    shapes = level_shapes([(32, 32, 8), (16, 16, 8), (8, 8, 8), (4, 4, 8)])
    li, y0, x0, wy, wx = window_geometry(
        rois, shapes, level_strides({"p2": 4, "p3": 8, "p4": 16, "p5": 32}),
        7, 224.0, 4, 2, 16)
    args = (canvas, li.int(), y0.int(), x0.int(), wy, wx)
    torch.library.opcheck(torch.ops.uwcv.roi_align_windows.default, args)
    assert torch.ops.uwcv.roi_align_windows(*args).shape == (3, 7, 7, 8)


def test_nms_op_passes_opcheck():
    from uwcv_tpu_torch.ops.nms import nms_greedy_reference

    g = torch.Generator().manual_seed(1)
    ctr = torch.rand(3, 40, 2, generator=g) * 100
    size = torch.rand(3, 40, 2, generator=g) * 30 + 2
    boxes = torch.cat([ctr - size / 2, ctr + size / 2], -1)
    valid = torch.rand(3, 40, generator=g) < 0.9
    torch.library.opcheck(torch.ops.uwcv.nms_greedy.default,
                          (boxes, valid, 0.5))
    assert torch.equal(torch.ops.uwcv.nms_greedy(boxes, valid, 0.5),
                       nms_greedy_reference(boxes, valid, 0.5))


def test_paste_claim_pack_op_passes_opcheck():
    from uwcv_tpu_torch.ops.mask_paste import paste_claim_pack_reference

    g = torch.Generator().manual_seed(2)
    masks = torch.rand(2, 6, 28, 28, generator=g) < 0.6
    ctr = torch.rand(2, 6, 2, generator=g) * 40
    size = torch.rand(2, 6, 2, generator=g) * 30 + 2
    boxes = torch.cat([ctr - size / 2, ctr + size / 2], -1)
    keep = torch.rand(2, 6, generator=g) < 0.8
    scores = torch.rand(2, 6, generator=g)
    out_sizes = torch.tensor([[40, 48], [32, 40]], dtype=torch.int32)
    args = (masks, boxes, keep, scores, out_sizes, 40, 48, 2, True,
            torch.float32)
    torch.library.opcheck(torch.ops.uwcv.paste_claim_pack.default, args)
    for got, want in zip(torch.ops.uwcv.paste_claim_pack(*args),
                         paste_claim_pack_reference(*args)):
        assert torch.equal(got, want)
