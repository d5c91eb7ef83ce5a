"""The port's folder path (``engine/batch_inference.py``, ``engine/serve.py``,
``cli/main.py``) against the JAX package on the committed gate split, in f32
on the CPU.

``tests/data/gate_split/`` holds the gate held-out split exactly as
``tools/make_gate_ckpt.ensure_gate_dataset`` writes it (12 PNGs, their
SuperAnnotate JSONs, ``classes.csv``) and, under ``jax/``, what the JAX
package makes of it with the gate checkpoint: its folder CSVs
(``R50_flip_.csv``, ``ShapeDescriptor.csv``), its gate APs through the
scanline rasterizer (``gate_ap.json``) and the config of both runs
(``gate_config.json``).  ``chip_smoke.py`` holds the port against them on
the GPU.  Regenerate them with

    JAX_PLATFORMS=cpu python tests/test_torch_port_folder.py
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from torch_port_harness import hang_report, hang_report_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SPLIT = os.path.join(REPO, "tests", "data", "gate_split")
JAX_OUT = os.path.join(SPLIT, "jax")
GATE_CKPT = os.path.join(REPO, "assets", "gate", "gate_ckpt.npz")
CSVS = ("R50_flip_.csv", "ShapeDescriptor.csv")
BATCH = 8


def jax_gate_config(output_dir):
    """The gate model in f32 with the committed split's classes.csv."""
    from tools.make_gate_ckpt import gate_config

    cfg = gate_config(SPLIT)
    cfg.model.dtype = "float32"
    cfg.output_dir = output_dir
    return cfg


def config_sections(cfg):
    """What ``gate_config.json`` holds: the sections both runs share."""
    return {s: getattr(cfg, s).__dict__
            for s in ("model", "input", "postprocess", "measure")}


def jax_gate_outputs(work):
    """The JAX package on the committed split: {file name: bytes} of its
    folder CSVs, its gate APs (scanline rasterizer) and its serve records
    (batch 8)."""
    import jax

    import uwcv_tpu.data.rasterize as rasterize
    from uwcv_tpu.data.superannotate import get_superannotate_dicts
    from uwcv_tpu.engine.batch_inference import run_batch_inference
    from uwcv_tpu.engine.checkpoint import load_params_npz
    from uwcv_tpu.engine.predictor import Predictor
    from uwcv_tpu.engine.serve import serve_forever
    from uwcv_tpu.eval.coco_eval import evaluate_split
    from uwcv_tpu.models.rcnn import MaskRCNN, init_params

    cfg = jax_gate_config(os.path.join(work, "jax_out"))
    params = load_params_npz(GATE_CKPT, init_params(MaskRCNN(cfg.model),
                                                    jax.random.key(0)))
    pred = Predictor(cfg, params)
    run_batch_inference(cfg, pred, image_dir=os.path.join(SPLIT, "Test"),
                        batch_size=BATCH, progress=lambda *_: None)
    out = {}
    for name in CSVS:
        with open(os.path.join(cfg.output_dir, name), "rb") as f:
            out[name] = f.read()
    saved, rasterize._HAS_PIL = rasterize._HAS_PIL, False
    try:
        dicts = get_superannotate_dicts(os.path.join(SPLIT, "Test"))
        res = evaluate_split(cfg, dicts, predictor=pred, batch_size=BATCH)
    finally:
        rasterize._HAS_PIL = saved
    out["gate_ap.json"] = json.dumps(
        {"segm_AP": res["segm"]["AP"], "bbox_AP": res["bbox"]["AP"],
         "rasterizer": "uwcv_tpu.data.rasterize._scanline_fill",
         "results": res}, indent=1, sort_keys=True).encode()
    out["gate_config.json"] = json.dumps(config_sections(cfg), indent=1,
                                         sort_keys=True, default=list).encode()
    serve_dir = os.path.join(work, "jax_served")
    serve_forever(cfg, pred, os.path.join(SPLIT, "Test"), serve_dir,
                  batch_size=BATCH, once=True, progress=lambda *_: None)
    records = {}
    for name in sorted(os.listdir(serve_dir)):
        with open(os.path.join(serve_dir, name)) as f:
            records[name] = json.load(f)
    return out, records


def write_gate_data():
    """Regenerate everything under tests/data/gate_split/."""
    import tempfile

    from tools.make_gate_ckpt import ensure_gate_dataset

    work = tempfile.mkdtemp(prefix="gate_split_")
    ensure_gate_dataset(work)
    shutil.rmtree(SPLIT, ignore_errors=True)
    shutil.copytree(os.path.join(work, "Test"), os.path.join(SPLIT, "Test"))
    shutil.copy(os.path.join(work, "classes.csv"), SPLIT)
    out, _ = jax_gate_outputs(work)
    os.makedirs(JAX_OUT, exist_ok=True)
    for name, data in out.items():
        with open(os.path.join(JAX_OUT, name), "wb") as f:
            f.write(data)
    return SPLIT


# ------------------------------------------------------------------- tests

def _image_hw(names):
    return {n: (256, 256) for n in names}


def _port_cfg(output_dir, paste_chunk=0):
    from uwcv_tpu_torch.config import Config

    with open(os.path.join(JAX_OUT, "gate_config.json")) as f:
        cfg = Config.from_dict(json.load(f))
    cfg.data.classes_csv = os.path.join(SPLIT, "classes.csv")
    cfg.output_dir = output_dir
    cfg.postprocess.paste_chunk = paste_chunk
    return cfg


def _png_names():
    return sorted(f for f in os.listdir(os.path.join(SPLIT, "Test"))
                  if f.endswith(".png"))


@pytest.fixture(scope="module")
def jax_gate(tmp_path_factory):
    return jax_gate_outputs(str(tmp_path_factory.mktemp("jax_gate")))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's folder run on the CPU, unfused and with paste_chunk=10."""
    from uwcv_tpu_torch.engine.batch_inference import run_batch_inference
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.weights import load_npz

    params = load_npz(GATE_CKPT)
    runs = {}
    for chunk in (0, 10):
        cfg = _port_cfg(str(tmp_path_factory.mktemp(f"port_{chunk}")), chunk)
        pred = Predictor(cfg, params, device="cpu")
        runs[chunk] = run_batch_inference(
            cfg, pred, image_dir=os.path.join(SPLIT, "Test"),
            batch_size=BATCH, progress=lambda *_: None)
    return runs


def test_committed_split_is_current(tmp_path):
    """The committed PNGs, JSONs and classes.csv are byte for byte what
    ``ensure_gate_dataset`` writes today."""
    from tools.make_gate_ckpt import ensure_gate_dataset

    ensure_gate_dataset(str(tmp_path))
    names = sorted(os.listdir(tmp_path / "Test"))
    assert names == sorted(os.listdir(os.path.join(SPLIT, "Test")))
    for rel in ["classes.csv"] + [os.path.join("Test", n) for n in names]:
        with open(os.path.join(SPLIT, rel), "rb") as f:
            assert f.read() == (tmp_path / rel).read_bytes(), rel


def test_committed_jax_outputs_are_current(jax_gate, tmp_path):
    """The committed JAX CSVs, APs and config equal what the JAX package
    gives now (CSVs under chip_smoke.py's folder tolerance, APs to 1e-9),
    so chip_smoke.py never checks the GPU against a stale reference."""
    import chip_smoke

    out, _ = jax_gate
    for name in CSVS:
        (tmp_path / name).write_bytes(out[name])
    rec = chip_smoke.compare_folder_csvs(str(tmp_path), JAX_OUT,
                                         _image_hw(_png_names()))
    assert rec["rows"] > 0
    for name in ("gate_ap.json", "gate_config.json"):
        with open(os.path.join(JAX_OUT, name), "rb") as f:
            committed = json.loads(f.read())
        now = json.loads(out[name])
        if name == "gate_config.json":
            assert committed == now
            continue
        for kind in ("segm", "bbox"):
            for k, v in now["results"][kind].items():
                assert abs(committed["results"][kind][k] - v) <= 1e-9, k


def test_run_batch_inference_matches_jax_csvs(port_runs):
    """The port's folder run on the CPU against the JAX package's committed
    CSVs: ImageIds and row counts equal, each row's mask at IoU ≥ 0.99,
    per-class descriptor counts equal and medians within 1 % (the folder
    golden's tolerance on the card).  On this CPU the files come out byte
    for byte identical; the tolerance covers summation-order differences
    on other hosts."""
    import chip_smoke

    run = port_runs[0]
    rec = chip_smoke.compare_folder_csvs(os.path.dirname(run["csv"]),
                                         JAX_OUT, _image_hw(_png_names()))
    assert rec["rows"] == 90 and rec["worst_iou"] >= 0.99
    assert chip_smoke.check_rows_decode(run) == rec["rows"]
    assert run["num_images"] == 12
    assert sum(cm.count for cm in run["report"].per_class) == rec["rows"]


def test_fused_tail_folder_run_is_bit_identical(port_runs):
    """postprocess.paste_chunk=10 (paste_select_pack) gives the unfused
    run's masks and CSVs bit for bit."""
    a, b = port_runs[0], port_runs[10]
    for path, inst in a["predictions"].items():
        np.testing.assert_array_equal(inst["masks"],
                                      b["predictions"][path]["masks"])
    for name in CSVS:
        with open(os.path.join(os.path.dirname(a["csv"]), name), "rb") as f:
            want = f.read()
        with open(os.path.join(os.path.dirname(b["csv"]), name), "rb") as f:
            assert f.read() == want, name


def test_serve_once_resumes_and_matches_jax(jax_gate, tmp_path):
    """serve_forever(once=True) answers the backlog, a restart serves only
    the new files, and every record agrees with the JAX package's: classes
    equal, boxes within 0.011 px (the record rounds to 0.01), scores
    within 1e-4, masks at IoU ≥ 0.99."""
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.engine.serve import serve_forever
    from uwcv_tpu_torch.measure.rle import rle_decode
    from uwcv_tpu_torch.weights import load_npz

    _, want = jax_gate
    cfg = _port_cfg(str(tmp_path / "out"))
    pred = Predictor(cfg, load_npz(GATE_CKPT), device="cpu")
    watch, served = tmp_path / "watch", tmp_path / "served"
    watch.mkdir()
    names = _png_names()
    quiet = lambda *_: None
    for i, name in enumerate(names):
        shutil.copy(os.path.join(SPLIT, "Test", name), watch / name)
        if i == 4:
            assert serve_forever(cfg, pred, str(watch), str(served),
                                 batch_size=BATCH, once=True,
                                 progress=quiet) == 5
    assert serve_forever(cfg, pred, str(watch), str(served),
                         batch_size=BATCH, once=True, progress=quiet) == 7
    assert serve_forever(cfg, pred, str(watch), str(served),
                         batch_size=BATCH, once=True, progress=quiet) == 0
    assert sorted(os.listdir(served)) == sorted(want)
    for fname, w in want.items():
        with open(served / fname) as f:
            g = json.load(f)
        assert g["file"] == w["file"]
        assert g["num_instances"] == w["num_instances"]
        assert g["classes"] == w["classes"]
        if w["num_instances"]:
            assert np.abs(np.subtract(g["boxes_xyxy"],
                                      w["boxes_xyxy"])).max() <= 0.011
            assert np.abs(np.subtract(g["scores"], w["scores"])).max() <= 1e-4
        for a, b in zip(g["masks_rle"], w["masks_rle"]):
            ma, mb = rle_decode(a, (256, 256)), rle_decode(b, (256, 256))
            union = np.logical_or(ma, mb).sum()
            assert union == 0 or np.logical_and(ma, mb).sum() / union >= 0.99


def test_resize_and_class_filters_match_jax():
    from uwcv_tpu.engine import batch_inference as jbi
    from uwcv_tpu_torch.engine import batch_inference as tbi

    rng = np.random.default_rng(3)
    inst = {"boxes": rng.uniform(0, 50, (9, 4)).astype(np.float32),
            "scores": rng.uniform(0, 1, 9).astype(np.float32),
            "classes": rng.integers(0, 6, 9).astype(np.int32),
            "masks": rng.random((9, 40, 52)) > 0.7}
    for hw in ((40, 52), (57, 61), (23, 100), (13, 17)):
        a = tbi.resize_masks_to_original(inst, hw)
        b = jbi.resize_masks_to_original(inst, hw)
        np.testing.assert_array_equal(a["masks"], b["masks"])
    for thr, px in (((0.18, 0.35, 0.58, 0.58), (75, 150, 75, 75)),
                    ((0.5,), (600,)), ((), ())):
        a = tbi.apply_class_filters(inst, thr, px)
        b = jbi.apply_class_filters(inst, thr, px)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    empty = {k: v[:0] for k, v in inst.items()}
    assert tbi.resize_masks_to_original(empty, (80, 90)) is empty


def test_predictor_call_takes_a_path_and_block():
    """The two repairs against the JAX API: ``Predictor.__call__`` accepts
    an image file's path, ``predict_batch_device`` a ``block`` flag."""
    from uwcv_tpu_torch.data.loader import load_image_rgb
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.weights import load_npz

    pred = Predictor(_port_cfg("unused"), load_npz(GATE_CKPT), device="cpu")
    path = os.path.join(SPLIT, "Test", _png_names()[0])
    by_path = pred(path)
    by_array = pred(load_image_rgb(path))
    np.testing.assert_array_equal(by_path.masks, by_array.masks)
    assert by_path.valid.any()
    out = pred.predict_batch_device([load_image_rgb(path)], block=True)
    np.testing.assert_array_equal(pred.to_instances(out)[0].masks,
                                  by_path.masks)


def _cli(*argv):
    from uwcv_tpu_torch.cli.main import main

    return main([str(a) for a in argv])


def test_cli_verbs_on_cpu(tmp_path, monkeypatch, capsys):
    """infer, measure, eval and serve through ``uwcv_tpu_torch.cli.main``
    with ``--device cpu`` on three gate images; without ``--device cpu``
    and without a card the verbs raise."""
    import torch

    from uwcv_tpu_torch.data.catalog import DatasetCatalog

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    shutil.copy(GATE_CKPT, ckpt / "gate_ckpt.npz")
    with open(os.path.join(JAX_OUT, "gate_config.json")) as f:
        sections = json.load(f)
    (ckpt / "config.json").write_text(json.dumps({"model": sections["model"]}))
    data = tmp_path / "Test"
    data.mkdir()
    for name in _png_names()[:3]:
        for f in (name, name + ".json"):
            shutil.copy(os.path.join(SPLIT, "Test", f), data / f)
    common = ["--weights", ckpt / "gate_ckpt.npz", "--device", "cpu",
              "-o", "input.test_short_edge=256", "-o",
              "input.test_max_size=256", "-o", "input.pad_size_test=256,256",
              "-o", f"data.classes_csv={SPLIT}/classes.csv",
              "-o", f"data.test_dataset=cli_gate_{os.getpid()}"]
    out = tmp_path / "out"
    assert _cli("infer", "--image-dir", data, "--output-dir", out,
                *common) == 0
    assert (out / "R50_flip_.csv").read_text().count("\n") > 1
    assert _cli("measure", "--image-dir", data, "--output-dir",
                tmp_path / "m", *common) == 0
    assert list((tmp_path / "m").glob("dist_*.png"))
    try:
        assert _cli("eval", "--data-dir", data, "--output-dir", out,
                    *common) == 0
    finally:
        DatasetCatalog.remove(f"cli_gate_{os.getpid()}")
    metrics = json.loads((out / "coco_metrics.json").read_text())
    assert 0.0 <= metrics["segm"]["AP"] <= 1.0
    assert _cli("serve", "--watch-dir", data, "--out-dir", tmp_path / "s",
                "--once", *common) == 0
    assert len(list((tmp_path / "s").glob("*.json"))) == 3
    assert "served 3 images" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    no_device = [a for a in common if a not in ("--device", "cpu")]
    for verb in (["infer", "--image-dir", data], ["eval"],
                 ["serve", "--watch-dir", data, "--once"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _cli(*verb, "--output-dir", tmp_path / "x", *no_device)


def test_cli_module_runs_as_a_script():
    out = subprocess.run([sys.executable, "-m", "uwcv_tpu_torch.cli.main",
                          "--help"], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0
    for verb in ("train", "infer", "measure", "eval", "serve", "hpo",
                 "synth", "export"):
        assert verb in out.stdout


if __name__ == "__main__":
    print(write_gate_data())
