"""Rules the port keeps: no JAX and nothing of ``uwcv_tpu`` in
``uwcv_tpu_torch`` or ``chip_smoke.py``, and the folder path needs neither
pandas, PIL nor matplotlib (the card's machine has none of them); entry
points refuse to fall back to the CPU silently; the CPU path never launches
(or counts) a kernel."""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "uwcv_tpu_torch")
CHIP_SMOKE = os.path.join(REPO, "chip_smoke.py")
GATE_SPLIT = os.path.join(REPO, "tests", "data", "gate_split")
GATE_CKPT = os.path.join(REPO, "assets", "gate", "gate_ckpt.npz")
# absent on the card's machine
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "uwcv_tpu", "pandas",
           "PIL", "matplotlib")


def _port_sources():
    for d, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield CHIP_SMOKE


def _modules():
    for path in _port_sources():
        if path == CHIP_SMOKE:
            yield "chip_smoke"
            continue
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        yield rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def test_every_module_imports_with_jax_blocked():
    """A fresh interpreter in which ``import jax`` (and flax, the JAX
    package, pandas, PIL and matplotlib) fails imports every module of the
    port and chip_smoke.py."""
    code = (
        "import sys, importlib\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_jax_or_reference_package_imports():
    """AST scan: no import of jax, flax or uwcv_tpu (the JAX package) in
    any source of the port."""
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "uwcv_tpu")
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                assert root not in banned, f"{path}: imports {name}"


def test_predictor_without_device_raises_without_cuda(monkeypatch):
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.predictor import Predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(Config())


def test_trainer_and_train_verb_raise_without_cuda(monkeypatch, tmp_path):
    """Without a card, ``Trainer`` and the ``train`` verb refuse the
    default device instead of training on the CPU; ``device="cpu"`` is
    accepted."""
    from uwcv_tpu_torch.cli.main import main
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_cfg()
    cfg.output_dir = str(tmp_path / "t")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    assert Trainer(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "--data-dir", os.path.join(GATE_SPLIT, "Test"),
              "--output-dir", str(tmp_path / "cli")])
    assert not (tmp_path / "cli" / "model_final.npz").exists()


def test_cpu_training_launches_no_kernel(tmp_path):
    """Two CPU training steps take the plain versions of RoIAlign, its
    backward and NMS: every launch counter stays where it was."""
    from uwcv_tpu_torch.data.loader import TrainLoader
    from uwcv_tpu_torch.data.superannotate import get_superannotate_dicts
    from uwcv_tpu_torch.engine.trainer import Trainer
    from uwcv_tpu_torch.ops.nms import nms_greedy
    from uwcv_tpu_torch.ops.roi_align import (
        roi_align_windows,
        roi_align_windows_backward,
    )

    cfg = _tiny_cfg()
    cfg.input.train_size = (64, 64)
    cfg.model.rpn_pre_nms_topk_train, cfg.model.rpn_post_nms_topk_train = \
        100, 50
    cfg.output_dir = str(tmp_path)
    counters = (roi_align_windows, roi_align_windows_backward, nms_greedy)
    before = [f.launches for f in counters]
    tr = Trainer(cfg, device="cpu")
    loader = TrainLoader(get_superannotate_dicts(
        os.path.join(GATE_SPLIT, "Test")), cfg)
    tr.fit(loader.index_batches(), max_iter=2, log_fn=lambda *_: None,
           device_dataset=loader.device_dataset("cpu"))
    assert tr.step == 2
    assert [f.launches for f in counters] == before


def _tiny_cfg():
    from uwcv_tpu_torch.config import Config

    cfg = Config()
    m = cfg.model
    m.depth, m.fpn_channels, m.box_fc_dim, m.dtype = 26, 32, 32, "float32"
    m.rpn_pre_nms_topk_test, m.rpn_post_nms_topk_test = 50, 40
    m.detections_per_image, m.roi_score_thresh_test = 10, 0.0
    cfg.input.test_short_edge = cfg.input.test_max_size = 96
    cfg.input.pad_size_test = (128, 128)
    return cfg


def test_paste_chunk_gives_the_unfused_result_on_cpu():
    """``postprocess.paste_chunk > 0`` selects the fused paste_select_pack
    tail; a CPU batch through it equals the unfused tail's."""
    from chip_smoke import seeded_flax_params
    from uwcv_tpu_torch.engine.predictor import Predictor

    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (120, 100, 3), dtype=np.uint8)
              for _ in range(2)]
    out = {}
    for chunk in (0, 3, 10):
        cfg = _tiny_cfg()
        cfg.postprocess.paste_chunk = chunk
        params = seeded_flax_params(cfg.model, 0)   # confident, solid masks
        out[chunk] = Predictor(cfg, params, device="cpu").predict_batch(images)
    assert any(i.valid.any() for i in out[0])
    for chunk in (3, 10):
        for a, b in zip(out[0], out[chunk]):
            np.testing.assert_array_equal(a.valid, b.valid)
            np.testing.assert_array_equal(a.masks, b.masks)


def test_cpu_path_never_touches_launch_counters():
    """A whole CPU batch through the predictor takes the plain versions and
    leaves both kernel launch counters where they were."""
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.ops.nms import nms_greedy
    from uwcv_tpu_torch.ops.roi_align import roi_align_windows

    cfg = _tiny_cfg()
    torch.manual_seed(0)
    pred = Predictor(cfg, device="cpu")
    before = (nms_greedy.launches, roi_align_windows.launches)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (120, 100, 3), dtype=np.uint8)
              for _ in range(2)]
    for host_resize in (True, False):      # False: the device resample
        cfg.input.host_resize = host_resize
        insts = pred.predict_batch(images)
        assert len(insts) == 2 and insts[0].masks.shape == (10, 128, 128)
    assert (nms_greedy.launches, roi_align_windows.launches) == before


def test_folder_path_runs_without_pandas_pil_matplotlib(tmp_path):
    """``run_batch_inference`` over three gate PNGs on the CPU in an
    interpreter where pandas, PIL, matplotlib and JAX cannot be imported:
    the RLE and descriptor CSVs are written, and asking for plots raises
    an ImportError that names matplotlib."""
    images = tmp_path / "images"
    images.mkdir()
    for name in sorted(os.listdir(os.path.join(GATE_SPLIT, "Test")))[:6]:
        if name.endswith(".png"):
            shutil.copy(os.path.join(GATE_SPLIT, "Test", name), images)
    code = f"""
import json, sys
for m in {BLOCKED!r}:
    sys.modules[m] = None
sys.path.insert(0, {REPO!r})
from uwcv_tpu_torch.config import Config
from uwcv_tpu_torch.engine.batch_inference import run_batch_inference
from uwcv_tpu_torch.engine.predictor import Predictor
from uwcv_tpu_torch.weights import load_npz
cfg = Config.from_dict(json.load(open({GATE_SPLIT!r} + "/jax/gate_config.json")))
cfg.data.classes_csv = {GATE_SPLIT!r} + "/classes.csv"
cfg.output_dir = {str(tmp_path / "out")!r}
pred = Predictor(cfg, load_npz({GATE_CKPT!r}), device="cpu")
res = run_batch_inference(cfg, pred, image_dir={str(images)!r},
                          progress=lambda *_: None)
rows = open(res["csv"]).read().splitlines()
print("rows", len(rows) - 1, res["num_images"])
try:
    run_batch_inference(cfg, pred, image_dir={str(images)!r}, with_plots=True,
                        progress=lambda *_: None)
except ImportError as e:
    print("plots:", e)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    n_rows, n_images = map(int, lines[0].split()[1:])
    assert n_images == 3 and n_rows > 0
    assert "matplotlib" in lines[1]
    for name in ("R50_flip_.csv", "ShapeDescriptor.csv", "ResultsPore_.csv"):
        assert (tmp_path / "out" / name).exists()


def test_synth_gallery_and_pth_import_run_without_pil(tmp_path):
    """In an interpreter where PIL, pandas, matplotlib and JAX cannot be
    imported: ``synth`` writes a dataset whose PNGs decode, the
    ground-truth gallery writes its PNGs, and a ``.pth`` loads into a
    predictor."""
    code = f"""
import sys
for m in {BLOCKED!r}:
    sys.modules[m] = None
sys.path.insert(0, {REPO!r})
import numpy as np, torch
from chip_smoke import detectron2_state_dict
from uwcv_tpu_torch.cli.main import main
from uwcv_tpu_torch.data.classes import ClassRegistry
from uwcv_tpu_torch.data.imageio import decode_png
from uwcv_tpu_torch.data.superannotate import get_superannotate_dicts
from uwcv_tpu_torch.engine.batch_inference import save_gt_visualizations
from uwcv_tpu_torch.engine.predictor import load_predictor
from uwcv_tpu_torch.weights import load_npz, params_to_flax
root = {str(tmp_path / "data")!r}
main(["synth", "--root", root, "--train", "2", "--test", "0", "--infer",
      "0", "--size", "48"])
out = save_gt_visualizations(get_superannotate_dicts(root + "/Train"),
                             ClassRegistry(), root + "/viz")
shapes = [decode_png(open(p, "rb").read()).pixels.shape for p in out]
print("gallery", len(out), shapes[0])
cfg = _cfg()
ckpt, want = detectron2_state_dict(load_npz({GATE_CKPT!r}),
                                   np.random.default_rng(0))
torch.save(ckpt, root + "/model.pth")
got = params_to_flax(load_predictor(cfg, root + "/model.pth",
                                    device="cpu").model)
print("pth", sum(np.array_equal(got[k], want[k]) for k in want), len(want))
"""
    cfg_src = ("def _cfg():\n"
               "    import json\n"
               "    from uwcv_tpu_torch.config import Config\n"
               f"    return Config.from_dict(json.load(open("
               f"{GATE_SPLIT!r} + '/jax/gate_config.json')))\n")
    out = subprocess.run([sys.executable, "-c", cfg_src + code],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-2] == "gallery 2 (48, 48, 3)"
    n_equal, n = map(int, lines[-1].split()[1:])
    assert n_equal == n == 93


def test_hpo_verb_raises_without_cuda_unless_cpu(monkeypatch, tmp_path):
    """Without a card the ``hpo`` verb refuses the default device before
    any work; with ``--device cpu`` one small trial runs."""
    from uwcv_tpu_torch.cli.main import main
    from uwcv_tpu_torch.data.catalog import DatasetCatalog
    from uwcv_tpu_torch.data.synthetic import generate_dataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths = generate_dataset(str(tmp_path / "data"), num_train=1,
                             num_test=1, num_inference=0,
                             image_size=(64, 64), seed=2)
    args = ["hpo", "--data-dir", paths["Train"], "--trials", "1",
            "--trial-iters", "1", "--output-dir", str(tmp_path / "out"),
            "-o", f"data.classes_csv={paths['classes_csv']}",
            "-o", "data.train_dataset=_hygiene_hpo",
            "-o", "data.test_dataset=_hygiene_hpo_test",
            "-o", "model.depth=26", "-o", "model.fpn_channels=32",
            "-o", "model.box_fc_dim=32", "-o", "model.dtype=float32",
            "-o", "input.train_size=64,64", "-o", "input.pad_size_test=64,64",
            "-o", "input.test_short_edge=64", "-o", "input.test_max_size=64",
            "-o", "solver.ims_per_batch=1"]
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)
        assert not (tmp_path / "out").exists()
        assert main(args + ["--device", "cpu"]) == 0
    finally:
        DatasetCatalog.remove("_hygiene_hpo")
        DatasetCatalog.remove("_hygiene_hpo_test")
    assert (tmp_path / "out" / "hpo_trial0" / "config.json").exists()


def test_chip_smoke_alone_fails_without_output(tmp_path):
    """chip_smoke.py needs the rest of the checkout (and a card): copied
    into an otherwise empty directory it exits non-zero and prints no
    result line."""
    with open(CHIP_SMOKE) as f:
        src = f.read()
    ast.parse(src)
    (tmp_path / "chip_smoke.py").write_text(src)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    """A kernel's build path changes when its source or any shared
    ``csrc/*.cuh`` header changes, so a stale library is never loaded."""
    from uwcv_tpu_torch import kernels

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(kernels, "CSRC_DIR", str(tmp_path))
    first = kernels._lib_path("k")
    assert kernels._lib_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = kernels._lib_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edit\n')
    assert kernels._lib_path("k") not in (first, second)
