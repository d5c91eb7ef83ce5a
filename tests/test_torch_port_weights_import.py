"""The port's torch state-dict import against the JAX package's
(``uwcv_tpu/engine/checkpoint.py::import_torch_weights``): state dicts
built from seeded numpy in Detectron2 naming (the whole model) and in
torchvision naming (the trunk, under ``module.backbone.body.``), at R26 and
R101, ``torch.save``d to a temporary file and read by both packages.  The
same leaves match, with bit-equal values.  The targets are each package's
own initialisation (they differ), so only the matched leaves are compared.
Also: ``load_weights``' dispatch, ``load_predictor`` and
``Trainer.resume_or_load`` reading a ``.pth``, and ``Predictor.set_params``.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from torch_port_harness import hang_report, hang_report_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from chip_smoke import detectron2_state_dict, seeded_flax_params  # noqa: E402
from uwcv_tpu.config import Config as JConfig  # noqa: E402
from uwcv_tpu.engine.checkpoint import (  # noqa: E402
    import_torch_weights as j_import,
)
from uwcv_tpu.models.rcnn import MaskRCNN as JMaskRCNN  # noqa: E402
from uwcv_tpu.models.rcnn import init_params  # noqa: E402
from uwcv_tpu_torch.config import Config  # noqa: E402
from uwcv_tpu_torch.engine.checkpoint import (  # noqa: E402
    import_torch_weights,
    load_weights,
    save_params_npz,
)
from uwcv_tpu_torch.models.rcnn import MaskRCNN  # noqa: E402
from uwcv_tpu_torch.weights import (  # noqa: E402
    flax_param_shapes,
    load_npz,
    params_to_flax,
)

GATE_SPLIT = os.path.join(REPO, "tests", "data", "gate_split")
GATE_CKPT = os.path.join(REPO, "assets", "gate", "gate_ckpt.npz")
DEPTHS = (26, 101)


def _model_fields(cfg, depth):
    cfg.model.depth, cfg.model.fpn_channels, cfg.model.box_fc_dim = \
        depth, 64, 128
    cfg.model.dtype = "float32"
    return cfg


def _jax_flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=DEPTHS, ids=lambda d: f"R{d}")
def depth_setup(request):
    """(depth, port ModelConfig, JAX ModelConfig, the JAX package's init,
    the port's init as flat Flax params)."""
    depth = request.param
    cfg = _model_fields(Config(), depth)
    jcfg = _model_fields(JConfig(), depth)
    j_target = init_params(JMaskRCNN(jcfg.model), jax.random.key(0),
                           init_size=64)
    torch.manual_seed(0)
    target = params_to_flax(MaskRCNN(cfg.model))
    assert sorted(target) == sorted(_jax_flat(j_target))
    return depth, cfg.model, jcfg.model, j_target, target


def _torchvision_trunk(flat, rng):
    """The trunk of ``flat`` in torchvision's ResNet naming under a
    ``module.backbone.body.`` prefix, with BN stats drawn from ``rng``,
    plus torchvision's classifier (which matches nothing)."""
    ckpt, _ = detectron2_state_dict(
        {k: v for k, v in flat.items() if k.startswith("params/backbone/")},
        rng)
    sd = {}
    for k, v in ckpt["model"].items():
        if not k.startswith("backbone.bottom_up."):
            continue
        k = k[len("backbone.bottom_up."):]
        k = k.replace("stem.conv1.norm", "bn1").replace("stem.conv1", "conv1")
        if k.startswith("res"):
            stage, rest = int(k[3]), k[5:]
            block, rest = rest.split(".", 1)
            rest = (rest.replace("shortcut.norm", "downsample.1")
                    .replace("shortcut", "downsample.0"))
            for i in (1, 2, 3):
                rest = rest.replace(f"conv{i}.norm", f"bn{i}")
            k = f"layer{stage - 1}.{block}.{rest}"
        sd["module.backbone.body." + k] = v
    sd["module.fc.weight"] = torch.zeros(1000, 2048)
    sd["module.fc.bias"] = torch.zeros(1000)
    return {"state_dict": sd}


def _seeded(mcfg, seed):
    """Seeded flat params whose every leaf differs from both inits (which
    set biases to zero), so a matched leaf shows as a changed one."""
    flat = seeded_flax_params(mcfg, seed)
    for k in flat:
        if k.endswith("/bias"):
            flat[k] = flat[k] + np.float32(0.5)
    return flat


def _both(path, depth_setup):
    """Both packages' imports of ``path`` → (port flat, JAX flat, the port's
    matched leaves, the JAX package's matched leaves)."""
    _, mcfg, jmcfg, j_target, target = depth_setup
    got = import_torch_weights(path, target, mcfg)
    want = _jax_flat(j_import(path, j_target, jmcfg))
    j_init = _jax_flat(j_target)
    got_keys = {k for k in got if not np.array_equal(got[k], target[k])}
    want_keys = {k for k in want if not np.array_equal(want[k], j_init[k])}
    return got, want, got_keys, want_keys


@pytest.mark.parametrize("naming", ["detectron2", "torchvision"])
def test_import_matches_jax_bit_for_bit(tmp_path, depth_setup, naming):
    depth, mcfg = depth_setup[:2]
    flat = _seeded(mcfg, depth)
    rng = np.random.default_rng(depth)
    if naming == "detectron2":
        ckpt, expected = detectron2_state_dict(flat, rng)
        n_want = len(flat)
    else:
        ckpt = _torchvision_trunk(flat, rng)
        expected = None
        n_want = sum(k.startswith("params/backbone/") for k in flat)
    path = str(tmp_path / "model.pth")
    torch.save(ckpt, path)
    got, want, got_keys, want_keys = _both(path, depth_setup)
    assert got_keys == want_keys
    assert len(got_keys) == n_want
    for k in got_keys:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if expected is not None:
        for k in got_keys:
            np.testing.assert_array_equal(got[k], expected[k], err_msg=k)


def test_wrong_shaped_leaves_keep_their_values(tmp_path, depth_setup):
    """A COCO-trained checkpoint's heads (81 classes) do not fit the
    4-class model: those leaves keep the target's values in both packages,
    and every other leaf loads."""
    depth, mcfg, _, _, target = depth_setup
    flat = _seeded(mcfg, depth)
    ckpt, _ = detectron2_state_dict(flat, np.random.default_rng(1))
    sd = ckpt["model"]
    sd["roi_heads.box_predictor.cls_score.weight"] = torch.zeros(81, 128)
    sd["roi_heads.box_predictor.cls_score.bias"] = torch.zeros(81)
    sd["roi_heads.box_predictor.bbox_pred.weight"] = torch.zeros(320, 128)
    sd["roi_heads.mask_head.predictor.weight"] = torch.zeros(80, 64, 1, 1)
    path = str(tmp_path / "coco.pth")
    torch.save(ckpt, path)
    got, want, got_keys, want_keys = _both(path, depth_setup)
    kept = {"params/box_head/cls_score/kernel",
            "params/box_head/cls_score/bias",
            "params/box_head/bbox_pred/kernel",
            "params/mask_head/predictor/kernel"}
    assert got_keys == want_keys == set(flat) - kept
    for k in kept:
        np.testing.assert_array_equal(got[k], target[k])
    for k in got_keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_zero_matches_raise_in_both(tmp_path, depth_setup):
    _, mcfg, jmcfg, j_target, target = depth_setup
    path = str(tmp_path / "bad.pth")
    torch.save({"unrelated.weight": torch.zeros(3)}, path)
    with pytest.raises(ValueError, match="no weights matched"):
        import_torch_weights(path, target, mcfg)
    with pytest.raises(ValueError, match="no weights matched"):
        j_import(path, j_target, jmcfg)


def test_load_weights_dispatch(tmp_path):
    """A directory raises and names the JAX package's ``.npz`` writer; an
    ``.npz`` is read as flat Flax params without reading the model; any
    other file is a torch state dict mapped onto the model's params."""
    mcfg = _model_fields(Config(), 26).model
    with pytest.raises(ValueError, match="save_params_npz"):
        load_weights(str(tmp_path), None, mcfg)
    flat = seeded_flax_params(mcfg, 3)
    npz = save_params_npz(str(tmp_path / "w.npz"), flat)
    got = load_weights(npz, None, mcfg)
    assert sorted(got) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k])
    ckpt, expected = detectron2_state_dict(flat, np.random.default_rng(3))
    del ckpt["model"]["roi_heads.mask_head.deconv.weight"]
    torch.save(ckpt, str(tmp_path / "w.pth"))
    torch.manual_seed(3)
    model = MaskRCNN(mcfg)
    got = load_weights(str(tmp_path / "w.pth"), model, mcfg)
    assert sorted(got) == sorted(flax_param_shapes(mcfg))
    own = params_to_flax(model)
    for k in expected:     # the deconv's leaves match nothing: the model's
        want = own[k] if "/mask_head/deconv/" in k else expected[k]
        np.testing.assert_array_equal(got[k], want, err_msg=k)


@pytest.fixture(scope="module")
def gate_pth(tmp_path_factory):
    """The gate checkpoint written as a Detectron2 ``.pth``, its gate config
    (R26, FPN 64, f32) and the JAX package's import of it onto its init."""
    d = tmp_path_factory.mktemp("gate_pth")
    with open(os.path.join(GATE_SPLIT, "jax", "gate_config.json")) as f:
        raw = json.load(f)
    cfg = Config.from_dict(raw)
    jcfg = JConfig.from_dict(raw)
    ckpt, _ = detectron2_state_dict(load_npz(GATE_CKPT),
                                    np.random.default_rng(4))
    path = str(d / "model_final.pth")
    torch.save(ckpt, path)
    want = _jax_flat(j_import(path, init_params(
        JMaskRCNN(jcfg.model), jax.random.key(0), init_size=64), jcfg.model))
    return cfg, path, want


def _gate_images():
    from uwcv_tpu_torch.data.loader import load_image_rgb

    names = sorted(n for n in os.listdir(os.path.join(GATE_SPLIT, "Test"))
                   if n.endswith(".png"))[:2]
    return [load_image_rgb(os.path.join(GATE_SPLIT, "Test", n))
            for n in names]


def test_load_predictor_reads_a_pth(gate_pth):
    from uwcv_tpu_torch.engine.predictor import load_predictor

    cfg, path, want = gate_pth
    pred = load_predictor(cfg, path, device="cpu")
    got = params_to_flax(pred.model)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_trainer_resume_or_load_reads_a_pth(gate_pth, tmp_path):
    from uwcv_tpu_torch.engine.trainer import Trainer

    cfg, path, want = gate_pth
    cfg.weights = path
    cfg.output_dir = str(tmp_path)
    tr = Trainer(cfg, device="cpu")
    tr.resume_or_load(resume=True)        # no ckpt_*.pt yet: the weights
    got = params_to_flax(tr.model)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tr.step == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_set_params_equals_a_fresh_predictor(gate_pth, dtype):
    """Weights swapped into a built predictor in place (same module, dtype
    and device) give outputs bit-equal to a predictor built with them."""
    from uwcv_tpu_torch.engine.predictor import Predictor

    cfg, _, _ = gate_pth
    cfg.model.dtype = dtype
    params = load_npz(GATE_CKPT)
    torch.manual_seed(1)
    pred = Predictor(cfg, None, device="cpu")
    model, images = pred.model, _gate_images()
    before = pred.predict_batch(images)
    pred.set_params(params)
    assert pred.model is model
    assert {p.dtype for p in model.parameters()} == {getattr(torch, dtype)}
    fresh = Predictor(cfg, params, device="cpu")
    got, want = pred.predict_batch(images), fresh.predict_batch(images)
    assert any(i.valid.any() for i in want)
    assert not all(np.array_equal(a.scores, b.scores)
                   for a, b in zip(before, want))
    for a, b in zip(got, want):
        for field in ("boxes", "scores", "classes", "valid", "masks"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field), err_msg=field)
