"""The port's Mask R-CNN against the JAX model, module by module, on the CPU.

Flax ``init_params`` at depth 26 / FPN 64 / f32 is carried into the port
through ``weights.params_from_flax``.  Each stage is fed the JAX stage's
own inputs (as numpy), so a mismatch points at one module; the last test
runs the whole ``inference`` on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_harness import hang_report, hang_report_module  # noqa: F401
from uwcv_tpu.config import Config as JaxConfig
from uwcv_tpu.models.heads import inference_detections as j_inference_detections
from uwcv_tpu.models.rcnn import MaskRCNN as JaxMaskRCNN, STRIDES, init_params
from uwcv_tpu.models.rpn import generate_proposals as j_generate_proposals
from uwcv_tpu.ops.roi_align import multilevel_roi_align_batched as j_pool
from uwcv_tpu_torch.config import Config
from uwcv_tpu_torch.models.heads import inference_detections
from uwcv_tpu_torch.models.rcnn import MaskRCNN
from uwcv_tpu_torch.models.rpn import generate_proposals
from uwcv_tpu_torch.ops.roi_align import multilevel_roi_align_batched
from uwcv_tpu_torch.weights import flax_param_shapes, params_from_flax

T = torch.from_numpy


def _small(cfg):
    m = cfg.model
    m.depth, m.fpn_channels, m.box_fc_dim, m.dtype = 26, 64, 64, "float32"
    m.rpn_pre_nms_topk_test, m.rpn_post_nms_topk_test = 200, 100
    m.detections_per_image, m.nms_candidates_test = 20, 256
    m.roi_score_thresh_test = 0.0
    m.rpn_post_nms_level_floor = 10
    return cfg


def _close(got, want, rtol=1e-4):
    """rtol 1e-4 with an absolute floor of 1e-4·max|want| (f32 sums taken
    in another order)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-6))


@pytest.fixture(scope="module")
def models():
    jcfg = _small(JaxConfig())
    jm = JaxMaskRCNN(jcfg.model)
    params = init_params(jm, jax.random.key(0), init_size=64)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    tcfg = _small(Config())
    tm = MaskRCNN(tcfg.model)
    tm.load_state_dict(params_from_flax(flat), strict=True)
    tm.eval().requires_grad_(False)
    rng = np.random.default_rng(0)
    images = (rng.random((2, 128, 160, 3)) * 255).astype(np.float32)
    jfeats = jm.apply(params, jnp.asarray(images),
                      method=lambda m, x: m._features(x))
    jobj, jdeltas = jm.apply(params, jfeats,
                             method=lambda m, f: m.rpn_head(f))
    return {"jm": jm, "params": params, "flat": flat, "jcfg": jcfg,
            "tm": tm, "tcfg": tcfg, "images": images, "jfeats": jfeats,
            "jobj": jobj, "jdeltas": jdeltas}


def _nchw(d):
    return {k: T(np.array(v)).permute(0, 3, 1, 2) for k, v in d.items()}


def test_param_tree_matches_flax(models):
    """Every Flax leaf has a port counterpart of the same shape, and the
    inverse (``flax_param_shapes``) reproduces the Flax tree exactly."""
    shapes = flax_param_shapes(models["tcfg"].model)
    assert {k: v.shape for k, v in models["flat"].items()} == shapes


def test_features_match(models):
    got = models["tm"].features(T(models["images"]))
    for k, want in models["jfeats"].items():
        _close(got[k].permute(0, 2, 3, 1), want)


def test_rpn_head_matches(models):
    obj, deltas = models["tm"].rpn_head(_nchw(models["jfeats"]))
    for k in models["jobj"]:
        _close(obj[k], models["jobj"][k])
        _close(deltas[k], models["jdeltas"][k])


def test_generate_proposals_matches(models):
    """Same objectness/deltas in: proposals equal (boxes to 1e-3 px),
    incl. the per-level floor and the batched per-level NMS."""
    jcfg, tcfg = models["jcfg"], models["tcfg"]
    h, w = models["images"].shape[1:3]
    anchors = models["jm"].apply(models["params"], (h, w),
                                 method=lambda m, s: m._anchors(s))
    want = j_generate_proposals(models["jobj"], models["jdeltas"], anchors,
                                (h, w), jcfg.model, training=False)
    got = generate_proposals(
        {k: T(np.array(v)) for k, v in models["jobj"].items()},
        {k: T(np.array(v)) for k, v in models["jdeltas"].items()},
        {k: T(np.array(v)) for k, v in anchors.items()}, (h, w), tcfg.model)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-3)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))


def test_box_path_and_detections_match(models):
    """JAX proposals through the box pooler, box head and detection
    inference on both sides."""
    jm, params, jcfg = models["jm"], models["params"], models["jcfg"]
    h, w = models["images"].shape[1:3]
    rng = np.random.default_rng(1)
    ctr = rng.uniform(0, 1, (2, 100, 2)) * [w, h]
    wh = rng.uniform(8, 120, (2, 100, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    boxes = np.clip(boxes, 0, [w, h, w, h]).astype(np.float32)
    valid = rng.random((2, 100)) < 0.9
    feats4 = {k: models["jfeats"][k] for k in ("p2", "p3", "p4", "p5")}
    jpooled = j_pool(feats4, jnp.asarray(boxes), STRIDES, 7, use_pallas=False)
    tpooled = multilevel_roi_align_batched(
        {k: T(np.array(v)) for k, v in feats4.items()}, T(boxes), STRIDES, 7)
    _close(tpooled, jpooled)
    jlog, jdel = jm.apply(params, jpooled.reshape((200,) + jpooled.shape[2:]),
                          method=lambda m, x: m.box_head(x))
    tlog, tdel = models["tm"].box_head(T(np.array(jpooled)).reshape(
        (200,) + jpooled.shape[2:]))
    _close(tlog, jlog)
    _close(tdel, jdel)
    c = jcfg.model.num_classes
    want = jax.vmap(lambda b, v, l, d: j_inference_detections(
        b, v, l, d, (h, w), jcfg.model))(
            jnp.asarray(boxes), jnp.asarray(valid), jlog.reshape(2, 100, -1),
            jdel.reshape(2, 100, c, 4))
    got = inference_detections(
        T(boxes), T(valid), T(np.array(jlog)).reshape(2, 100, -1),
        T(np.array(jdel)).reshape(2, 100, c, 4), (h, w), models["tcfg"].model)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-6)


def test_mask_head_matches(models):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (6, 14, 14, 64)).astype(np.float32)
    want = models["jm"].apply(models["params"], jnp.asarray(x),
                              method=lambda m, v: m.mask_head(v))
    _close(models["tm"].mask_head(T(x)), want)


def test_full_inference_matches(models):
    """End to end: detections (boxes to 1e-3 px, classes and valid exact)
    and the selected class's mask probabilities."""
    imgs = models["images"]
    jd, jp = models["jm"].apply(models["params"], jnp.asarray(imgs),
                                method=JaxMaskRCNN.inference)
    td, tp = models["tm"].inference(T(imgs))
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_array_equal(td.classes.numpy(), np.asarray(jd.classes))
    np.testing.assert_allclose(td.boxes.numpy(), np.asarray(jd.boxes),
                               atol=1e-3)
    np.testing.assert_allclose(td.scores.numpy(), np.asarray(jd.scores),
                               atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
