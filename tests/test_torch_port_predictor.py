"""The port's Predictor against the JAX Predictor on the committed gate
checkpoint (R26 / FPN-64 / box-FC-256), in f32 on the CPU.

Also holds the writer of ``tests/data/torch_port_gate_golden.npz`` — the
JAX package's outputs on the first gate test images, which
``chip_smoke.py`` holds the port against on the GPU — and a test that the
committed golden still equals what JAX produces.  Regenerate it with

    JAX_PLATFORMS=cpu python tests/test_torch_port_predictor.py
"""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_gate_golden.npz")
GATE_CKPT = os.path.join(REPO, "assets", "gate", "gate_ckpt.npz")
GATE_META = os.path.join(REPO, "assets", "gate", "gate_meta.json")
N_COMPARED = 4          # gate test images compared instance by instance
BATCH = 8


def _gate_images(root):
    from tools.make_gate_ckpt import ensure_gate_dataset

    from uwcv_tpu.data.loader import load_image_rgb
    from uwcv_tpu.data.superannotate import get_superannotate_dicts

    ensure_gate_dataset(root)
    dicts = get_superannotate_dicts(os.path.join(root, "Test"))
    return dicts, [load_image_rgb(r["file_name"]) for r in dicts]


def _gate_cfg(root):
    from tools.make_gate_ckpt import gate_config

    cfg = gate_config(root)
    cfg.model.dtype = "float32"
    return cfg


def _run_batches(predictor, images):
    """predict_batch in fixed batches of BATCH (the last one padded by
    repeating its final image), as evaluate_split runs it."""
    out = []
    for s in range(0, len(images), BATCH):
        chunk = images[s:s + BATCH]
        out += predictor.predict_batch(
            chunk + [chunk[-1]] * (BATCH - len(chunk)))[:len(chunk)]
    return out


def jax_gate_outputs(root):
    """(dataset dicts, images, JAX Instances, cfg) for the gate test split."""
    import jax

    from uwcv_tpu.engine.checkpoint import load_params_npz
    from uwcv_tpu.engine.predictor import Predictor as JaxPredictor
    from uwcv_tpu.models.rcnn import MaskRCNN, init_params

    dicts, images = _gate_images(root)
    cfg = _gate_cfg(root)
    params = load_params_npz(GATE_CKPT, init_params(MaskRCNN(cfg.model),
                                                    jax.random.key(0)))
    return dicts, images, _run_batches(JaxPredictor(cfg, params), images), cfg


def golden_arrays(images, insts, cfg, n=N_COMPARED):
    """The golden file's content: the first ``n`` images (grayscale, one
    channel), the JAX outputs, and the config sections the port needs."""
    valid = np.stack([i.valid for i in insts[:n]])
    k = max(1, int(valid.sum(1).max()))
    masks = np.zeros((n, k) + insts[0].masks.shape[1:-1]
                     + (insts[0].masks.shape[-1] // 8,), np.uint8)
    for j, inst in enumerate(insts[:n]):
        m = np.packbits(inst.masks[inst.valid], axis=-1)
        masks[j, :len(m)] = m
    for im in images[:n]:
        assert np.array_equal(im[..., 0], im[..., 2]), "gate images are gray"
    sections = {s: getattr(cfg, s).__dict__ for s in
                ("model", "input", "postprocess")}
    return {
        "images": np.stack([im[..., :1] for im in images[:n]]),
        "boxes": np.stack([i.boxes for i in insts[:n]]),
        "scores": np.stack([i.scores for i in insts[:n]]),
        "classes": np.stack([i.classes for i in insts[:n]]),
        "valid": valid,
        "masks": masks,
        "config_json": np.asarray(json.dumps(sections, default=list)),
    }


def write_golden(path=GOLDEN, root=None):
    import tempfile

    root = root or tempfile.mkdtemp(prefix="gate_data_")
    _, images, insts, cfg = jax_gate_outputs(root)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **golden_arrays(images, insts, cfg))
    return path


# ------------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.weights import load_npz

    root = str(tmp_path_factory.mktemp("gate_data"))
    dicts, images, jax_insts, cfg = jax_gate_outputs(root)
    port_cfg = Config.from_dict(cfg.to_dict())
    port = Predictor(port_cfg, load_npz(GATE_CKPT), device="cpu")
    return {"dicts": dicts, "images": images, "jax": jax_insts,
            "port": _run_batches(port, images), "cfg": cfg}


def _mask_iou(a, b):
    union = np.logical_or(a, b).sum()
    return 1.0 if union == 0 else np.logical_and(a, b).sum() / union


def _assert_instances_match(got, want_valid, want_classes, want_boxes,
                            want_scores, want_masks):
    v = got.valid
    assert v.sum() == want_valid.sum()
    np.testing.assert_array_equal(got.classes[v], want_classes[want_valid])
    np.testing.assert_allclose(got.boxes[v], want_boxes[want_valid], atol=1e-2)
    np.testing.assert_allclose(got.scores[v], want_scores[want_valid],
                               atol=1e-4)
    for a, b in zip(got.masks[v], want_masks):
        assert _mask_iou(a, b) >= 0.99


@pytest.mark.parametrize("i", range(N_COMPARED))
def test_predictor_matches_jax_on_gate_images(gate, i):
    got, want = gate["port"][i], gate["jax"][i]
    assert got.valid.any()
    _assert_instances_match(got, want.valid, want.classes, want.boxes,
                            want.scores, want.masks[want.valid])
    assert got.masks.shape == want.masks.shape
    assert got.image_size == want.image_size


def test_gate_map_matches_jax(gate):
    """Held-out mAP through the JAX-free evaluator: the port within 0.005 of
    JAX and at least 0.8× the score recorded with the checkpoint."""
    from uwcv_tpu.data.rasterize import annotations_to_arrays
    from uwcv_tpu.engine.batch_inference import resize_masks_to_original
    from uwcv_tpu.eval.coco_eval import evaluate_dataset

    gts = []
    for rec in gate["dicts"]:
        arr = annotations_to_arrays(rec["annotations"], rec["height"],
                                    rec["width"], max_instances=256,
                                    include_crowd=True)
        n = arr["num_instances"]
        gts.append({"boxes": arr["boxes"][:n], "classes": arr["classes"][:n],
                    "masks": arr["masks"][:n], "iscrowd": arr["iscrowd"][:n]})
    res = {}
    for side in ("jax", "port"):
        preds = [resize_masks_to_original(inst.to_numpy(), img.shape[:2])
                 for inst, img in zip(gate[side], gate["images"])]
        res[side] = evaluate_dataset(preds, gts, gate["cfg"].model.num_classes)
    with open(GATE_META) as f:
        meta = json.load(f)
    for kind, key in (("segm", "segm_AP"), ("bbox", "bbox_AP")):
        assert abs(res["port"][kind]["AP"] - res["jax"][kind]["AP"]) <= 0.005
        assert res["port"][kind]["AP"] >= 0.8 * meta[key], (res, meta)


def test_committed_golden_is_current(gate):
    """The committed golden equals what JAX produces now, so chip_smoke.py
    never checks the GPU against a stale reference."""
    with np.load(GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    want = golden_arrays(gate["images"], gate["jax"], gate["cfg"])
    np.testing.assert_array_equal(g["images"], want["images"])
    np.testing.assert_array_equal(g["valid"], want["valid"])
    np.testing.assert_array_equal(g["classes"], want["classes"])
    np.testing.assert_allclose(g["boxes"], want["boxes"], atol=1e-3)
    np.testing.assert_allclose(g["scores"], want["scores"], atol=1e-5)
    assert json.loads(str(g["config_json"])) == json.loads(
        str(want["config_json"]))
    for i in range(len(g["valid"])):
        k = int(g["valid"][i].sum())
        a = np.unpackbits(g["masks"][i][:k], axis=-1)
        b = np.unpackbits(want["masks"][i][:k], axis=-1)
        for ma, mb in zip(a, b):
            assert _mask_iou(ma, mb) >= 0.99


def test_port_matches_golden_on_cpu(gate):
    """What chip_smoke.py checks on the GPU, here on the CPU: the golden's
    config and images through the port reproduce the golden outputs."""
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.weights import load_npz

    with np.load(GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    cfg = Config.from_dict(json.loads(str(g["config_json"])))
    port = Predictor(cfg, load_npz(GATE_CKPT), device="cpu")
    insts = port.predict_batch([np.repeat(im, 3, -1) for im in g["images"]])
    for i, inst in enumerate(insts):
        k = int(g["valid"][i].sum())
        _assert_instances_match(
            inst, g["valid"][i], g["classes"][i], g["boxes"][i],
            g["scores"][i],
            np.unpackbits(g["masks"][i][:k], axis=-1).astype(bool))


def test_load_predictor_adopts_checkpoint_model_cfg(tmp_path):
    """load_predictor reads a config.json beside the .npz: params-defining
    fields come from it, runtime knobs (never adopted) and the caller's
    non-default fields keep the process's values."""
    import shutil

    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.predictor import load_predictor

    ckpt = tmp_path / "gate_ckpt.npz"
    shutil.copy(GATE_CKPT, ckpt)
    saved = Config()
    saved.model.depth = 26
    saved.model.fpn_channels = 64
    saved.model.box_fc_dim = 256
    saved.model.anchor_aspect_ratios = (0.1, 0.5, 1.0, 2.0, 10.0)
    saved.model.rpn_post_nms_topk_test = 77          # runtime: not adopted
    (tmp_path / "config.json").write_text(saved.dumps())
    cfg = Config()
    cfg.model.dtype = "float32"
    cfg.model.roi_score_thresh_test = 0.3            # caller override wins
    pred = load_predictor(cfg, str(ckpt), device="cpu")
    m = pred.cfg.model
    assert (m.depth, m.fpn_channels, m.box_fc_dim) == (26, 64, 256)
    assert m.anchor_aspect_ratios == (0.1, 0.5, 1.0, 2.0, 10.0)
    assert m.rpn_post_nms_topk_test == Config().model.rpn_post_nms_topk_test
    assert m.roi_score_thresh_test == 0.3 and m.dtype == "float32"
    # any other file is a torch state dict (engine/checkpoint.py)
    with pytest.raises(FileNotFoundError):
        load_predictor(Config(), str(tmp_path / "model.pth"), device="cpu")


if __name__ == "__main__":
    print(write_golden())
