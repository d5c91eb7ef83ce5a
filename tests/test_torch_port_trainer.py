"""The port's Trainer, optimizer, checkpoints, training loader and ``train``
verb on the CPU, against the JAX package where it has a counterpart.

A small model (depth 26, FPN 32, box FC 32) trains on gate test images
resized to 64² so that a few steps take seconds.
"""

import copy
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_harness import hang_report, hang_report_module  # noqa: F401
from uwcv_tpu.config import Config as JaxConfig
from uwcv_tpu.data import loader as j_loader
from uwcv_tpu.data import rasterize as j_rasterize
from uwcv_tpu.data.superannotate import get_superannotate_dicts
from uwcv_tpu.engine.checkpoint import load_params_npz
from uwcv_tpu.engine.trainer import _trainable_mask, make_optimizer
from uwcv_tpu.models.rcnn import MaskRCNN as JaxMaskRCNN, init_params
from uwcv_tpu_torch.config import Config
from uwcv_tpu_torch.data.loader import TrainLoader, prepare_train_sample
from uwcv_tpu_torch.engine.trainer import Trainer, trainable_mask
from uwcv_tpu_torch.models.rcnn import MaskRCNN
from uwcv_tpu_torch.weights import load_npz, params_from_flax, params_to_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_SPLIT = os.path.join(REPO, "tests", "data", "gate_split")


def _small(cfg, out=None):
    m = cfg.model
    m.depth, m.fpn_channels, m.box_fc_dim, m.dtype = 26, 32, 32, "float32"
    m.rpn_pre_nms_topk_train, m.rpn_post_nms_topk_train = 200, 100
    m.rpn_batch_size_per_image, m.roi_batch_size_per_image = 64, 16
    cfg.input.train_size = (64, 64)
    cfg.input.max_gt_instances = 16
    cfg.solver.ims_per_batch = 2
    cfg.solver.log_period = 1
    cfg.solver.checkpoint_period = 2
    cfg.data.classes_csv = os.path.join(GATE_SPLIT, "classes.csv")
    if out is not None:
        cfg.output_dir = str(out)
    return cfg


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_params():
    cfg = _small(JaxConfig())
    return cfg, init_params(JaxMaskRCNN(cfg.model), jax.random.key(0),
                            init_size=64)


@pytest.fixture(scope="module")
def dicts():
    return get_superannotate_dicts(os.path.join(GATE_SPLIT, "Test"))


@pytest.mark.parametrize("freeze_at", range(6))
def test_trainable_mask_matches_jax(jax_params, freeze_at):
    cfg, params = jax_params
    want = {k: bool(v) for k, v in _flat(_trainable_mask(
        params, freeze_at=freeze_at)).items()}
    got = trainable_mask(MaskRCNN(_small(Config()).model), freeze_at)
    assert got == want


def test_trainable_mask_rejects_bad_freeze_at():
    with pytest.raises(ValueError, match="freeze_at"):
        trainable_mask(MaskRCNN(_small(Config()).model), 6)


def test_optimizer_matches_optax_chain_over_5_steps(jax_params, tmp_path):
    """Weight decay, global-norm clipping over the trainable leaves (step 2
    is scaled so that it fires), momentum and the warmup/multistep lr,
    against optax over 5 steps on the same gradients: parameters within
    1e-5 relative, frozen leaves untouched."""
    jcfg, params = copy.deepcopy(jax_params[0]), jax_params[1]
    jcfg.solver.base_lr, jcfg.solver.warmup_iters = 0.1, 3
    jcfg.solver.steps = (4,)
    cfg = _small(Config(), tmp_path)
    cfg.solver.base_lr, cfg.solver.warmup_iters = 0.1, 3
    cfg.solver.steps = (4,)
    tx = make_optimizer(jcfg, params)
    state = tx.init(params)
    tr = Trainer(cfg, device="cpu")
    tr.load_params(_flat(params))
    rng = np.random.default_rng(0)
    fired = []
    flat0 = _flat(params)
    for step in range(5):
        scale = 1.0 if step == 2 else 1e-3
        g = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
             for k, v in flat0.items()}
        tree = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params),
            [jnp.asarray(g[k]) for k in flat0])
        updates, state = tx.update(tree, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        tgrads = params_from_flax({k: v for k, v in g.items()
                                   if "frozen_bn" not in k})
        for name, _, c in tr._trainable:
            c.grad = tgrads[name].clone()
        train_norm = np.sqrt(sum(float((tgrads[n] ** 2).sum())
                                 for n, _, _ in tr._trainable))
        fired.append(train_norm > cfg.solver.clip_grad_norm)
        with torch.no_grad():
            tr._apply_gradients()
        tr.step += 1
        got, want = params_to_flax(tr.model), _flat(params)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step}: {k}")
    assert fired == [False, False, True, False, False]
    for k, v in params_to_flax(tr.model).items():
        if "stem_" in k or "res2_block" in k or "frozen_bn" in k:
            np.testing.assert_array_equal(v, flat0[k])


def test_bf16_working_copy_follows_the_masters(tmp_path):
    """In bf16 the working copy is bf16 apart from the RPN head, which
    stays f32; after an optimizer step every working parameter is its f32
    master rounded to the working dtype."""
    cfg = _small(Config(), tmp_path)
    cfg.model.dtype = "bfloat16"
    tr = Trainer(cfg, device="cpu")
    tr.init_state(seed=2)
    working = dict(tr.compute.named_parameters())
    for n, p in working.items():
        want = torch.float32 if n.startswith("rpn_head.") else torch.bfloat16
        assert p.dtype == want, n
    before = {n: p.detach().clone() for n, p in working.items()}
    g = torch.Generator().manual_seed(0)
    for _, m, c in tr._trainable:
        c.grad = torch.randn(c.shape, generator=g).to(c.dtype)
    with torch.no_grad():
        tr._apply_gradients()
    for n, m in tr.model.named_parameters():
        assert torch.equal(working[n], m.to(working[n].dtype)), n
    assert not any(torch.equal(before[n], working[n]) for n in working
                   if n.startswith("rpn_head."))


def _fit(cfg, dicts, steps, resume=False):
    """From the gate checkpoint, or resumed, to ``steps``, as the ``train``
    verb runs it."""
    tr = Trainer(cfg, device="cpu")
    tr.load_params(load_npz(os.path.join(REPO, "assets", "gate",
                                         "gate_ckpt.npz")))
    tr.resume_or_load(resume=resume)
    loader = TrainLoader(dicts, cfg, seed=cfg.solver.seed)
    loader.skip(tr.step)
    dd = loader.device_dataset(tr.device)
    tr.fit(loader.index_batches(), max_iter=steps, log_fn=lambda *_: None,
           device_dataset=dd)
    return tr


def _gate_small(out):
    """The gate checkpoint's architecture at 64² inputs."""
    with open(os.path.join(GATE_SPLIT, "jax", "gate_config.json")) as f:
        cfg = Config.from_dict(json.load(f))
    cfg.output_dir = str(out)
    cfg.input.train_size = (64, 64)
    cfg.model.rpn_pre_nms_topk_train, cfg.model.rpn_post_nms_topk_train = \
        200, 100
    cfg.solver.ims_per_batch, cfg.solver.log_period = 2, 1
    cfg.solver.checkpoint_period = 2
    cfg.solver.base_lr, cfg.solver.warmup_iters = 0.01, 2
    return cfg


def test_fit_writes_metrics_events_and_checkpoints(dicts, tmp_path):
    """Three CPU steps from the gate checkpoint through the device-dataset
    path: a metrics.json line a step with finite losses, TensorBoard
    scalars, ckpt_2 and ckpt_3, model_final.npz and config.json."""
    from uwcv_tpu_torch.utils.tb_writer import read_scalars

    cfg = _gate_small(tmp_path)
    tr = _fit(cfg, dicts, 3)
    assert tr.step == 3
    lines = [json.loads(l) for l in open(tmp_path / "metrics.json")]
    assert [l["iteration"] for l in lines] == [1, 2, 3]
    for l in lines:
        for k in ("rpn_cls", "rpn_loc", "cls", "box_reg", "mask",
                  "total_loss", "time_per_iter"):
            assert np.isfinite(l[k]), (k, l)
    events = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    assert len(events) == 1
    scalars = read_scalars(events[0])
    assert [s for s, _ in scalars] == [1, 2, 3]
    assert scalars[-1][1]["train/total_loss"] == pytest.approx(
        lines[-1]["total_loss"], rel=1e-6)
    names = sorted(os.listdir(tmp_path))
    assert "ckpt_0000002.pt" in names and "ckpt_0000003.pt" in names
    assert "model_final.npz" in names and "config.json" in names
    saved = json.load(open(tmp_path / "config.json"))
    assert saved["model"]["depth"] == 26


@pytest.fixture
def deterministic():
    """Deterministic CPU kernels for one test (the threaded convolution
    backward otherwise sums in a varying order)."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def test_resume_equals_an_uninterrupted_run(dicts, tmp_path, deterministic):
    """4 steps straight against 2 steps, then a new Trainer resumed from
    ckpt_2 for 2 more, its loader skipping the 2 batches taken: identical
    weights, traces and losses."""
    a = _fit(_gate_small(tmp_path / "a"), dicts, 4)
    _fit(_gate_small(tmp_path / "b"), dicts, 2)
    b = _fit(_gate_small(tmp_path / "b"), dicts, 4, resume=True)
    assert b.step == 4
    for (n, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), n
    for ta, tb in zip(a.traces, b.traces):
        assert torch.equal(ta, tb)
    la = [json.loads(l) for l in open(tmp_path / "a" / "metrics.json")]
    lb = [json.loads(l) for l in open(tmp_path / "b" / "metrics.json")]
    assert [l["total_loss"] for l in la] == [l["total_loss"] for l in lb]


def test_model_final_loads_into_both_predictors(jax_params, tmp_path):
    """model_final.npz (flat Flax layout, f32) loads into the port's
    Predictor through load_predictor (config.json beside it) and into the
    JAX package's load_params_npz, with the trained values."""
    from uwcv_tpu_torch.engine.predictor import load_predictor

    cfg = _small(Config(), tmp_path)
    tr = Trainer(cfg, device="cpu")
    tr.init_state(seed=3)
    tr.save_checkpoint(final=True)
    path = str(tmp_path / "model_final.npz")
    want = params_to_flax(tr.model)

    pred = load_predictor(Config(), path, device="cpu")
    assert pred.cfg.model.depth == 26 and pred.cfg.model.fpn_channels == 32
    got = params_to_flax(pred.model)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])

    _, target = jax_params
    loaded = _flat(load_params_npz(path, target))
    assert loaded.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(loaded[k], want[k])


def test_init_state_is_seeded_and_keeps_the_global_rng(tmp_path):
    cfg = _small(Config(), tmp_path)
    tr = Trainer(cfg, device="cpu")
    torch.manual_seed(123)
    before = torch.rand(3)
    torch.manual_seed(123)
    tr.init_state(seed=5)
    a = params_to_flax(tr.model)
    assert torch.equal(torch.rand(3), before)
    tr.init_state(seed=5)
    b = params_to_flax(tr.model)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("size", [256, 200, 320])
def test_prepare_train_sample_matches_jax(dicts, monkeypatch, size):
    """Boxes, classes, valid and masks exact (the JAX package's scanline
    rasterizer, as the port's); the image exact at the native 256² and
    within 2 gray levels when resized (PIL's bilinear there, the port's
    antialiased torch resize here)."""
    monkeypatch.setattr(j_rasterize, "_HAS_PIL", False)
    jcfg, cfg = JaxConfig(), Config()
    for c in (jcfg, cfg):
        c.input.train_size = (size, size)
    for d in dicts[:3]:
        want = j_loader.prepare_train_sample(d, jcfg, n_max=16)
        got = prepare_train_sample(d, cfg, n_max=16)
        assert got.keys() == want.keys()
        for k in ("boxes", "classes", "valid", "masks_packed",
                  "num_instances"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        diff = np.abs(got["image"].astype(int) - want["image"].astype(int))
        assert diff.max() <= (0 if size == 256 else 2), diff.max()
        assert int(want["num_instances"]) > 0


@pytest.mark.parametrize("process_index, process_count, batch",
                         [(0, 1, 2), (0, 2, 2), (1, 2, 2), (2, 3, 6),
                          (3, 4, 8)])
def test_index_batches_match_jax(dicts, process_index, process_count, batch):
    """The index stream of one process of ``process_count``, at a global
    batch of ``batch``, is the JAX loader's (one process: the whole
    stream)."""
    jcfg, cfg = JaxConfig(), Config()
    jcfg.solver.ims_per_batch = cfg.solver.ims_per_batch = batch
    kw = {"process_index": process_index, "process_count": process_count}
    want = j_loader.TrainLoader(dicts, jcfg, seed=5, **kw).index_batches()
    got = TrainLoader(dicts, cfg, seed=5, **kw).index_batches()
    for _ in range(15):
        g = next(got)
        assert len(g) == batch // process_count
        np.testing.assert_array_equal(g, next(want))


def test_skip_advances_both_loader_paths(dicts):
    """After ``skip(5)`` the index batches, and the one-worker streaming
    path's batches, are the 6th and on of a fresh loader's."""
    cfg = _small(Config())
    fresh = TrainLoader(dicts, cfg, seed=5).index_batches()
    want = [next(fresh) for _ in range(8)][5:]
    skipped = TrainLoader(dicts, cfg, seed=5)
    skipped.skip(5)
    got = skipped.index_batches()
    for w in want:
        np.testing.assert_array_equal(next(got), w)
    streaming = TrainLoader(dicts, cfg, seed=5, num_workers=1)
    streaming.skip(5)
    dd = streaming.device_dataset("cpu")
    streaming.start()
    try:
        batch = next(iter(streaming))
    finally:
        streaming.stop()
    np.testing.assert_array_equal(batch["image"],
                                  dd["image"].numpy()[want[0]])


def test_streaming_loader_matches_device_dataset(dicts):
    """The worker-thread path yields batches whose rows are prepared
    samples (cache on), with the dataset-tightened gt capacity."""
    cfg = _small(Config())
    loader = TrainLoader(dicts, cfg, seed=1, num_workers=2)
    dd = loader.device_dataset("cpu")
    try:
        batch = next(iter(loader))
    finally:
        loader.stop()
    assert batch["image"].shape == (2, 64, 64, 3)
    assert batch["masks_packed"].shape[1] == loader.n_max
    observed = max(len(d["annotations"]) for d in dicts)
    assert loader.n_max == min(16, max(8, -(-observed // 8) * 8))
    assert dd["boxes"].shape == (12, loader.n_max, 4)
    rows = [int(np.nonzero((dd["image"].numpy() == im).all(axis=(1, 2, 3)))
                [0][0]) for im in batch["image"]]
    for i, r in enumerate(rows):
        np.testing.assert_array_equal(batch["masks_packed"][i],
                                      dd["masks_packed"][r].numpy())


def test_fit_streams_host_batches(dicts, tmp_path):
    """``fit`` on the worker-thread loader's host batches (the path for a
    dataset that does not fit the device budget): two finite steps."""
    cfg = _gate_small(tmp_path)
    tr = Trainer(cfg, device="cpu")
    loader = TrainLoader(dicts, cfg, seed=0, num_workers=2).start()
    try:
        assert tr.fit(iter(loader), max_iter=2, log_fn=lambda *_: None) == 2
    finally:
        loader.stop()
    lines = [json.loads(l) for l in open(tmp_path / "metrics.json")]
    assert len(lines) == 2 and all(np.isfinite(l["total_loss"])
                                   for l in lines)


def _cli_train_args(out, max_iter):
    """The ``train`` verb on the CPU over the gate split, from the gate
    checkpoint at 64²."""
    with open(os.path.join(GATE_SPLIT, "jax", "gate_config.json")) as f:
        saved = json.load(f)
    args = ["train", "--device", "cpu", "--data-dir",
            os.path.join(GATE_SPLIT, "Test"), "--output-dir", str(out),
            "--weights", os.path.join(REPO, "assets", "gate",
                                      "gate_ckpt.npz"),
            "-o", f"data.classes_csv={GATE_SPLIT}/classes.csv",
            "-o", f"solver.max_iter={max_iter}", "-o", "solver.log_period=1",
            "-o", "input.train_size=64,64"]
    for key in ("depth", "fpn_channels", "box_fc_dim", "dtype"):
        args += ["-o", f"model.{key}={saved['model'][key]}"]
    return args + ["-o", "model.anchor_aspect_ratios=" + ",".join(
        str(r) for r in saved["model"]["anchor_aspect_ratios"])]


def test_cli_train_on_cpu(tmp_path):
    """``train --device cpu`` for 2 steps on the gate split, from the gate
    checkpoint: model_final.npz, ckpt_2 and two metrics lines."""
    from uwcv_tpu_torch.cli.main import main

    assert main(_cli_train_args(tmp_path, 2)) == 0
    assert (tmp_path / "model_final.npz").exists()
    assert (tmp_path / "ckpt_0000002.pt").exists()
    assert len(open(tmp_path / "metrics.json").read().splitlines()) == 2


def test_cli_resume_equals_an_uninterrupted_run(tmp_path, deterministic):
    """``train --resume`` from ckpt_2 to step 3 logs the losses, and
    writes the weights, of a straight 3-step run."""
    from uwcv_tpu_torch.cli.main import main

    assert main(_cli_train_args(tmp_path / "a", 3)) == 0
    assert main(_cli_train_args(tmp_path / "b", 2)) == 0
    assert main(_cli_train_args(tmp_path / "b", 3) + ["--resume"]) == 0
    la = [json.loads(l) for l in open(tmp_path / "a" / "metrics.json")]
    lb = [json.loads(l) for l in open(tmp_path / "b" / "metrics.json")]
    assert [l["total_loss"] for l in la] == [l["total_loss"] for l in lb]
    fa = load_npz(str(tmp_path / "a" / "model_final.npz"))
    fb = load_npz(str(tmp_path / "b" / "model_final.npz"))
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
