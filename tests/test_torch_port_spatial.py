"""The port's model axis (``parallel.mesh_shape = (d, m)``, m > 1) on the
CPU, against the JAX package: ``build_mesh`` against JAX's mesh, the row
shards of ``height_shards``, the halo exchange and the halo-exchanged
convs and pool of ``parallel/spatial.py`` against the unsharded ops, the
spatial trunk against the JAX ResNet+FPN, training over (1, 2) and (2, 2)
meshes of gloo ranks (``Trainer``, the ``train`` verb, an HPO group
trial) and ``Predictor(mesh=...)`` over a (1, 2) mesh.

The halo tests run the m shards of a row in one process through the
in-process communicator (``spatial.DeviceRow``); the training tests spawn
gloo ranks, each with a ``file://`` rendezvous under the test's
``tmp_path`` and a timeout of its own.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from torch_port_harness import hang_report, hang_report_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from test_torch_port_parallel import _train_args  # noqa: E402
from uwcv_tpu_torch.config import Config, ParallelConfig  # noqa: E402
from uwcv_tpu_torch.parallel import mesh, spatial  # noqa: E402
from uwcv_tpu_torch.weights import load_npz  # noqa: E402

GATE_CKPT = os.path.join(REPO, "assets", "gate", "gate_ckpt.npz")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_gate_golden.npz")
RANK_TIMEOUT = 240

# (k, s, p) of every op with a halo, and of the row-local 1×1 convs
# (models/resnet.py, models/fpn.py); the FPN output conv is the 3×3
# stride-1 case
WINDOWS = {"stem conv 7/2/3": ("conv", 7, 2, 3),
           "stem max-pool 3/2/1": ("pool", 3, 2, 1),
           "3x3 stride 1": ("conv", 3, 1, 1),
           "3x3 stride 2": ("conv", 3, 2, 1),
           "1x1 stride 1": ("conv", 1, 1, 0),
           "1x1 stride 2": ("conv", 1, 2, 0)}


# ---------------------------------------------------------------- mesh

@pytest.mark.parametrize("shape", [(-1, 2), (2, 4)])
def test_build_mesh_matches_jax_over_a_model_axis(shape):
    """The port's mesh over 8 devices has JAX's shape and JAX's device
    order over its 8 virtual CPU devices (row-major: data row i holds
    devices i·m … i·m + m − 1)."""
    from uwcv_tpu.config import ParallelConfig as JaxPar
    from uwcv_tpu.parallel import mesh as j_mesh

    want = j_mesh.build_mesh(JaxPar(mesh_shape=shape))
    got = mesh.build_mesh(ParallelConfig(mesh_shape=shape),
                          devices=[torch.device("cuda", i)
                                   for i in range(8)])
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert [[d.index for d in row] for row in got.devices] == \
        [[d.id for d in row] for row in want.devices]


def test_height_shards():
    """Interior boundaries on multiples of 64 rows, the last shard takes
    the remainder, every shard has rows, and a too-short image raises."""
    assert mesh.height_shards(800, 2) == [(0, 448), (448, 800)]
    assert mesh.height_shards(256, 4) == [(0, 64), (64, 128), (128, 192),
                                          (192, 256)]
    assert mesh.height_shards(300, 4) == [(0, 128), (128, 192), (192, 256),
                                          (256, 300)]
    assert mesh.height_shards(193, 4)[-1] == (192, 193)
    for h, m in ((800, 3), (4096, 4), (1024, 2), (65, 2)):
        rows = mesh.height_shards(h, m)
        assert rows[0][0] == 0 and rows[-1][1] == h
        assert all(b == a2 and b % 64 == 0
                   for (_, b), (a2, _) in zip(rows, rows[1:]))
        assert all(b > a for a, b in rows)
    with pytest.raises(ValueError, match="at least 193"):
        mesh.height_shards(192, 4)
    with pytest.raises(ValueError, match="at least 65"):
        mesh.height_shards(64, 2)
    # each FPN level's shard is rows [a/s, b/s), p6 = p5[::2] included
    rows = mesh.height_shards(800, 2)
    assert spatial.level_heights(rows, 32) == [14, 11]
    assert spatial.level_heights(rows, 64) == [7, 6]


def test_a_model_axis_needs_a_process_group():
    """In a one-process run a model axis above 1 raises; (d, 1) gives no
    axes at all."""
    assert mesh.mesh_axes(1) == (None, None, None)
    with pytest.raises(ValueError, match="one process per device"):
        mesh.mesh_axes(2)


# ---------------------------------------------------------------- halos

def _split(x, rows):
    return spatial.Shards([x[:, :, a:b] for a, b in rows])


@pytest.mark.parametrize("m", [2, 3, 4])
def test_halo_exchange_extends_each_shard_by_its_neighbours_rows(m):
    """Shard j becomes rows [a_j − top, b_j + bottom) of the whole,
    clipped at the image's edges (no halo there); the backward adds each
    halo row's gradient into the row's owner."""
    h = 64 * m - 32                         # the last shard is uneven
    rows = mesh.height_shards(h, m)
    axis = spatial.DeviceRow(["cpu"] * m)
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.normal(size=(2, 3, h, 5))).float()
    x.requires_grad_(True)
    top, bottom = 3, 2
    out = spatial.halo_exchange(_split(x, rows), top, bottom, axis)
    weights = []
    for (a, b), part in zip(rows, out.parts):
        lo, hi = max(a - top, 0), min(b + bottom, h)
        torch.testing.assert_close(part, x[:, :, lo:hi], rtol=0, atol=0)
        weights.append(torch.from_numpy(rng.normal(size=part.shape)).float())
    sum((p * w).sum() for p, w in zip(out.parts, weights)).backward()
    want = torch.zeros_like(x)
    for (a, b), w in zip(rows, weights):
        lo = max(a - top, 0)
        want[:, :, lo:lo + w.shape[2]] += w
    torch.testing.assert_close(x.grad, want, rtol=1e-6, atol=1e-6)


def test_a_shard_shorter_than_its_halo_raises():
    axis = spatial.DeviceRow(["cpu"] * 3)
    x = torch.zeros(1, 1, 66, 4)
    parts = _split(x, [(0, 64), (64, 65), (65, 66)])
    with pytest.raises(ValueError, match="fewer than the halo"):
        spatial.halo_exchange(parts, 3, 2, axis)


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("op", list(WINDOWS))
def test_halo_op_matches_the_unsharded_op(op, m):
    """Each (k, s, p) of the trunk on m row shards (the last one uneven):
    the gathered output and the input gradient equal the unsharded op's
    within 1e-6 in f32, and so does the weight gradient summed over the
    shards in f64.  (In f32 the weight gradient, a sum over ~10⁴ products
    per element, differs from the unsharded one by up to 2e-6 of its
    largest element through the order of the sums alone.)"""
    kind, k, s, p = WINDOWS[op]
    h = 64 * m - 32
    rows = mesh.height_shards(h, m)
    axis = spatial.DeviceRow(["cpu"] * m)
    for dtype in (torch.float32, torch.float64):
        torch.manual_seed(k * 10 + s + m)
        x = torch.randn(2, 6, h, 40, dtype=dtype, requires_grad=True)
        conv = nn.Conv2d(6, 5, k, stride=s, padding=p).to(dtype)
        run = ((lambda t, ax=None: spatial.spatial_conv2d(t, conv, ax))
               if kind == "conv" else
               (lambda t, ax=None: spatial.spatial_max_pool2d(t, k, s, p,
                                                              ax)))
        want = conv(x) if kind == "conv" else F.max_pool2d(x, k, s, p)
        torch.testing.assert_close(run(x), want, rtol=0, atol=0)
        g = torch.randn_like(want)
        (want * g).sum().backward()
        want_dx = x.grad.clone()
        want_dw = conv.weight.grad.clone() if kind == "conv" else None
        x.grad = None
        conv.zero_grad()
        got = spatial.gather_rows(run(_split(x, rows), axis), axis,
                                  spatial.level_heights(rows, s))
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        (got * g).sum().backward()
        torch.testing.assert_close(x.grad, want_dx, rtol=1e-6, atol=1e-6)
        if kind == "conv" and dtype == torch.float64:
            torch.testing.assert_close(conv.weight.grad, want_dw, rtol=1e-6,
                                       atol=1e-6)


# ---------------------------------------------------------------- trunk

@pytest.fixture(scope="module")
def trunks():
    """The JAX R26/FPN-64 trunk's levels on 2 × 256 × 256 × 3 seeded
    images, and the port's MaskRCNN with the same seeded weights."""
    import jax
    import jax.numpy as jnp

    from uwcv_tpu.config import Config as JaxConfig
    from uwcv_tpu.models.rcnn import MaskRCNN as JaxMaskRCNN, init_params
    from uwcv_tpu_torch.models.rcnn import MaskRCNN
    from uwcv_tpu_torch.weights import params_from_flax

    jcfg, cfg = JaxConfig(), Config()
    for m in (jcfg.model, cfg.model):
        m.depth, m.fpn_channels, m.box_fc_dim, m.dtype = 26, 64, 64, "float32"
    jm = JaxMaskRCNN(jcfg.model)
    params = init_params(jm, jax.random.key(0), init_size=64)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    tm = MaskRCNN(cfg.model)
    tm.load_state_dict(params_from_flax(flat), strict=True)
    tm.eval().requires_grad_(False)
    images = (np.random.default_rng(0).random((2, 256, 256, 3))
              * 255).astype(np.float32)
    jfeats = jm.apply(params, jnp.asarray(images),
                      method=lambda mod, x: mod._features(x))
    return tm, images, {k: np.asarray(v) for k, v in jfeats.items()}


@pytest.mark.parametrize("m", [2, 4])
def test_spatial_trunk_matches_jax(trunks, m):
    """ResNet-26 + FPN-64 on m row shards of each image, the levels
    gathered: p2..p6 within 1e-4 of the JAX trunk's on the same inputs
    (the unsharded port's test bound), and within 1e-5 of the unsharded
    port's."""
    tm, images, jfeats = trunks
    x = torch.from_numpy(images)
    got = tm.features(x, spatial.DeviceRow(["cpu"] * m))
    plain = tm.features(x)
    assert got.keys() == jfeats.keys()
    for k, want in jfeats.items():
        g = got[k].permute(0, 2, 3, 1).numpy()
        assert g.shape == want.shape, k
        tol = 1e-4 * max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(g, want, rtol=1e-4, atol=tol, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), plain[k].numpy(),
                                   rtol=1e-5, atol=1e-5 * tol, err_msg=k)


# ---------------------------------------------------------------- training

def test_a_model_axis_of_two_reproduces_the_jax_golden(tmp_path):
    """A (1, 2) mesh of two gloo ranks, each running the trunk on half of
    the rows of the golden's two 256² images, 3 SGD steps in f32
    (``chip_smoke.dp_golden``): each step's losses and the step-0 global
    gradient norms within 1e-3 relative of the JAX package's global-batch
    golden (the dp golden's bound); the masters bit-identical."""
    import chip_smoke

    recs = chip_smoke.run_ranks(2, "gloo", "cpu", ("golden",),
                                str(tmp_path / "sp"), timeout=RANK_TIMEOUT,
                                mesh_shape=(1, 2))
    for rec in recs:
        g = rec["golden"]
        assert g["steps"] == 3 and g["leaves"] > 0
        assert g["worst_loss_rel"] <= 1e-3
        assert g["worst_grad_norm_rel"] <= 1e-3
    assert recs[0]["golden"]["masters_sha256"] == \
        recs[1]["golden"]["masters_sha256"]


def test_a_2x2_mesh_equals_the_2x1_mesh(tmp_path):
    """Four gloo ranks as a (2, 2) mesh and two as (2, 1), the golden's 3
    steps: every loss within 1e-5 relative, and the four ranks' masters
    bit-identical (each image counted once in the denominators, the
    logged losses and the gradient sum)."""
    import chip_smoke

    four = chip_smoke.run_ranks(4, "gloo", "cpu", ("golden",),
                                str(tmp_path / "sp"), timeout=RANK_TIMEOUT,
                                mesh_shape=(2, 2))
    two = chip_smoke.run_ranks(2, "gloo", "cpu", ("golden",),
                               str(tmp_path / "dp"), timeout=RANK_TIMEOUT,
                               mesh_shape=(2, 1))
    assert len({r["golden"]["masters_sha256"] for r in four}) == 1
    want = np.asarray(two[0]["golden"]["losses"])
    for rec in four:
        np.testing.assert_allclose(rec["golden"]["losses"], want, rtol=1e-5)


def test_train_verb_over_a_model_axis_equals_one_process(tmp_path):
    """``train --device cpu -o parallel.mesh_shape=1,2 -o
    parallel.num_processes=2`` (two gloo workers splitting each 128² image's
    height) writes the ``metrics.json`` losses and ``model_final.npz`` of
    a one-process run at the same batch of 2 within 1e-5 relative."""
    from uwcv_tpu_torch.cli.main import main

    size = ["-o", "input.train_size=128,128"]
    assert main(_train_args(tmp_path / "one", 2, size)) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "uwcv_tpu_torch.cli.main",
         *_train_args(tmp_path / "sp", 2, [
             *size, "-o", "parallel.mesh_shape=1,2",
             "-o", "parallel.num_processes=2", "-o",
             f"parallel.coordinator_address=file://{tmp_path}/rdzv",
             "-o", "parallel.init_timeout_s=120"])],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "2 ranks as a 1×2 mesh" in proc.stdout
    la = [json.loads(l) for l in open(tmp_path / "one" / "metrics.json")]
    lb = [json.loads(l) for l in open(tmp_path / "sp" / "metrics.json")]
    assert [l["iteration"] for l in lb] == [1, 2]
    for a, b in zip(la, lb):
        for k in ("rpn_cls", "rpn_loc", "cls", "box_reg", "mask",
                  "total_loss"):
            assert b[k] == pytest.approx(a[k], rel=1e-5), (k, a, b)
    fa = load_npz(str(tmp_path / "one" / "model_final.npz"))
    fb = load_npz(str(tmp_path / "sp" / "model_final.npz"))
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_allclose(fb[k], fa[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_hpo_group_trial_over_a_model_axis(tmp_path):
    """One HPO group of two CPU devices with ``mesh_shape = (-1, 2)``
    trains its trial as a (1, 2) mesh of two gloo ranks (JAX builds the
    trial's mesh with ``build_mesh(tcfg.parallel, devices=group)``): the
    trial completes, the ranks' masters agree, and its last losses equal
    one process's at the same batch of 2 within 1e-5."""
    from test_torch_port_hpo import _tiny_cfg
    from uwcv_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_superannotate,
    )
    from uwcv_tpu_torch.hpo import study

    def run(key, mesh_shape, ims_per_batch, **kw):
        cfg, paths = _tiny_cfg(tmp_path / key)
        cfg.parallel.mesh_shape = mesh_shape
        cfg.solver.ims_per_batch = ims_per_batch
        cfg.data.train_dataset = f"_sp_{key}"
        cfg.data.dataset_root = str(tmp_path / "nowhere")
        DatasetCatalog.remove(cfg.data.train_dataset)
        register_superannotate(cfg.data.train_dataset, paths["Train"],
                               classes_csv=paths["classes_csv"])
        try:
            res = study.run_reference_hpo(cfg, n_trials=1, max_iter=2,
                                          seed=0, **kw)
        finally:
            DatasetCatalog.remove(cfg.data.train_dataset)
        (trial,) = res["trials"]
        return trial

    sp = run("sp", (-1, 2), 1, n_parallel=1, devices=["cpu", "cpu"])
    one = run("one", (-1, 1), 2, device="cpu")
    assert sp["state"] == one["state"] == "COMPLETE"
    assert sp["params"] == one["params"]
    reps = sp["user_attrs"]["rank_reports"]
    assert sp["user_attrs"]["ranks"] == 2 and len(reps) == 2
    assert reps[0]["masters_sha256"] == reps[1]["masters_sha256"]
    np.testing.assert_allclose(sp["user_attrs"]["losses"],
                               one["user_attrs"]["losses"], rtol=1e-5)


# ---------------------------------------------------------------- inference

def test_predictor_over_a_model_axis_equals_one_device():
    """``Predictor(mesh=build_mesh((1, 2), ["cpu", "cpu"]))`` on the gate
    golden's images with the gate checkpoint in f32: valid, classes and
    masks equal to the one-device predictor's, boxes and scores within
    rtol 1e-5; a (2, 2) mesh over four entries likewise, its batch split
    over the data axis."""
    from uwcv_tpu_torch.engine.predictor import Predictor

    with np.load(GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    cfg = Config.from_dict(json.loads(str(g["config_json"])))
    params = load_npz(GATE_CKPT)
    images = [np.repeat(im, 3, axis=-1) for im in g["images"]]
    images = (images * 2)[:4]
    want = Predictor(cfg, params, device="cpu").predict_batch(images)
    assert sum(int(w.valid.sum()) for w in want) > 0
    for shape, n in (((1, 2), 2), ((2, 2), 4)):
        pred = Predictor(cfg, params, mesh=mesh.build_mesh(
            ParallelConfig(mesh_shape=shape), ["cpu"] * n))
        assert [r.size for r in pred.row_axes] == [2] * shape[0]
        got = pred.predict_batch(images)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.valid, b.valid)
            np.testing.assert_array_equal(a.classes, b.classes)
            np.testing.assert_array_equal(a.masks, b.masks)
            np.testing.assert_allclose(a.boxes, b.boxes, rtol=1e-5,
                                       atol=1e-4)
            np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5,
                                       atol=1e-6)
