"""The port's data parallelism (``uwcv_tpu_torch/parallel/mesh.py``, the
process-sharded ``TrainLoader``, ``MaskRCNN.forward_train(world=...)``,
the data-parallel ``Trainer`` and ``train`` verb) on the CPU with gloo,
against the JAX package.

Every multi-process run here uses a ``file://`` rendezvous under the
test's ``tmp_path`` (parallel test workers cannot collide on a port), two
threads a rank, and a timeout of its own, so a hung rank fails its test
instead of stalling the suite.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_harness import hang_report, hang_report_module  # noqa: F401
from uwcv_tpu.config import Config as JaxConfig, ParallelConfig as JaxPar
from uwcv_tpu.parallel import mesh as j_mesh
from uwcv_tpu_torch.config import Config, ParallelConfig
from uwcv_tpu_torch.data.loader import TrainLoader
from uwcv_tpu_torch.parallel import mesh
from uwcv_tpu_torch.weights import load_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
GATE_SPLIT = os.path.join(REPO, "tests", "data", "gate_split")
RANK_TIMEOUT = 240


# ---------------------------------------------------------------- mesh API

def test_mesh_shape_over_an_explicit_device_list():
    """(-1, 1) puts every given device on the data axis, in order, repeats
    included; JAX's mesh over its 8 virtual devices has the same shape."""
    m = mesh.build_mesh(ParallelConfig(), devices=["cpu"] * 8)
    want = j_mesh.build_mesh(JaxPar())
    assert m.shape == dict(want.shape) == {"data": 8, "model": 1}
    assert m.axis_names == tuple(want.axis_names)
    assert m.devices.shape == (8, 1)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    two = mesh.build_mesh(ParallelConfig(mesh_shape=(2, 1)),
                          devices=["cpu"] * 3)
    assert two.shape == {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="needs 4 devices"):
        mesh.build_mesh(ParallelConfig(mesh_shape=(4, 1)),
                        devices=["cpu"] * 3)


def test_model_axis_raises():
    """A model axis of 2 no longer raises: over 8 devices the port builds
    JAX's (-1, 2) mesh, 4 × 2, its devices in JAX's order (data row i
    holds devices 2i and 2i + 1)."""
    want = j_mesh.build_mesh(JaxPar(mesh_shape=(-1, 2)))
    got = mesh.build_mesh(ParallelConfig(mesh_shape=(-1, 2)),
                          devices=[torch.device("cuda", i)
                                   for i in range(8)])
    assert got.shape == dict(want.shape) == {"data": 4, "model": 2}
    assert got.axis_names == tuple(want.axis_names)
    assert [[d.index for d in row] for row in got.devices] == \
        [[d.id for d in row] for row in want.devices]


def test_shard_batch_gives_each_device_jax_rows():
    """Device d of the data axis holds the rows JAX's ``batch_sharding``
    gives device d of its mesh, at batch 8 and 16."""
    jm = j_mesh.build_mesh(JaxPar())
    m = mesh.build_mesh(ParallelConfig(), devices=["cpu"] * 8)
    for n in (8, 16):
        x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        sharded = j_mesh.shard_batch({"x": x}, jm)["x"]
        by_device = {s.device: np.asarray(s.data)
                     for s in sharded.addressable_shards}
        got = mesh.shard_batch({"x": x}, m)
        for d, jdev in enumerate(jm.devices[:, 0]):
            np.testing.assert_array_equal(got[d]["x"].numpy(),
                                          by_device[jdev])
    with pytest.raises(ValueError, match="does not tile"):
        mesh.batch_sharding(m, 12)


def test_replicate_puts_a_copy_on_each_device():
    m = mesh.build_mesh(ParallelConfig(), devices=["cpu", "cpu"])
    w = torch.arange(4.0)
    reps = mesh.replicate({"w": w, "l": [w]}, m)
    assert len(reps) == 2
    for r in reps:
        assert torch.equal(r["w"], w) and r["w"] is not w
        assert torch.equal(r["l"][0], w)
    mod = torch.nn.Linear(2, 2)
    a, b = mesh.replicate(mod, m)
    assert a is not b and torch.equal(a.weight, mod.weight)


def test_initialize_multi_host_is_idempotent(tmp_path):
    """Without ``multi_host`` nothing is joined; with it a one-process
    gloo group from a ``file://`` address, which a second call keeps;
    ``mesh_axes`` gives no axes for one process."""
    import torch.distributed as dist

    assert not mesh.initialize_multi_host(ParallelConfig(), "cpu")
    assert not dist.is_initialized()
    cfg = ParallelConfig(multi_host=True, num_processes=1, process_id=0,
                         coordinator_address=f"file://{tmp_path}/rdzv",
                         init_timeout_s=60)
    try:
        assert mesh.initialize_multi_host(cfg, "cpu") is False
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert mesh.initialize_multi_host(cfg, "cpu") is False
        assert mesh.mesh_axes() == (None, None, None)
    finally:
        dist.destroy_process_group()


def test_local_rank_reads_torchrun_then_the_config(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setenv("RANK", "3")
    assert mesh.local_rank() == 3
    assert mesh.local_rank(ParallelConfig(process_id=1)) == 1
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert mesh.local_rank(ParallelConfig(process_id=1)) == 2


# ---------------------------------------------------------------- loader

@pytest.fixture(scope="module")
def dicts():
    from uwcv_tpu_torch.data.superannotate import get_superannotate_dicts

    return get_superannotate_dicts(os.path.join(GATE_SPLIT, "Test"))


@pytest.mark.parametrize("kwargs, match", [
    ({"process_index": 2, "process_count": 2}, "process_index"),
    ({"process_index": -1, "process_count": 2}, "process_index"),
    ({"process_index": 0, "process_count": 3}, "must divide"),
])
def test_loader_rejects_what_jax_rejects(dicts, kwargs, match):
    from uwcv_tpu.data.loader import TrainLoader as JaxLoader

    jcfg, cfg = JaxConfig(), Config()
    with pytest.raises(ValueError, match=match):
        JaxLoader(dicts, jcfg, **kwargs)
    with pytest.raises(ValueError, match=match):
        TrainLoader(dicts, cfg, **kwargs)


def test_loader_rejects_a_dataset_smaller_than_the_process_count(dicts):
    cfg = Config()
    cfg.solver.ims_per_batch = 4
    with pytest.raises(ValueError, match="process_count"):
        TrainLoader(dicts[:3], cfg, process_index=0, process_count=4)


def test_ranks_cover_each_epoch_once(dicts):
    """Two ranks' index streams interleave to the one-process stream
    (rank-major at batch 2): together one pass over the data an epoch."""
    cfg = Config()
    one = TrainLoader(dicts, cfg, seed=3).index_batches()
    ranks = [TrainLoader(dicts, cfg, seed=3, process_index=r,
                         process_count=2).index_batches() for r in (0, 1)]
    for _ in range(2 * len(dicts)):
        got = np.concatenate([next(s) for s in ranks])
        np.testing.assert_array_equal(got, next(one))


# ---------------------------------------------------------------- training

def test_trainer_mesh_places_its_rank(tmp_path):
    """A trainer's mesh puts one rank on each device of its data axis: in
    a one-process run a one-device mesh places the trainer on its device,
    and a mesh of two devices raises."""
    from uwcv_tpu_torch.engine.trainer import Trainer

    cfg = Config()
    cfg.model.depth, cfg.model.fpn_channels, cfg.model.box_fc_dim = 26, 32, 32
    cfg.output_dir = str(tmp_path)
    tr = Trainer(cfg, mesh=mesh.build_mesh(ParallelConfig(),
                                           devices=["cpu"]))
    assert tr.device == torch.device("cpu")
    assert tr.world is None and (tr.rank, tr.ranks) == (0, 1)
    with pytest.raises(ValueError, match="one rank on each device"):
        Trainer(cfg, mesh=mesh.build_mesh(ParallelConfig(),
                                          devices=["cpu", "cpu"]))


def test_two_ranks_reproduce_the_jax_global_batch_golden(tmp_path):
    """Two gloo ranks, each on one image of the JAX package's global-batch
    train golden with its rows of the golden's sampler draws, 3 SGD steps
    in f32 (``chip_smoke.dp_golden``): each step's all-reduced losses and
    the step-0 gradient norms summed over the ranks within 1e-3 relative
    of the golden; the masters bit-identical across the ranks."""
    import chip_smoke

    recs = chip_smoke.run_ranks(2, "gloo", "cpu", ("golden",),
                                str(tmp_path / "dp"), timeout=RANK_TIMEOUT)
    for rec in recs:
        g = rec["golden"]
        assert g["steps"] == 3 and g["leaves"] > 0
        assert g["worst_loss_rel"] <= 1e-3
        assert g["worst_grad_norm_rel"] <= 1e-3
    assert recs[0]["golden"]["masters_sha256"] == \
        recs[1]["golden"]["masters_sha256"]


def _train_args(out, max_iter, extra=()):
    """The ``train`` verb on the CPU over the gate split from the gate
    checkpoint at 64², augmentation on (the default config's), global
    batch 2, a checkpoint every 2 steps."""
    with open(os.path.join(GATE_SPLIT, "jax", "gate_config.json")) as f:
        saved = json.load(f)
    args = ["train", "--device", "cpu", "--data-dir",
            os.path.join(GATE_SPLIT, "Test"), "--output-dir", str(out),
            "--weights", os.path.join(REPO, "assets", "gate",
                                      "gate_ckpt.npz"),
            "-o", f"data.classes_csv={GATE_SPLIT}/classes.csv",
            "-o", f"solver.max_iter={max_iter}", "-o", "solver.log_period=1",
            "-o", "solver.checkpoint_period=2",
            "-o", "solver.ims_per_batch=2", "-o", "input.train_size=64,64"]
    for key in ("depth", "fpn_channels", "box_fc_dim", "dtype"):
        args += ["-o", f"model.{key}={saved['model'][key]}"]
    return args + ["-o", "model.anchor_aspect_ratios=" + ",".join(
        str(r) for r in saved["model"]["anchor_aspect_ratios"]), *extra]


def test_two_rank_train_verb_equals_one_process(tmp_path):
    """``train --device cpu`` with two gloo workers at global batch 2, 2
    steps and then ``--resume`` to 3, writes the ``model_final.npz`` and
    the ``metrics.json`` losses of a straight one-process run at batch 2
    within 1e-5 relative: each rank draws the global batch's augmentation
    and sampler uniforms and keeps its rows, the batch is rank-major, and
    a resumed rank takes rank 0's weights, traces and step."""
    from uwcv_tpu_torch.cli.main import main

    aug = Config().input
    assert aug.rotation_prob > 0 and aug.vflip_prob > 0
    assert main(_train_args(tmp_path / "one", 3)) == 0
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for i, (steps, resume) in enumerate(((2, []), (3, ["--resume"]))):
        proc = subprocess.run(
            [sys.executable, "-m", "uwcv_tpu_torch.cli.main",
             *_train_args(tmp_path / "two", steps, [
                 *resume, "-o", "parallel.num_processes=2", "-o",
                 f"parallel.coordinator_address=file://{tmp_path}/rdzv{i}",
                 "-o", "parallel.init_timeout_s=120"])],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=RANK_TIMEOUT)
        assert proc.returncode == 0, proc.stderr[-4000:]
        assert "2 ranks" in proc.stdout
    assert (tmp_path / "two" / "ckpt_0000002.pt").exists()
    la = [json.loads(l) for l in open(tmp_path / "one" / "metrics.json")]
    lb = [json.loads(l) for l in open(tmp_path / "two" / "metrics.json")]
    assert [l["iteration"] for l in lb] == [1, 2, 3]
    for a, b in zip(la, lb):
        for k in ("rpn_cls", "rpn_loc", "cls", "box_reg", "mask",
                  "total_loss"):
            assert b[k] == pytest.approx(a[k], rel=1e-5), (k, a, b)
    fa = load_npz(str(tmp_path / "one" / "model_final.npz"))
    fb = load_npz(str(tmp_path / "two" / "model_final.npz"))
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_allclose(fb[k], fa[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    # rank 0 alone wrote the run's files
    names = sorted(os.listdir(tmp_path / "two"))
    assert names.count("metrics.json") == 1
    assert len([n for n in names if n.startswith("events.out")]) == 2
