"""The port's training forward, gradients and optimizer step against the
JAX package's, on the CPU in f32.

The committed gate checkpoint (R26 / FPN-64 / box-FC-256, its config in
``tests/data/gate_split/jax/gate_config.json``) trains on two gate test
images at 256² with augmentation off.  Both packages get the same numpy
batch, the same weights and the same sampler draws: the test derives the
uniforms ``jax.random`` gives ``forward_train`` (split per image, then
rpn/roi keys, then k_pos/k_neg) and hands them to the port.

Also holds the writer of ``tests/data/torch_port_train_golden.npz`` — the
JAX package's losses over three SGD steps and the step-1 gradient norms,
which ``chip_smoke.py`` holds the port against on the GPU — and a test that
the committed golden is current.  Regenerate it with

    JAX_PLATFORMS=cpu python tests/test_torch_port_train_model.py
"""

import copy
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_harness import hang_report, hang_report_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_train_golden.npz")
GATE_CKPT = os.path.join(REPO, "assets", "gate", "gate_ckpt.npz")
GATE_SPLIT = os.path.join(REPO, "tests", "data", "gate_split")
N_IMAGES = 2
GOLDEN_STEPS = 3
GOLDEN_LR = 0.02
LOSS_KEYS = ("rpn_cls", "rpn_loc", "cls", "box_reg", "mask")


def train_config(cls, golden: bool = False):
    """The gate config (``cls`` is either package's Config) with
    augmentation off: identity blends, no rotation, lighting or flip.

    ``golden`` keeps 64 proposals after NMS instead of 1000.  The ROI
    sampler assigns its draws by candidate index, so two proposals whose
    scores differ in the sixth digit trade places — and draws — between
    the packages once the weights have moved by a step (1000 proposals at
    the gate checkpoint hold such pairs), and the sampled rois then
    differ.  The top 64 hold no such pair over the golden's steps."""
    with open(os.path.join(GATE_SPLIT, "jax", "gate_config.json")) as f:
        cfg = cls.from_dict(json.load(f))
    assert cfg.model.dtype == "float32"
    cfg.input.brightness_range = cfg.input.contrast_range = (1.0, 1.0)
    cfg.input.saturation_range = (1.0, 1.0)
    cfg.input.rotation_prob = cfg.input.vflip_prob = 0.0
    cfg.input.lighting_scale = 0.0
    cfg.solver.ims_per_batch = N_IMAGES
    cfg.solver.base_lr, cfg.solver.warmup_factor = GOLDEN_LR, 1.0
    if golden:
        cfg.model.rpn_post_nms_topk_train = 64
    return cfg


def gate_batch(cfg):
    """The first N_IMAGES gate test images through the JAX package's
    ``prepare_train_sample`` → a numpy batch."""
    from uwcv_tpu.data.loader import collate, prepare_train_sample
    from uwcv_tpu.data.superannotate import get_superannotate_dicts

    dicts = get_superannotate_dicts(os.path.join(GATE_SPLIT, "Test"))
    samples = [prepare_train_sample(d, cfg, n_max=cfg.input.max_gt_instances)
               for d in dicts[:N_IMAGES]]
    return collate(samples)


def jax_sampler_draws(rng, cfg, n_anchors, n_cands, b):
    """The uniforms JAX's ``forward_train`` draws from ``rng``
    (rcnn.py:200,213-215,240-242 and matcher.py:102-117)."""
    out = {k: [] for k in ("rpn_pos", "rpn_neg", "roi_pos", "roi_neg")}
    for key in jax.random.split(rng, b):
        rpn_key, roi_key = jax.random.split(key)
        for name, k, n, weighted in (
                ("rpn", rpn_key, n_anchors, bool(cfg.rpn_fg_class_weights)),
                ("roi", roi_key, n_cands, bool(cfg.roi_fg_class_weights))):
            k_pos, k_neg = jax.random.split(k)
            u_pos = (jax.random.uniform(k_pos, (n,), minval=1e-20, maxval=1.0)
                     if weighted else jax.random.uniform(k_pos, (n,)))
            out[f"{name}_pos"].append(np.asarray(u_pos))
            out[f"{name}_neg"].append(np.asarray(jax.random.uniform(k_neg,
                                                                    (n,))))
    return {k: np.stack(v) for k, v in out.items()}


def _flat(params):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def jax_setup(golden: bool = False):
    """(JAX model, params, cfg, numpy batch with unpacked masks, the
    sampler's candidate counts)."""
    from uwcv_tpu.config import Config
    from uwcv_tpu.engine.checkpoint import load_params_npz
    from uwcv_tpu.models.rcnn import MaskRCNN, init_params

    cfg = train_config(Config, golden)
    model = MaskRCNN(cfg.model)
    params = load_params_npz(GATE_CKPT, init_params(model, jax.random.key(0),
                                                    init_size=64))
    batch = gate_batch(cfg)
    s = cfg.input.train_size[0]
    batch["masks"] = np.unpackbits(batch["masks_packed"], axis=-1)[
        ..., :s].astype(bool)
    anchors = model.apply(params, (s, s), method=lambda m, hw: m._anchors(hw))
    n_anchors = sum(int(a.shape[0]) for a in anchors.values())
    sum_k = sum(min(cfg.model.rpn_pre_nms_topk_train, int(a.shape[0]))
                for a in anchors.values())
    n_cands = (min(cfg.model.rpn_post_nms_topk_train, sum_k)
               + batch["boxes"].shape[1])
    return model, params, cfg, batch, (n_anchors, n_cands)


def jax_loss_and_grads(model, params, batch, rng, grads: bool = True):
    """(total, losses, gradients or None) of JAX's ``forward_train``."""
    from uwcv_tpu.engine.trainer import LOSS_WEIGHTS
    from uwcv_tpu.models.rcnn import MaskRCNN

    def loss_fn(p):
        losses = model.apply(
            p, jnp.asarray(batch["image"], jnp.float32),
            jnp.asarray(batch["boxes"]), jnp.asarray(batch["classes"]),
            jnp.asarray(batch["masks"]), jnp.asarray(batch["valid"]), rng,
            method=MaskRCNN.forward_train)
        return sum(LOSS_WEIGHTS[k] * v for k, v in losses.items()), losses

    if grads:
        (total, losses), g = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    else:
        (total, losses), g = jax.jit(loss_fn)(params), None
    return float(total), {k: float(v) for k, v in losses.items()}, g


def port_inputs(batch, draws):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return ((t(batch["image"]).float(), t(batch["boxes"]),
             t(batch["classes"]).long(), t(batch["masks"]), t(batch["valid"])),
            {k: t(v) for k, v in draws.items()})


def grad_norms(flat_grads, trainable):
    return {k: float(np.linalg.norm(v)) for k, v in flat_grads.items()
            if trainable[k]}


def write_golden(path=GOLDEN):
    """Three SGD steps of the JAX package's optimizer on the gate batch;
    saves the batch, each step's draws, losses and total, and the step-1
    per-leaf gradient norms of the trainable parameters."""
    from uwcv_tpu.engine.trainer import _trainable_mask, make_optimizer

    model, params, cfg, batch, (n_anchors, n_cands) = jax_setup(golden=True)
    tx = make_optimizer(cfg, params)
    opt_state = tx.init(params)
    trainable = _flat(_trainable_mask(params, freeze_at=cfg.solver.freeze_at))
    trainable = {k: bool(v) for k, v in trainable.items()}
    rng = jax.random.key(7)
    out = {"config_json": np.asarray(cfg.dumps())}
    for k in ("image", "boxes", "classes", "valid", "masks_packed"):
        out[k] = batch[k]
    for step in range(GOLDEN_STEPS):
        rng, step_rng = jax.random.split(rng)
        draws = jax_sampler_draws(step_rng, cfg.model, n_anchors, n_cands,
                                  N_IMAGES)
        total, losses, grads = jax_loss_and_grads(model, params, batch,
                                                  step_rng)
        for k, v in draws.items():
            out[f"step{step}_{k}"] = v.astype(np.float32)
        out[f"step{step}_losses"] = np.asarray(
            [losses[k] for k in LOSS_KEYS] + [total], np.float64)
        if step == 0:
            norms = grad_norms(_flat(grads), trainable)
            out["grad_norm_keys"] = np.asarray(sorted(norms))
            out["grad_norms"] = np.asarray([norms[k] for k in sorted(norms)])
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    np.savez_compressed(path, **out)
    return path


# ---------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def setup():
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.models.rcnn import MaskRCNN
    from uwcv_tpu_torch.weights import load_npz, params_from_flax

    model, params, cfg, batch, counts = jax_setup()
    rng = jax.random.key(3)
    draws = jax_sampler_draws(rng, cfg.model, *counts, N_IMAGES)
    total, losses, grads = jax_loss_and_grads(model, params, batch, rng)
    tcfg = train_config(Config)
    tm = MaskRCNN(tcfg.model)
    tm.load_state_dict(params_from_flax(load_npz(GATE_CKPT)), strict=True)
    args, tdraws = port_inputs(batch, draws)
    tlosses = tm.forward_train(*args, draws=tdraws)
    ttotal = sum(tlosses.values())
    ttotal.backward()
    return {"jax": (total, losses, _flat(grads), params), "tm": tm,
            "port": (float(ttotal.detach()),
                     {k: float(v.detach()) for k, v in tlosses.items()}),
            "batch": batch, "draws": draws, "rng": rng, "cfg": cfg,
            "tcfg": tcfg, "args": args, "tdraws": tdraws}


def _port_grads(tm):
    """The port's parameter gradients in the Flax layout."""
    from uwcv_tpu_torch.weights import params_to_flax

    from uwcv_tpu_torch.models.rcnn import MaskRCNN

    gm = MaskRCNN(tm.cfg)
    gm.load_state_dict({n: torch.zeros_like(p) if p.grad is None else p.grad
                        for n, p in tm.named_parameters()}, strict=False)
    return {k: v for k, v in params_to_flax(gm).items()
            if "frozen_bn" not in k}


@pytest.mark.parametrize("key", LOSS_KEYS + ("total",))
def test_losses_match_jax(setup, key):
    """Each loss and the total within 1e-4 relative (f32 sums in another
    order; the samplers pick the same rois from the same draws)."""
    total, losses, _, _ = setup["jax"]
    ttotal, tlosses = setup["port"]
    got, want = (ttotal, total) if key == "total" else (tlosses[key],
                                                        losses[key])
    assert abs(got - want) <= 1e-4 * abs(want), (key, got, want)


def test_gradients_match_jax(setup):
    """Every parameter's gradient within 1e-3 relative L2 of ``jax.grad``'s
    (through the RoIAlign backward, the matcher and both samplers)."""
    _, _, want, _ = setup["jax"]
    got = _port_grads(setup["tm"])
    assert set(got) == {k for k in want if "frozen_bn" not in k}
    worst = {}
    for k, g in got.items():
        w = want[k]
        worst[k] = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
    bad = {k: v for k, v in worst.items() if v > 1e-3}
    assert not bad, bad


def test_optimizer_step_matches_optax(setup, tmp_path):
    """One step of the Trainer's optimizer (gate solver, lr 0.02) on the
    port's gradients against optax on JAX's: every parameter within 1e-5
    relative, frozen ones unchanged, and the moved ones' steps within 1e-3
    relative L2."""
    from uwcv_tpu.engine.trainer import make_optimizer
    from uwcv_tpu_torch.engine.trainer import Trainer
    from uwcv_tpu_torch.weights import (
        flax_leaf_names,
        load_npz,
        params_to_flax,
        to_flax_layout,
    )

    _, _, grads, params = setup["jax"]
    cfg = setup["cfg"]
    tx = make_optimizer(cfg, params)
    tree_grads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [jnp.asarray(grads[k]) for k in _flat(params)])
    updates, _ = tx.update(tree_grads, tx.init(params), params)
    want = _flat(jax.tree_util.tree_map(lambda p, u: p + u, params, updates))
    before = _flat(params)

    tcfg = copy.deepcopy(setup["tcfg"])
    tcfg.output_dir = str(tmp_path)
    tr = Trainer(tcfg, device="cpu")
    tr.load_params(load_npz(GATE_CKPT))
    losses = tr.compute.forward_train(*setup["args"], draws=setup["tdraws"])
    sum(losses.values()).backward()
    with torch.no_grad():
        tr._apply_gradients()
    got = params_to_flax(tr.model)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    # the momentum trace after one step is the decayed, clipped gradient:
    # optax's update is −lr times it
    flat_updates = _flat(updates)
    names = flax_leaf_names(tr.model)
    traces = {n: t for (n, _, _), t in zip(tr._trainable, tr.traces)}
    moved = 0
    for k, u in flat_updates.items():
        if np.abs(u).max() == 0:
            assert names[k] not in traces, k          # frozen
            np.testing.assert_array_equal(got[k], before[k])
            continue
        t = to_flax_layout(k, traces[names[k]].numpy())
        want_t = u / -GOLDEN_LR
        rel = np.linalg.norm(t - want_t) / np.linalg.norm(want_t)
        assert rel <= 1e-3, (k, rel)
        moved += 1
    assert moved == len(traces)


def test_bf16_rpn_head_gradients_add_in_f32(tmp_path):
    """In bf16 the shared RPN head runs once per level.  The Trainer's
    working copy keeps its weights in f32 and casts them at use, so each
    level's bf16 weight gradient is added in f32, as the vjp of Flax's cast
    adds them: equal (within f32 reassociation, rel 1e-5) to the five
    per-level bf16 gradients summed in f32.  Against the JAX package on
    the same bf16 features: the kernels' gradients within 3e-2 relative L2
    of ``jax.grad`` of the Flax head (the two packages' bf16 convolutions
    round differently; 1.4e-2 at most here); the 1×1 heads' bias gradients,
    which are sums of the bf16 output cotangents, within 4e-3 (2^-8: one
    bf16 rounding per level) of that sum taken exactly.  XLA on the CPU
    adds those cotangents in bf16 and lands 3e-2 to 5e-2 from it, so the
    biases are not held to ``jax.grad``."""
    import torch.nn.functional as F
    from uwcv_tpu.models.rpn import RPNHead as JaxRPNHead
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.trainer import Trainer
    from uwcv_tpu_torch.models.rpn import LEVELS

    cfg = train_config(Config)
    cfg.model.dtype, cfg.output_dir = "bfloat16", str(tmp_path)
    tr = Trainer(cfg, device="cpu")
    tr.init_state(seed=1)
    head = tr.compute.rpn_head
    assert all(p.dtype == torch.float32 for p in head.parameters())
    assert tr.compute.box_head.fc1.weight.dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    c, a = cfg.model.fpn_channels, cfg.model.num_anchors_per_cell
    sizes = dict(zip(LEVELS, (32, 16, 8, 4, 2)))
    feats = {n: rng.standard_normal((2, s, s, c)).astype(np.float32)
             for n, s in sizes.items()}
    co = {n: (rng.standard_normal((2, s, s, a)).astype(np.float32),
              rng.standard_normal((2, s, s, 4 * a)).astype(np.float32))
          for n, s in sizes.items()}
    tfeat = {n: torch.from_numpy(f).to(torch.bfloat16).permute(0, 3, 1, 2)
             for n, f in feats.items()}
    obj, deltas = head(tfeat)
    sum((obj[n] * torch.from_numpy(co[n][0])).sum()
        + (deltas[n] * torch.from_numpy(co[n][1])).sum()
        for n in LEVELS).backward()
    convs = (head.rpn_conv, head.objectness, head.anchor_deltas)
    got = [t.grad for m in convs for t in (m.weight, m.bias)]

    # each level on its own with bf16 leaves, the gradients summed in f32
    want = [torch.zeros_like(g) for g in got]
    for n in LEVELS:
        leaves = [t.detach().to(torch.bfloat16).requires_grad_()
                  for m in convs for t in (m.weight, m.bias)]
        h = F.relu(F.conv2d(tfeat[n], leaves[0], leaves[1], padding=1))
        o = F.conv2d(h, leaves[2], leaves[3]).permute(0, 2, 3, 1).float()
        d = F.conv2d(h, leaves[4], leaves[5]).permute(0, 2, 3, 1).float()
        loss = ((o * torch.from_numpy(co[n][0])).sum()
                + (d * torch.from_numpy(co[n][1])).sum())
        for w, g in zip(want, torch.autograd.grad(loss, leaves)):
            w += g.float()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))

    jhead = JaxRPNHead(num_anchors=a, channels=c, dtype=jnp.bfloat16)
    params = {"params": {
        name: {"kernel": jnp.asarray(m.weight.detach().permute(2, 3, 1, 0)
                                     .numpy()),
               "bias": jnp.asarray(m.bias.detach().numpy())}
        for name, m in zip(("rpn_conv", "objectness", "anchor_deltas"),
                           convs)}}
    jfeat = {n: jnp.asarray(f, jnp.bfloat16) for n, f in feats.items()}

    def loss_fn(p):
        jo, jd = jhead.apply(p, jfeat)
        return sum((jo[n] * co[n][0]).sum() + (jd[n] * co[n][1]).sum()
                   for n in LEVELS)

    rel = lambda g, w: np.linalg.norm(g - w) / np.linalg.norm(w)
    jg = jax.grad(loss_fn)(params)["params"]
    for i, name in enumerate(("rpn_conv", "objectness", "anchor_deltas")):
        w = np.asarray(jg[name]["kernel"], np.float32)
        assert rel(got[2 * i].permute(2, 3, 1, 0).numpy(), w) <= 3e-2, name
    for i, name in ((1, "objectness"), (2, "anchor_deltas")):
        exact = sum(torch.from_numpy(co[n][i - 1]).to(torch.bfloat16)
                    .double().sum(dim=(0, 1, 2)) for n in LEVELS)
        assert rel(got[2 * i + 1].double().numpy(), exact.numpy()) <= 4e-3, \
            name


def test_committed_golden_is_current():
    """The committed train golden's batch, draws and step-0 losses equal
    what the JAX package gives now (chip_smoke.py holds the GPU to it)."""
    with np.load(GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    model, params, cfg, batch, counts = jax_setup(golden=True)
    for k in ("image", "boxes", "classes", "valid", "masks_packed"):
        np.testing.assert_array_equal(g[k], batch[k])
    rng, step_rng = jax.random.split(jax.random.key(7))
    draws = jax_sampler_draws(step_rng, cfg.model, *counts, N_IMAGES)
    for k, v in draws.items():
        np.testing.assert_array_equal(g[f"step0_{k}"], v)
    total, losses, _ = jax_loss_and_grads(model, params, batch, step_rng,
                                          grads=False)
    np.testing.assert_allclose(g["step0_losses"],
                               [losses[k] for k in LOSS_KEYS] + [total],
                               rtol=1e-5)


def test_port_reproduces_golden_on_cpu(tmp_path):
    """What chip_smoke.py checks on the GPU, here on the CPU through
    ``chip_smoke.check_train_golden``: every step's losses within 1e-4 of
    the golden and the step-1 gradient norms within 1e-3."""
    import chip_smoke

    rec = chip_smoke.check_train_golden(torch.device("cpu"), str(tmp_path),
                                        loss_rtol=1e-4, norm_rtol=1e-3)
    assert rec["steps"] == GOLDEN_STEPS


if __name__ == "__main__":
    print(write_golden())
