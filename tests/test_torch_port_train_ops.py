"""The port's training ops against the JAX package's, on the CPU in f32.

The same numpy inputs go through the JAX function and its port.  Random
draws are the JAX package's own (``jax.random`` from the same keys, derived
here as the JAX code derives them) handed to the port, so the matcher,
the sampler and the augmentation must agree exactly; the torch generator's
draws get a distribution test of their own.  The RoIAlign gradient is held
against JAX's vjp of the Pallas pooler in interpret mode, as
``tests/test_pallas_kernels.py`` holds the JAX package's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_harness import hang_report, hang_report_module  # noqa: F401
from uwcv_tpu.config import Config as JaxConfig
from uwcv_tpu.config import SolverConfig as JaxSolverConfig
from uwcv_tpu.data import augment as j_aug
from uwcv_tpu.engine.lr_schedule import warmup_multistep as j_schedule
from uwcv_tpu.models.anchors import generate_anchors as j_anchors
from uwcv_tpu.models.rpn import generate_proposals as j_generate_proposals
from uwcv_tpu.ops import matcher as j_matcher
from uwcv_tpu.ops.mask_paste import crop_and_resize_masks as j_crop
from uwcv_tpu.ops.roi_align import multilevel_roi_align_batched as j_pool
from uwcv_tpu.structures.boxes import encode_deltas as j_encode
from uwcv_tpu_torch.config import Config, SolverConfig
from uwcv_tpu_torch.data.augment import (
    augment_draws,
    augment_sample,
    unpack_bitmasks,
)
from uwcv_tpu_torch.engine.lr_schedule import warmup_multistep
from uwcv_tpu_torch.models.anchors import generate_anchors
from uwcv_tpu_torch.models.rpn import LEVELS, generate_proposals
from uwcv_tpu_torch.ops.mask_paste import crop_and_resize_masks
from uwcv_tpu_torch.ops.matcher import (
    match_boxes,
    sampler_uniforms,
    subsample_labels,
)
from uwcv_tpu_torch.ops.roi_align import (
    multilevel_roi_align_batched,
    roi_align_windows,
    roi_align_windows_backward,
    roi_align_windows_backward_reference,
)
from uwcv_tpu_torch.structures.boxes import encode_deltas

T = torch.from_numpy


def _boxes(rng, n, size=256.0, lo=4.0, hi=120.0):
    ctr = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)


def _match_case(seed):
    """Anchors and two images' padded gt: a padded row, a duplicated gt,
    a gt far from every anchor (IoU 0), and anchors that equal a gt
    exactly (ties for the low-quality rule)."""
    rng = np.random.default_rng(seed)
    anchors = _boxes(rng, 400)
    gt = np.stack([_boxes(rng, 7) for _ in range(2)])
    valid = np.ones((2, 7), bool)
    valid[0, 6] = valid[1, 5:] = False
    gt[0, 3] = gt[0, 2]                                      # duplicate gt
    gt[1, 4] = [1000.0, 1000.0, 1010.0, 1012.0]              # no overlap
    anchors[10] = anchors[11] = gt[0, 0]                     # exact ties
    anchors[12] = gt[1, 1]
    return anchors, gt, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thr,low_quality", [((0.7, 0.3), True),
                                             ((0.5, 0.5), False)])
def test_matcher_matches_jax_exactly(seed, thr, low_quality):
    anchors, gt, valid = _match_case(seed)
    got = match_boxes(T(anchors), T(gt), T(valid), *thr,
                      allow_low_quality=low_quality)
    for b in range(2):
        want = j_matcher.match_boxes(jnp.asarray(anchors), jnp.asarray(gt[b]),
                                     jnp.asarray(valid[b]), *thr,
                                     allow_low_quality=low_quality)
        np.testing.assert_array_equal(got.labels[b].numpy(),
                                      np.asarray(want.labels))
        np.testing.assert_array_equal(got.matched_idx[b].numpy(),
                                      np.asarray(want.matched_idx))
    assert (got.labels == 1).any() and (got.labels == 0).any()


def _jax_uniforms(key, n, weighted):
    """The two uniforms ``subsample_labels`` draws from ``key``
    (matcher.py:102-117)."""
    k_pos, k_neg = jax.random.split(key)
    u_pos = (jax.random.uniform(k_pos, (n,), minval=1e-20, maxval=1.0)
             if weighted else jax.random.uniform(k_pos, (n,)))
    return np.asarray(u_pos), np.asarray(jax.random.uniform(k_neg, (n,)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n_fg,n_bg", [(3, 500), (200, 500), (150, 20),
                                       (0, 40)])
def test_subsample_labels_matches_jax_exactly(weighted, n_fg, n_bg):
    """Few positives (negatives fill), more than the positive cap, too few
    negatives (the tail repeats the first pick), no positives; with and
    without fg weights (zero weights exclude)."""
    rng = np.random.default_rng(n_fg + n_bg)
    n = 700
    labels = np.full((n,), -1, np.int32)
    perm = rng.permutation(n)
    labels[perm[:n_fg]] = 1
    labels[perm[n_fg:n_fg + n_bg]] = 0
    weights = (rng.choice([0.0, 1.0, 4.0], n).astype(np.float32)
               if weighted else None)
    key = jax.random.key(n_fg * 7 + n_bg)
    want_idx, want_pos = j_matcher.subsample_labels(
        jnp.asarray(labels), 256, 0.25, key,
        fg_weights=None if weights is None else jnp.asarray(weights))
    u_pos, u_neg = _jax_uniforms(key, n, weighted)
    got_idx, got_pos = subsample_labels(
        T(labels).long(), 256, 0.25, T(u_pos), T(u_neg),
        fg_weights=None if weights is None else T(weights))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))


def test_subsample_labels_batched_equals_per_row():
    """A leading batch of label rows samples each row as alone."""
    rng = np.random.default_rng(3)
    labels = T(rng.integers(-1, 2, (3, 300))).long()
    u_pos, u_neg = sampler_uniforms((3, 300), True,
                                    torch.Generator().manual_seed(0))
    w = T(rng.uniform(0, 3, (3, 300)).astype(np.float32))
    idx, pos = subsample_labels(labels, 64, 0.5, u_pos, u_neg, w)
    for b in range(3):
        i, p = subsample_labels(labels[b], 64, 0.5, u_pos[b], u_neg[b], w[b])
        assert torch.equal(i, idx[b]) and torch.equal(p, pos[b])


def test_sampler_uniforms_floor_the_weighted_draw():
    g = torch.Generator().manual_seed(1)
    u_pos, u_neg = sampler_uniforms((5000,), True, g)
    assert u_pos.min() >= 1e-20 and u_pos.max() < 1 and u_neg.min() >= 0


def test_encode_deltas_matches_jax():
    rng = np.random.default_rng(4)
    src, tgt = _boxes(rng, 300), _boxes(rng, 300)
    src[:3, 2:] = src[:3, :2]                      # degenerate sources
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        want = np.asarray(j_encode(jnp.asarray(src), jnp.asarray(tgt), w))
        got = encode_deltas(T(src), T(tgt), w).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_crop_and_resize_masks_matches_jax():
    """Rel 1e-5; boxes past the mask border and sub-pixel boxes included;
    the ``index`` form equals gathering the masks first."""
    rng = np.random.default_rng(5)
    masks = rng.random((6, 40, 52)) < 0.4
    boxes = _boxes(rng, 6, size=52.0, lo=0.5, hi=60.0)
    boxes[0] = [-10.0, -5.0, 70.0, 50.0]
    want = np.asarray(j_crop(jnp.asarray(masks), jnp.asarray(boxes), 28))
    got = crop_and_resize_masks(T(masks), T(boxes), 28).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    idx = torch.tensor([5, 0, 0, 3])
    np.testing.assert_array_equal(
        crop_and_resize_masks(T(masks), T(boxes[[5, 0, 0, 3]]), 28,
                              index=idx).numpy(),
        crop_and_resize_masks(T(masks[[5, 0, 0, 3]]),
                              T(boxes[[5, 0, 0, 3]]), 28).numpy())


@pytest.mark.parametrize("kw", [{}, {"steps": (5, 12), "warmup_iters": 10,
                                     "gamma": 0.3},
                                {"warmup_iters": 0, "base_lr": 0.02}])
def test_lr_schedule_matches_jax(kw):
    want, got = j_schedule(JaxSolverConfig(**kw)), warmup_multistep(
        SolverConfig(**kw))
    for step in range(0, 130, 3):
        assert got(step) == float(want(jnp.int32(step))), step


def _jax_aug_draws(key, cfg):
    """The values ``augment_sample`` draws from ``key``
    (augment.py:121-145), as the port's draw dict."""
    kb, kc, ks, kl, kf, kr = jax.random.split(key, 6)
    u = lambda k, lo, hi: float(jax.random.uniform(k, (), minval=lo,
                                                   maxval=hi))
    return {
        "brightness": torch.tensor([u(kb, *cfg.brightness_range)]),
        "contrast": torch.tensor([u(kc, *cfg.contrast_range)]),
        "saturation": torch.tensor([u(ks, *cfg.saturation_range)]),
        "do_rot": torch.tensor([bool(jax.random.uniform(kr, ())
                                     < cfg.rotation_prob)]),
        "lighting": torch.from_numpy(np.asarray(jax.random.normal(
            kl, (3,))))[None],
        "do_flip": torch.tensor([bool(jax.random.uniform(kf, ())
                                      < cfg.vflip_prob)]),
    }


def test_augment_sample_matches_jax_given_its_draws():
    """Over keys that cover every rot/flip combination: boxes and masks
    exact, pixels within 1e-4 of the 0..255 range (the contrast mean and
    the lighting product sum in another order)."""
    cfg = JaxConfig().input
    tcfg = Config().input
    rng = np.random.default_rng(6)
    s = 48
    sample = {"image": (rng.random((s, s, 3)) * 255).astype(np.float32),
              "boxes": _boxes(rng, 5, size=s, hi=20.0),
              "masks": rng.random((5, s, s)) < 0.3,
              "classes": np.arange(5, dtype=np.int32),
              "valid": np.ones(5, bool)}
    seen = set()
    for k in range(40):
        key = jax.random.key(k)
        draws = _jax_aug_draws(key, cfg)
        combo = (bool(draws["do_rot"]), bool(draws["do_flip"]))
        if combo in seen:
            continue
        seen.add(combo)
        want = j_aug.augment_sample({kk: jnp.asarray(v)
                                     for kk, v in sample.items()}, key, cfg)
        got = augment_sample({kk: T(v) for kk, v in sample.items()}, tcfg,
                             draws=draws)
        np.testing.assert_array_equal(got["boxes"].numpy(),
                                      np.asarray(want["boxes"]))
        np.testing.assert_array_equal(got["masks"].numpy(),
                                      np.asarray(want["masks"]))
        np.testing.assert_allclose(got["image"].numpy(),
                                   np.asarray(want["image"]), rtol=0,
                                   atol=1e-4 * 255)
        np.testing.assert_array_equal(got["classes"].numpy(),
                                      sample["classes"])
    assert len(seen) == 4


def test_augment_draws_distribution():
    """The torch draws: rotation and flip rates within 4.5 binomial
    standard deviations of ``rotation_prob`` / ``vflip_prob``, blend
    weights inside their ranges and spread over them, lighting normals
    with mean ≈ 0 and std ≈ 1."""
    cfg = Config().input
    n = 20000
    d = augment_draws(n, cfg, torch.Generator().manual_seed(0))
    for key, p in (("do_rot", cfg.rotation_prob), ("do_flip", cfg.vflip_prob)):
        rate = d[key].float().mean().item()
        assert abs(rate - p) <= 4.5 * np.sqrt(p * (1 - p) / n), (key, rate)
    for key, (lo, hi) in (("brightness", cfg.brightness_range),
                          ("contrast", cfg.contrast_range),
                          ("saturation", cfg.saturation_range)):
        w = d[key]
        assert w.min() >= lo and w.max() <= hi
        assert abs(w.mean().item() - (lo + hi) / 2) < 0.02 * (hi - lo)
    light = d["lighting"]
    assert light.shape == (n, 3)
    assert light.mean().abs().item() < 0.03
    assert abs(light.std().item() - 1.0) < 0.03


def test_unpack_bitmasks_matches_jax():
    rng = np.random.default_rng(7)
    masks = rng.random((3, 4, 21)) < 0.5
    packed = np.packbits(masks, axis=-1)
    want = np.asarray(j_aug.unpack_bitmasks(jnp.asarray(packed), 21))
    got = unpack_bitmasks(T(packed), 21).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, masks)


def test_train_proposals_match_jax_and_carry_no_gradient():
    """``generate_proposals(training=True)``: the train top-k, no level
    floor, the same boxes and scores as JAX's; logits that require grad
    give proposals that do not."""
    cfg, jcfg = Config().model, JaxConfig().model
    for c in (cfg, jcfg):
        c.rpn_pre_nms_topk_train, c.rpn_post_nms_topk_train = 300, 200
        c.rpn_post_nms_level_floor = 50
    h, w = 128, 160
    anchors = {n: a for n, a in zip(LEVELS, j_anchors(
        (h, w), jcfg.anchor_stride_levels, jcfg.anchor_sizes,
        jcfg.anchor_aspect_ratios))}
    rng = np.random.default_rng(8)
    obj, deltas = {}, {}
    for lvl, s in zip(LEVELS, (4, 8, 16, 32, 64)):
        hh, ww = -(-h // s), -(-w // s)
        obj[lvl] = rng.normal(0, 2, (2, hh, ww, 3)).astype(np.float32)
        deltas[lvl] = rng.normal(0, 0.2, (2, hh, ww, 12)).astype(np.float32)
    want = j_generate_proposals(
        {k: jnp.asarray(v) for k, v in obj.items()},
        {k: jnp.asarray(v) for k, v in deltas.items()},
        {k: jnp.asarray(v) for k, v in anchors.items()}, (h, w), jcfg,
        training=True)
    t_anchors = {n: T(a) for n, a in zip(LEVELS, generate_anchors(
        (h, w), cfg.anchor_stride_levels, cfg.anchor_sizes,
        cfg.anchor_aspect_ratios))}
    got = generate_proposals(
        {k: T(v).requires_grad_() for k, v in obj.items()},
        {k: T(v).requires_grad_() for k, v in deltas.items()}, t_anchors,
        (h, w), cfg, training=True)
    assert got.boxes.shape == (2, 200, 4)
    assert not got.boxes.requires_grad and not got.scores.requires_grad
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-3)


def _pool_case(c=4):
    rng = np.random.default_rng(11)
    b = 2
    feats = {f"p{l}": rng.normal(0, 1, (b, 64 >> (l - 2), 80 >> (l - 2), c)
                                 ).astype(np.float32) for l in range(2, 6)}
    ctr = rng.uniform(40, 200, (b, 6, 2))
    wh = rng.uniform(16, 120, (b, 6, 2))
    rois = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    rois[1, 0] = [0.0, 100.0, 320.0, 112.0]            # image-wide bar
    cot = rng.normal(0, 1, (b, 6, 7, 7, c)).astype(np.float32)
    return feats, rois, cot


def test_roi_align_gradient_matches_jax_vjp():
    """d(Σ pooled·cotangent)/d(levels) through ``PoolWindows`` (the plain
    backward on the CPU) and ``level_canvas`` against JAX's gradient of
    the Pallas pooler in interpret mode (its custom_vjp backward): rtol
    1e-4, atol 1e-5."""
    feats, rois, cot = _pool_case()
    strides = {f"p{l}": 2 ** l for l in range(2, 6)}

    def loss(f):
        out = j_pool(f, jnp.asarray(rois), strides, 7, interpret=True)
        return (out * jnp.asarray(cot)).sum()

    v_j, g_j = jax.value_and_grad(loss)({k: jnp.asarray(v)
                                         for k, v in feats.items()})
    tf = {k: T(v).requires_grad_() for k, v in feats.items()}
    out = multilevel_roi_align_batched(tf, T(rois), strides, 7)
    v_t = (out * T(cot)).sum()
    v_t.backward()
    np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-5)
    for lvl in feats:
        np.testing.assert_allclose(tf[lvl].grad.numpy(),
                                   np.asarray(g_j[lvl]), rtol=1e-4, atol=1e-5)


def test_roi_align_backward_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version and counts no
    launch; R = 0 gives a zero canvas."""
    from uwcv_tpu_torch.ops.roi_align import (
        level_canvas,
        level_strides,
        window_geometry,
    )

    feats, rois, _ = _pool_case(8)
    canvas, shapes = level_canvas({k: T(v) for k, v in feats.items()}, 32)
    li, y0, x0, wy, wx = window_geometry(
        T(rois).reshape(-1, 4), shapes,
        level_strides({f"p{l}": 2 ** l for l in range(2, 6)}), 14, 224.0, 4,
        2, 32)
    slab = (torch.arange(2).repeat_interleave(6) * 5 + li).to(torch.int32)
    geo = (slab, y0.to(torch.int32), x0.to(torch.int32), wy, wx)
    g = torch.randn(12, 14, 14, 8, generator=torch.Generator().manual_seed(0))
    before = roi_align_windows_backward.launches
    got = roi_align_windows_backward(g, *geo, tuple(canvas.shape))
    torch.testing.assert_close(got, roi_align_windows_backward_reference(
        g, *geo, tuple(canvas.shape)), rtol=1e-6, atol=1e-6)
    zero = roi_align_windows_backward(g[:0], *(t[:0] for t in geo),
                                      tuple(canvas.shape))
    assert zero.shape == canvas.shape and not zero.any()
    assert roi_align_windows_backward.launches == before
    # the adjoint identity <pool(x), g> = <x, pool_bwd(g)>
    lhs = (roi_align_windows(canvas, *geo) * g).sum()
    rhs = (canvas * got).sum()
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-5)
