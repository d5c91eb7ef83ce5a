"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device (marker ``cuda``) and skip without one.  The
file imports no JAX, so on a machine with a card and no JAX it runs without
the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from uwcv_tpu_torch.ops.nms import (
    NMS_MAX_N,
    nms_greedy,
    nms_greedy_reference,
)
from uwcv_tpu_torch.ops.roi_align import (
    level_canvas,
    level_strides,
    roi_align_windows,
    roi_align_windows_backward,
    roi_align_windows_backward_reference,
    roi_align_windows_reference,
    window_geometry,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _clustered(g, problems, n):
    ctr = torch.rand(problems, n, 2, generator=g) * 800
    size = torch.rand(problems, n, 2, generator=g) * 120 + 4
    return torch.cat([ctr - size / 2, ctr + size / 2], -1)


@pytest.mark.parametrize("problems,n,thr", [(40, 1000, 0.7), (8, 1024, 0.5),
                                            (10, 2000, 0.7), (3, 4096, 0.7),
                                            (2, 1, 0.5)])
def test_nms_kernel_keep_masks_identical(dev, problems, n, thr):
    g = torch.Generator().manual_seed(n)
    boxes = _clustered(g, problems, n).to(dev)
    valid = (torch.rand(problems, n, generator=g) < 0.9).to(dev)
    torch.testing.assert_close(nms_greedy(boxes, valid, thr),
                               nms_greedy_reference(boxes, valid, thr),
                               rtol=0, atol=0)


@pytest.mark.parametrize("thr", [0.0, 1.0])
@pytest.mark.parametrize("n", [1, 65, 1000, 1024, 4096, 8192])
def test_nms_kernel_edge_cases(dev, n, thr):
    """Word and block edges of the bit matrix, thresholds 0 and 1, N copies
    of one box, and an all-invalid problem."""
    g = torch.Generator().manual_seed(n + 1)
    boxes = _clustered(g, 3, n)
    boxes[1] = boxes[1, :1]
    valid = torch.rand(3, n, generator=g) < 0.9
    valid[1] = True
    valid[2] = False
    boxes, valid = boxes.to(dev), valid.to(dev)
    got = nms_greedy(boxes, valid, thr)
    torch.testing.assert_close(got, nms_greedy_reference(boxes, valid, thr),
                               rtol=0, atol=0)
    assert not got[2].any()


def test_nms_kernel_rejects_too_many_boxes(dev):
    boxes = torch.zeros(1, NMS_MAX_N + 1, 4, device=dev)
    with pytest.raises(ValueError):
        nms_greedy(boxes, torch.ones(1, NMS_MAX_N + 1, dtype=torch.bool,
                                     device=dev), 0.5)


def _pool_args(dev, dtype, c, p, r):
    g = torch.Generator().manual_seed(c + p)
    feats = {f"p{l}": torch.randn(2, 128 >> (l - 2), 160 >> (l - 2), c,
                                  generator=g).to(dev, dtype)
             for l in range(2, 6)}
    canvas, shapes = level_canvas(feats, 32)
    ctr = torch.rand(r, 2, generator=g) * 600
    wh = torch.rand(r, 2, generator=g) * 300 + 4
    rois = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    if r > 1:
        rois[0] = torch.tensor([10.0, 200.0, 630.0, 230.0])   # image-wide bar
        rois[1] = 0.0                                          # invalid slot
    li, y0, x0, wy, wx = window_geometry(
        rois.to(dev), shapes, level_strides({f"p{l}": 2 ** l
                                             for l in range(2, 6)}),
        p, 224.0, 4, 2, 32)
    slab = (li + 5 * (torch.arange(r, device=dev) % 2)).to(torch.int32)
    return canvas, slab, y0.to(torch.int32), x0.to(torch.int32), wy, wx


@pytest.mark.parametrize("r", [0, 1, 8000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,p", [(64, 7), (64, 14), (256, 7), (256, 14)])
def test_roi_align_kernel_matches_plain(dev, dtype, c, p, r):
    """f32: max error <= 1e-4·max|ref|; bf16: <= 2e-2·max|ref| (the
    contraction order differs, and ``rows`` is rounded to bf16)."""
    args = _pool_args(dev, dtype, c, p, r)
    got = roi_align_windows(*args).float()
    want = roi_align_windows_reference(*args).float()
    assert got.shape == (r, p, p, c)
    if r:
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        assert (got - want).abs().max() <= tol * want.abs().max()


def _bwd_args(dev, dtype, c, p, r):
    """(g, slab, y0, x0, wy, wx, canvas shape) for the backward."""
    args = _pool_args(dev, dtype, c, p, r)
    g = torch.randn(r, p, p, c, generator=torch.Generator().manual_seed(r)
                    ).to(dev, dtype)
    return (g,) + args[1:] + (tuple(args[0].shape),)


@pytest.mark.parametrize("r", [0, 1, 64, 2000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,p", [(64, 7), (256, 7), (256, 14), (12, 14)])
def test_roi_align_backward_kernel_matches_plain(dev, dtype, c, p, r):
    """The backward kernel against its plain version in f32 on the same
    values with the weights rounded as the kernel rounds them
    (``chip_smoke.check_bwd_result``): f32 max error <= 1e-5·max|ref|
    (another order of f32 sums), bf16 within one rounding elementwise,
    |got − ref| <= 2⁻⁷·|ref| + 1e-5·max|ref|; C = 12, not a multiple of
    a 16-byte chunk, included; R = 0 gives zeros."""
    from chip_smoke import check_bwd_result

    g, *geo, shape = _bwd_args(dev, dtype, c, p, r)
    got = roi_align_windows_backward(g, *geo, shape)
    assert got.shape == shape and got.dtype == dtype
    if r:
        err, top, ok = check_bwd_result(got, g, tuple(geo), shape)
        assert ok, (err, top)
    else:
        assert not got.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,p,r", [(256, 7, 64), (256, 14, 64),
                                   (64, 7, 2000), (12, 14, 64)])
def test_roi_align_backward_kernel_repeats_bit_identical(dev, dtype, c, p, r):
    """Each cell sums its rois in roi order: two calls on the same inputs
    give the same bits (the atomics of an earlier design did not)."""
    g, *geo, shape = _bwd_args(dev, dtype, c, p, r)
    a = roi_align_windows_backward(g, *geo, shape)
    b = roi_align_windows_backward(g, *geo, shape)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [256, 12])
def test_roi_align_backward_writes_every_cell(dev, dtype, c):
    """The output comes from ``torch.empty``: with the caching allocator's
    block filled with NaN just before the call, no NaN comes back (padding
    cells, cells no roi reaches and tail channels are written too)."""
    g, *geo, shape = _bwd_args(dev, dtype, c, 7, 64)
    poison = torch.full(shape, float("nan"), dtype=dtype, device=dev)
    at = poison.data_ptr()
    del poison
    got = roi_align_windows_backward(g, *geo, shape)
    assert got.data_ptr() == at
    assert not torch.isnan(got).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_kernel_past_the_tile_bitmap(dev, dtype):
    """A canvas of more than 65,536 8×8 tiles (70 slabs of 256²), past the
    kernel's shared-memory tile bitmap: every tile is summed as an item,
    and the result still holds against the plain version."""
    from chip_smoke import check_bwd_result

    gen = torch.Generator().manual_seed(5)
    s, h, w, c, p, r, win = 70, 256, 256, 8, 7, 200, 32
    shape = (s, h, w, c)
    wy = torch.rand(r, p, win, generator=gen)
    wx = torch.rand(r, p, win, generator=gen)
    wy[:, :, 20:] = 0.0
    geo = (torch.randint(0, s, (r,), generator=gen, dtype=torch.int32),
           torch.randint(0, h - win + 1, (r,), generator=gen,
                         dtype=torch.int32),
           torch.randint(0, w - win + 1, (r,), generator=gen,
                         dtype=torch.int32), wy, wx)
    g = torch.randn(r, p, p, c, generator=gen).to(dtype)
    geo = tuple(t.to(dev) for t in geo)
    g = g.to(dev)
    got = roi_align_windows_backward(g, *geo, shape)
    err, top, ok = check_bwd_result(got, g, geo, shape)
    assert ok, (err, top)


def test_roi_align_backward_counts_launches_and_rejects_bad_input(dev):
    args = _pool_args(dev, torch.bfloat16, 64, 7, 8)
    shape = tuple(args[0].shape)
    g = torch.ones(8, 7, 7, 64, dtype=torch.bfloat16, device=dev)
    before = roi_align_windows_backward.launches
    roi_align_windows_backward(g, *args[1:], shape)
    assert roi_align_windows_backward.launches == before + 1
    with pytest.raises(ValueError):
        roi_align_windows_backward(g.half(), *args[1:], shape)
    with pytest.raises(ValueError):
        roi_align_windows_backward(g[:, :5, :5], *args[1:], shape)
    with pytest.raises(ValueError):
        roi_align_windows_backward(g, args[1].long(), *args[2:], shape)


def test_training_steps_on_card_launch_every_kernel(dev, tmp_path):
    """Two Trainer steps of a small bf16 model on the card: RoIAlign and its
    backward twice a step, NMS once, finite losses."""
    import numpy as np

    from chip_smoke import seeded_flax_params
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.trainer import Trainer, step_generator
    from uwcv_tpu_torch.ops.nms import nms_greedy

    cfg = Config()
    m = cfg.model
    m.depth, m.fpn_channels, m.box_fc_dim = 26, 64, 64
    cfg.input.train_size = (128, 128)
    cfg.output_dir = str(tmp_path)
    tr = Trainer(cfg, device=dev)
    tr.load_params(seeded_flax_params(cfg.model, 0))
    rng = np.random.default_rng(0)
    boxes = np.zeros((2, 8, 4), np.float32)
    boxes[:, :3] = [[10, 10, 60, 50], [70, 20, 120, 90], [5, 80, 40, 125]]
    masks = np.zeros((2, 8, 128, 128), bool)
    for i, (x1, y1, x2, y2) in enumerate(boxes[0, :3].astype(int)):
        masks[:, i, y1:y2, x1:x2] = True
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (2, 128, 128, 3),
                                                    dtype=np.uint8)),
             "boxes": torch.from_numpy(boxes),
             "classes": torch.zeros(2, 8, dtype=torch.int32),
             "valid": torch.from_numpy((boxes[..., 2] > 0)),
             "masks_packed": torch.from_numpy(np.packbits(masks, axis=-1))}
    batch = {k: v.to(dev) for k, v in batch.items()}
    counts = (roi_align_windows.launches, roi_align_windows_backward.launches,
              nms_greedy.launches)
    for step in range(2):
        metrics = tr.train_step(batch, step_generator(0, step, dev))
        assert all(torch.isfinite(v) for v in metrics.values())
    assert (roi_align_windows.launches - counts[0],
            roi_align_windows_backward.launches - counts[1],
            nms_greedy.launches - counts[2]) == (4, 4, 2)


def test_roi_align_kernel_rejects_unaligned_channels(dev):
    args = _pool_args(dev, torch.bfloat16, 64, 7, 4)
    canvas = torch.zeros(args[0].shape[:-1] + (12,), dtype=torch.bfloat16,
                         device=dev)
    with pytest.raises(ValueError):
        roi_align_windows(canvas, *args[1:])


def test_chip_smoke_against_compares_two_packages(dev):
    """``chip_smoke.py --against DIR``'s comparison, with this checkout on
    both sides: each side's wrappers run in their own process on the same
    saved inputs, their outputs agree, and each wrapper gets four turns."""
    import chip_smoke

    roi = {p: _pool_args(dev, torch.bfloat16, 64, p, 200) for p in (7, 14)}
    bwd = {f"P={p}": _bwd_args(dev, torch.bfloat16, 64, p, 64)
           for p in (7, 14)}
    g = torch.Generator().manual_seed(3)
    valid = torch.ones(4, 300, dtype=torch.bool, device=dev)
    nms = [(_clustered(g, 4, 300).to(dev), valid, 0.7)]
    got = chip_smoke.compare_against(chip_smoke.REPO, roi, nms, bwd)
    assert sorted(got) == ["nms_greedy (both calls)",
                           "roi_align_windows P=14", "roi_align_windows P=7",
                           "roi_align_windows_backward P=14",
                           "roi_align_windows_backward P=7"]
    for rec in got.values():
        assert len(rec["turns_ms"]) == 4
        assert all(t > 0 for t in rec["turns_ms"])


@pytest.mark.parametrize("chunk", [1, 10, 17])
def test_paste_select_pack_on_card_matches_unfused(dev, chunk):
    """The fused mask tail on the card, bit for bit against the unfused
    chain on the card (f32 paste)."""
    from uwcv_tpu_torch.data.augment import pack_bitmasks
    from uwcv_tpu_torch.ops.mask_paste import paste_masks, paste_select_pack
    from uwcv_tpu_torch.ops.morphology import remove_overlaps

    g = torch.Generator().manual_seed(chunk)
    b, d, h, w = 2, 50, 416, 512
    probs = torch.rand(b, d, 28, 28, generator=g).to(dev)
    ctr = torch.rand(b, d, 2, generator=g) * torch.tensor([w, h])
    wh = torch.rand(b, d, 2, generator=g) * 150 + 4
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1).to(dev)
    keep = (torch.rand(b, d, generator=g) > 0.2).to(dev)
    scores = torch.rand(b, d, generator=g).to(dev)
    extent = torch.zeros(b, h, w, dtype=torch.bool, device=dev)
    extent[:, :400, :500] = True
    got_p, got_k = paste_select_pack(probs, boxes, keep, scores, (h, w),
                                     min_pixels=2, chunk=chunk,
                                     extent=extent)
    masks = paste_masks(probs, boxes, (h, w)) & extent[:, None]
    order = torch.sort(-torch.where(keep, scores, torch.full_like(
        scores, -float("inf"))), dim=-1, stable=True).indices
    masks = remove_overlaps(masks, order)
    want_k = keep & (masks.sum(dim=(2, 3)) >= 2)
    torch.testing.assert_close(got_k, want_k, rtol=0, atol=0)
    torch.testing.assert_close(got_p, pack_bitmasks(masks & want_k[..., None,
                                                                   None]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("overlaps", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [50, 100])
def test_paste_claim_pack_kernel_matches_chain(dev, d, dtype, overlaps):
    """The mask-tail kernels against the plain chain on the card, bit for
    bit, at the benchmark cell's shapes (B 8, 832×1024) with D 50 and
    Detectron2's 100; each call adds one to the op's launch count."""
    from chip_smoke import mask_tail_inputs
    from uwcv_tpu_torch.ops.mask_paste import (
        paste_claim_pack,
        paste_claim_pack_reference,
    )

    g = torch.Generator().manual_seed(d)
    b, h, w = 8, 832, 1024
    masks, boxes, keep, scores, out_sizes = (
        t.to(dev) for t in mask_tail_inputs(g, b, d, h, w))
    paste_dtype = getattr(torch, dtype)
    before = paste_claim_pack.launches
    got_p, got_k = paste_claim_pack(masks, boxes, keep, scores, out_sizes,
                                    (h, w), min_pixels=2,
                                    do_remove_overlaps=overlaps,
                                    dtype=paste_dtype)
    torch.cuda.synchronize()
    assert paste_claim_pack.launches == before + 1
    want_p, want_k = paste_claim_pack_reference(
        masks, boxes, keep, scores, out_sizes, h, w, 2, overlaps,
        paste_dtype)
    torch.testing.assert_close(got_k, want_k, rtol=0, atol=0)
    torch.testing.assert_close(got_p, want_p, rtol=0, atol=0)
    assert not got_k[1].any() and got_k.sum() > b
    # boxes in bfloat16, as a bf16 model's detections may be, and min 0
    boxes16 = boxes.to(torch.bfloat16)
    got = paste_claim_pack(masks, boxes16, keep, scores, out_sizes, (h, w),
                           min_pixels=0, do_remove_overlaps=overlaps,
                           dtype=paste_dtype)
    want = paste_claim_pack_reference(masks, boxes16, keep, scores,
                                      out_sizes, h, w, 0, overlaps,
                                      paste_dtype)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=0, atol=0)


def test_exported_program_calls_the_mask_tail_kernel(dev, tmp_path):
    """``export_predictor`` → ``load_exported`` on the card: the program
    calls ``uwcv::paste_claim_pack``, and its packed masks equal
    ``Predictor._run``'s on the same staged batch."""
    import numpy as np

    from chip_smoke import seeded_flax_params
    from uwcv_tpu_torch.engine.export import export_predictor, load_exported
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.ops.mask_paste import paste_claim_pack

    cfg = _small_cfg()
    cfg.model.roi_score_thresh_test = 0.0
    live = Predictor(cfg, seeded_flax_params(cfg.model, 0), device=dev)
    path = export_predictor(live, str(tmp_path / "p.pt2"), batch_size=4)
    graph = str(torch.export.load(path).graph)
    assert "paste_claim_pack" in graph
    run, _, _ = load_exported(path, dev)
    rng = np.random.default_rng(4)
    images = [np.repeat(rng.integers(0, 256, (128, 128, 1), dtype=np.uint8),
                        3, axis=-1) for _ in range(4)]
    ops, _ = live.stage_batch(images)
    want = live._run(*ops)
    before = paste_claim_pack.launches
    got = run(*ops)
    torch.cuda.synchronize()
    assert paste_claim_pack.launches == before + 1
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert want[2].any() and want[1].any()


def test_start_pull_copies_into_pinned_memory(dev):
    """The folder pipeline's device → host copy: pinned host buffers and an
    event of their own, the same Instances as the synchronous pull."""
    import numpy as np

    from chip_smoke import seeded_flax_params
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.predictor import Predictor

    cfg = Config()
    m = cfg.model
    m.depth, m.fpn_channels, m.box_fc_dim, m.dtype = 26, 32, 32, "float32"
    m.detections_per_image, m.roi_score_thresh_test = 10, 0.0
    cfg.input.test_short_edge = cfg.input.test_max_size = 96
    cfg.input.pad_size_test = (128, 128)
    pred = Predictor(cfg, seeded_flax_params(cfg.model, 0), device=dev)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (120, 100, 3), dtype=np.uint8)
              for _ in range(2)]
    out = pred.predict_batch_device(images, block=False)
    pulled = pred.start_pull(out)
    assert pulled.masks.is_pinned() and pulled.ready is not None
    for a, b in zip(pred.to_instances(pulled), pred.to_instances(out)):
        np.testing.assert_array_equal(a.masks, b.masks)
        np.testing.assert_array_equal(a.boxes, b.boxes)


def _small_cfg():
    from uwcv_tpu_torch.config import Config

    cfg = Config()
    m = cfg.model
    m.depth, m.fpn_channels, m.box_fc_dim = 26, 64, 64
    m.rpn_pre_nms_topk_train, m.rpn_post_nms_topk_train = 200, 100
    m.rpn_pre_nms_topk_test, m.rpn_post_nms_topk_test = 100, 50
    m.detections_per_image = 10
    cfg.input.train_size = (128, 128)
    cfg.input.test_short_edge = cfg.input.test_max_size = 128
    cfg.input.pad_size_test = (128, 128)
    return cfg


def test_pth_import_and_set_params_on_card(dev, tmp_path):
    """A Detectron2-named ``.pth`` onto a bf16 predictor on the card: every
    leaf holds the checkpoint's value rounded to bf16; ``set_params`` of
    the same params into another predictor keeps its module, dtype and
    device and gives bit-equal outputs."""
    import numpy as np

    from chip_smoke import detectron2_state_dict, seeded_flax_params
    from uwcv_tpu_torch.engine.predictor import Predictor, load_predictor
    from uwcv_tpu_torch.weights import params_to_flax

    cfg = _small_cfg()
    ckpt, want = detectron2_state_dict(seeded_flax_params(cfg.model, 0),
                                       np.random.default_rng(0))
    path = str(tmp_path / "model.pth")
    torch.save(ckpt, path)
    pred = load_predictor(cfg, path, device=dev)
    got = params_to_flax(pred.model)
    bf16 = lambda a: torch.from_numpy(a).bfloat16().float().numpy()
    assert all(np.array_equal(got[k], bf16(want[k])) for k in want)
    other = Predictor(cfg, None, device=dev)
    model = other.model
    other.set_params(want)
    assert other.model is model
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert {p.device.type for p in model.parameters()} == {"cuda"}
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (120, 100, 3), dtype=np.uint8)
              for _ in range(2)]
    for a, b in zip(pred.predict_batch(images), other.predict_batch(images)):
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.masks, b.masks)


def test_one_trial_hpo_on_card_launches_every_kernel(dev, tmp_path):
    """``run_reference_hpo``, one trial of 3 steps at small width on the
    card: complete, segm mAP objective, and the launch counts of the
    formula (RoIAlign 2 a step + 2 an eval batch, its backward 2 a step,
    NMS 1 a step + 2 an eval batch)."""
    from uwcv_tpu_torch.data.catalog import DatasetCatalog
    from uwcv_tpu_torch.data.synthetic import generate_dataset
    from uwcv_tpu_torch.hpo.study import run_reference_hpo
    from uwcv_tpu_torch.ops.nms import nms_greedy

    paths = generate_dataset(str(tmp_path / "data"), num_train=2,
                             num_test=2, num_inference=0,
                             image_size=(128, 128), seed=1)
    cfg = _small_cfg()
    cfg.output_dir = str(tmp_path / "out")
    cfg.data.classes_csv = paths["classes_csv"]
    cfg.data.train_dataset = "_cuda_hpo_train"
    cfg.data.test_dataset = "_cuda_hpo_test"
    fns = (roi_align_windows, roi_align_windows_backward, nms_greedy)
    before = [f.launches for f in fns]
    try:
        res = run_reference_hpo(cfg, n_trials=1, max_iter=3,
                                data_dir=paths["Train"], device=dev)
    finally:
        DatasetCatalog.remove("_cuda_hpo_train")
        DatasetCatalog.remove("_cuda_hpo_test")
    assert res["trials"][0]["state"] == "COMPLETE", res
    assert res["objective"] == "segm_mAP"
    assert 0.0 <= res["best_value"] <= 1.0
    assert [f.launches - b for f, b in zip(fns, before)] == [
        2 * 3 + 2, 2 * 3, 3 + 2]


@pytest.fixture
def second_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 1)


def test_kernels_run_on_the_second_card(second_card):
    """With cuda:0 the thread's current device, each wrapper launches on
    the card its tensors lie on (cuda:1) and agrees with its plain version
    there: a launch on the current device would read cuda:1 memory through
    cuda:0's stream."""
    from chip_smoke import check_bwd_result

    dev = second_card
    with torch.cuda.device(0):
        args = _pool_args(dev, torch.float32, 64, 7, 64)
        got = roi_align_windows(*args)
        want = roi_align_windows_reference(*args)
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
        g, *geo, shape = _bwd_args(dev, torch.float32, 64, 7, 64)
        got = roi_align_windows_backward(g, *geo, shape)
        err, top, ok = check_bwd_result(got, g, tuple(geo), shape)
        assert ok, (err, top)
        gen = torch.Generator().manual_seed(2)
        boxes = _clustered(gen, 8, 1000).to(dev)
        valid = (torch.rand(8, 1000, generator=gen) < 0.9).to(dev)
        torch.testing.assert_close(nms_greedy(boxes, valid, 0.7),
                                   nms_greedy_reference(boxes, valid, 0.7),
                                   rtol=0, atol=0)
    torch.cuda.synchronize(dev)


def test_hpo_trials_run_one_a_card(second_card, tmp_path):
    """``run_reference_hpo`` over every card, one trial on each, from the
    thread pool: every trial completes, and each card's eval predictor is
    its own."""
    from uwcv_tpu_torch.data.catalog import DatasetCatalog
    from uwcv_tpu_torch.data.synthetic import generate_dataset
    from uwcv_tpu_torch.hpo.study import run_reference_hpo

    n = torch.cuda.device_count()
    paths = generate_dataset(str(tmp_path / "data"), num_train=2,
                             num_test=2, num_inference=0,
                             image_size=(128, 128), seed=1)
    cfg = _small_cfg()
    cfg.output_dir = str(tmp_path / "out")
    cfg.data.classes_csv = paths["classes_csv"]
    cfg.data.train_dataset = "_cuda_hpo_cards_train"
    cfg.data.test_dataset = "_cuda_hpo_cards_test"
    try:
        res = run_reference_hpo(cfg, n_trials=n, max_iter=3, n_parallel=n,
                                data_dir=paths["Train"], device="cuda")
    finally:
        DatasetCatalog.remove("_cuda_hpo_cards_train")
        DatasetCatalog.remove("_cuda_hpo_cards_test")
    assert [t["state"] for t in res["trials"]] == ["COMPLETE"] * n, res
    assert res["objective"] == "segm_mAP"
    assert res["eval_predictors"] == n


def test_hpo_trials_over_groups_of_two_cards(second_card, tmp_path):
    """``run_reference_hpo`` over groups of two cards (``cards // 2``
    groups), one trial a group, each trial in two spawned NCCL ranks:
    every trial completes with its group's masters bit-identical, and the
    launches follow the formula: per rank B1 2, B1-bwd 2 and B2 1 a step;
    on the driver B1 2 and B2 2 an eval batch."""
    from uwcv_tpu_torch.data.catalog import DatasetCatalog
    from uwcv_tpu_torch.data.synthetic import generate_dataset
    from uwcv_tpu_torch.hpo.study import run_reference_hpo
    from uwcv_tpu_torch.ops.nms import nms_greedy

    g = torch.cuda.device_count() // 2
    paths = generate_dataset(str(tmp_path / "data"), num_train=2,
                             num_test=2, num_inference=0,
                             image_size=(128, 128), seed=1)
    cfg = _small_cfg()
    cfg.output_dir = str(tmp_path / "out")
    cfg.data.classes_csv = paths["classes_csv"]
    cfg.data.train_dataset = "_cuda_hpo_groups_train"
    cfg.data.test_dataset = "_cuda_hpo_groups_test"
    fns = (roi_align_windows, roi_align_windows_backward, nms_greedy)
    before = [f.launches for f in fns]
    try:
        res = run_reference_hpo(cfg, n_trials=g, max_iter=3, n_parallel=g,
                                data_dir=paths["Train"],
                                devices=[f"cuda:{i}" for i in range(2 * g)])
    finally:
        DatasetCatalog.remove("_cuda_hpo_groups_train")
        DatasetCatalog.remove("_cuda_hpo_groups_test")
    assert [t["state"] for t in res["trials"]] == ["COMPLETE"] * g, res
    assert res["objective"] == "segm_mAP"
    assert [f.launches - b for f, b in zip(fns, before)] == [2 * g, 0, 2 * g]
    devices = set()
    for t in res["trials"]:
        reps = t["user_attrs"]["rank_reports"]
        assert t["user_attrs"]["ranks"] == len(reps) == 2
        assert len({r["masters_sha256"] for r in reps}) == 1
        assert all(r["launches"] == {"roi_align_windows": 6,
                                     "roi_align_windows_backward": 6,
                                     "nms_greedy": 3} for r in reps)
        devices |= {r["device"] for r in reps}
    assert devices == {f"cuda:{i}" for i in range(2 * g)}


def test_exported_program_on_card_matches_live_and_launches_kernels(
        dev, tmp_path):
    """Export → save → load → run on the card at small width (bf16): the
    served outputs equal the live predictor's on a full and a partial
    batch, and the loaded program launches both kernels (twice a batch
    each), counted by their wrappers."""
    import numpy as np

    from chip_smoke import seeded_flax_params
    from uwcv_tpu_torch.engine.export import export_predictor
    from uwcv_tpu_torch.engine.predictor import Predictor

    cfg = _small_cfg()
    cfg.model.roi_score_thresh_test = 0.0
    live = Predictor(cfg, seeded_flax_params(cfg.model, 0), device=dev)
    path = export_predictor(live, str(tmp_path / "p.pt2"), batch_size=4)
    served = Predictor.from_exported(cfg, path, device=dev)
    assert served.model is None and served.exported_batch == 4
    rng = np.random.default_rng(2)
    images = [np.repeat(rng.integers(0, 256, (128, 128, 1), dtype=np.uint8),
                        3, axis=-1) for _ in range(4)]
    want = live.predict_batch(images)
    before = (roi_align_windows.launches, nms_greedy.launches)
    got = served.predict_batch(images) + served.predict_batch(images[:3])
    torch.cuda.synchronize()
    assert (roi_align_windows.launches - before[0],
            nms_greedy.launches - before[1]) == (4, 4)
    for a, b in zip(want + want[:3], got):
        np.testing.assert_array_equal(b.valid, a.valid)
        np.testing.assert_array_equal(b.classes, a.classes)
        np.testing.assert_array_equal(b.masks, a.masks)
        np.testing.assert_allclose(b.boxes, a.boxes, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(b.scores, a.scores, rtol=1e-5, atol=1e-5)
    assert sum(int(a.valid.sum()) for a in want) > 0


def test_data_parallel_training_and_mesh_predict_over_cards(second_card):
    """``chip_smoke.py``'s data-parallel phases over every card: two gloo
    ranks on cuda:0 and two NCCL ranks on cuda:0 and cuda:1 hold the JAX
    global-batch train golden, one NCCL rank per card trains the full-width
    model (masters bit-identical, every kernel on every rank), and the
    full-width predictor over a mesh of every card equals the single-device
    one on each card's slice and pads a folder's chunks to the mesh."""
    import chip_smoke
    from uwcv_tpu_torch import kernels

    kernels.build()
    n = torch.cuda.device_count()
    dp = chip_smoke.run_data_parallel(n)
    assert set(dp["golden"]) == {"gloo, 2 ranks on cuda:0",
                                 "nccl, cuda:0 + cuda:1"}
    (runs,) = dp["train"].values()
    assert [r["device"] for r in runs] == [f"cuda:{i}" for i in range(n)]
    assert runs[0]["train"]["global_batch"] == 2 * n
    rec = chip_smoke.run_mesh_predict([f"cuda:{i}" for i in range(n)])
    assert rec["launches"]["roi_align_windows"] > 0


def test_spatial_trunk_on_card_matches_the_plain_trunk(dev):
    """The model axis in one process on the card (``DeviceRow`` of
    ``[cuda:0, cuda:0]``): ResNet-26 + FPN-64 on two row shards of 2 × 320
    × 256 images (an uneven split) equals the plain trunk within 1e-5 of
    each level's largest value in f32 with TF32 off, p2–p5 channels-last,
    and the halo-exchanged 3×3 conv's input and weight gradients equal
    the unsharded conv's within 1e-4 of their largest."""
    from chip_smoke import seeded_flax_params
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.models.rcnn import MaskRCNN
    from uwcv_tpu_torch.parallel import mesh, spatial
    from uwcv_tpu_torch.weights import params_from_flax

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = Config()
        m = cfg.model
        m.depth, m.fpn_channels, m.box_fc_dim, m.dtype = 26, 64, 64, \
            "float32"
        model = MaskRCNN(m)
        model.load_state_dict(params_from_flax(seeded_flax_params(m, 0)),
                              strict=True)
        model = model.to(dev).eval().requires_grad_(False)
        g = torch.Generator().manual_seed(0)
        images = (torch.rand(2, 320, 256, 3, generator=g) * 255).to(dev)
        axis = spatial.DeviceRow([dev, dev])
        got = model.features(images, axis)
        want = model.features(images)
        for k in want:
            # p6 is a strided view of p5 in the plain trunk
            assert k == "p6" or got[k].is_contiguous(
                memory_format=torch.channels_last)
            torch.testing.assert_close(
                got[k], want[k], rtol=1e-5,
                atol=1e-5 * float(want[k].abs().max()))
        conv = torch.nn.Conv2d(16, 16, 3, padding=1).to(dev)
        x = torch.randn(2, 16, 320, 64, generator=g).to(dev)
        x.requires_grad_(True)
        gy = torch.randn(2, 16, 320, 64, generator=g).to(dev)
        (conv(x) * gy).sum().backward()
        want_dx, want_dw = x.grad.clone(), conv.weight.grad.clone()
        x.grad, conv.weight.grad = None, None
        rows = mesh.height_shards(320, 2)
        y = spatial.spatial_conv2d(
            spatial.Shards([x[:, :, a:b] for a, b in rows]), conv, axis)
        (spatial.gather_rows(y, axis, spatial.level_heights(rows, 1))
         * gy).sum().backward()
        for got_g, want_g in ((x.grad, want_dx), (conv.weight.grad, want_dw)):
            torch.testing.assert_close(got_g, want_g, rtol=1e-4,
                                       atol=1e-4 * float(want_g.abs().max()))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def test_model_axis_training_and_predict_over_cards(second_card):
    """``chip_smoke.py``'s model-axis phases over every card: the train
    golden over (1, 2) as two gloo ranks on cuda:0 and two NCCL ranks on
    cuda:0 and cuda:1, the full-width training side over (cards // 2, 2)
    with one NCCL rank a card (masters bit-identical, every kernel on
    every rank), and the predictor over (1, 2) and over (1, cards)."""
    import chip_smoke
    from uwcv_tpu_torch import kernels

    kernels.build()
    n = torch.cuda.device_count()
    sp = chip_smoke.run_model_axis(n, {"train": {}})
    assert set(sp["golden"]) == {"gloo, (1, 2) on cuda:0",
                                 "nccl, (1, 2) over cuda:0 + cuda:1"}
    (runs,) = sp["train"].values()
    assert [r["device"] for r in runs] == [f"cuda:{i}"
                                           for i in range(n // 2 * 2)]
    assert runs[0]["train"]["mesh_shape"] == [n // 2, 2]
    rec = chip_smoke.run_sp_predict([f"cuda:{i}" for i in range(n)])
    assert rec["launches"]["roi_align_windows"] == 6
    assert f"giant (1, {n})" in rec
