#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``uwcv_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--against DIR]

Phases (any failure raises and exits non-zero):

1. build the CUDA kernels from ``uwcv_tpu_torch/csrc/`` (one ``nvcc`` per
   source, started together);
2. hold each kernel against its plain PyTorch version at the main path's
   shapes (RoIAlign: f32 at max rel err <= 1e-4, bf16 at max abs err <=
   2e-2·max|ref|; NMS: identical keep masks), edge cases included; time
   both with CUDA events (``cuda_ms``), split a call's device time by
   kernel with ``torch.profiler`` (``device_split``), and time RoIAlign
   once more with its rois in (slab, y0, x0) order; the RoIAlign backward
   at the training shapes (canvas [10, 200, 200, 256], R = 64, P = 7 and
   14) against its plain version in f32 with the weights rounded as the
   kernel rounds them (f32 at max err <= 1e-5·max|ref|, bf16 within one
   rounding elementwise), each call into a NaN-filled allocator block and
   repeated bit-identically (rois at the border, 64 copies of one roi,
   R = 0, and a timed R = 2·512) and NMS at the training RPN's 10 × 2000;
   the mask tail's op ``paste_claim_pack`` (``csrc/mask_tail.cu``) at the
   resident-predict cell's shapes (B 8, D 50, 832×1024) bit-identical to
   its plain chain, f32 and bf16 paste, with and without overlap removal,
   the f32 case with overlap removal timed beside the chain and its byte
   bound; the trunk's conv epilogue ``frozen_bn_act``
   (``csrc/frozen_bn.cu``) on the 49 calls of an R50 forward at that
   cell's shapes, bit-identical to the chain, timed beside it and its byte
   bound, and at R101's res4 shapes of the training cell; every later
   phase's launch counts hold that kernel too (``epilogues``: 49 an R50
   forward, 100 an R101 one, 10 a training step at ``freeze_at`` 2, once
   a part on a model axis), and the folder and export phases' recordings
   show no epilogue on the chain;
3. gate golden: the committed R26/FPN-64 gate checkpoint through
   ``Predictor.predict_batch`` in f32 (TF32 off) against the JAX package's
   outputs committed in ``tests/data/torch_port_gate_golden.npz``;
4. full width: R50-FPN-256 at the default config in bf16 with seeded
   weights, a batch of 8 grayscale 1024×1280 images, 2 warm-up and 5 timed
   batches; the kernels' launch counts are zeroed just before and read just
   after, and must show RoIAlign, NMS and the mask tail on the path;
5. folder: the same model through ``run_batch_inference`` over 16 seeded
   1024×1280 16-bit TIFFs (written here), batch 8, measurements on;
   RoIAlign and NMS twice a batch and the mask tail once (counts zeroed
   just before), every RLE row decodes to its instance's mask; img/s and
   the host-stage split;
6. folder golden: the gate checkpoint in f32 over the committed gate PNGs
   (``tests/data/gate_split``) through ``run_batch_inference`` against the
   JAX package's committed CSVs (ImageIds equal, row mask IoU ≥ 0.99,
   descriptor medians within 1%);
7. eval: ``evaluate_split`` over that split, segm and bbox AP within 0.005
   of the JAX package's committed values and segm AP ≥ 0.8 × the
   checkpoint's recorded one;
8. train golden: the gate checkpoint in f32 (TF32 off), 3 SGD steps
   through ``Trainer.train_step`` on two gate images with augmentation off
   and the sampler draws of ``tests/data/torch_port_train_golden.npz``;
   each step's losses and the step-1 gradient norms within 1e-3 relative
   of the JAX package's values committed there;
9. train full width: ``Trainer.fit`` at the default config (R50-FPN-256,
   bf16 compute, f32 masters, 800×800, batch 2) from seeded weights over
   the 12 gate-split images staged on the device, 2 warm-up + 20 timed
   steps at the default log period, then 20 more logging every step (a
   host wait per step); launch counts zeroed just before and read just
   after (RoIAlign and its backward twice a step, NMS once); finite logged
   losses and weights; ``model_final.npz`` loads into ``Predictor``;
   ms/step, img/s, a CUDA-event split (forward / backward / optimizer),
   peak memory, the device's idle share and the device time of the ops on
   the pooler's canvas;
10. pth import: R101-FPN-256 (the reference's architecture) at the
   default config in bf16; seeded weights written as a Detectron2-named
   ``.pth`` (``detectron2_state_dict``: FPN, RPN and heads, BN with running
   stats, ``fc1`` over CHW) and read by ``load_predictor``; every leaf of
   the R101 tree must hold the checkpoint's value rounded to bf16 (the
   count is printed against the tree's, a missed leaf is named); the
   imported params written to an ``.npz`` and read by ``load_predictor``
   give outputs bit-identical to the ``.pth`` predictor's on a batch of 8
   gray 1024×1280 images; both kernels twice a batch and the mask tail once
   (counts zeroed just before);
11. hpo: ``synth`` writes 8 train and 4 test images at 1024×1280, then
   ``run_reference_hpo`` at the default config (R50-FPN-256, bf16 compute,
   f32 masters, 800×800, batch 2), 3 trials of 20 steps (the CLI's default
   is 100), space v1; every trial COMPLETE with a finite segm AP in [0, 1];
   launch counts zeroed just before equal the sums over the trials
   (RoIAlign 2 a step + 2 an eval batch, its backward 2 a step, NMS 1 a
   step + 2 an eval batch); seconds per trial, training ms/step, eval
   seconds, eval predictors built, peak memory; ``save_gt_visualizations``
   over 2 train images, whose PNGs decode to the images' shape;
12. export: the full-width phase's model (R50-FPN-256 bf16, seeded)
   through ``export_predictor`` at batch 8 on the canvas the live
   predictor stages 1024×1280 gray images to (832×1024), then loaded by
   ``Predictor.from_exported`` in a child process in which ``MaskRCNN``
   cannot be built (``--serve-artifact``); its batch of 8 and partial
   batch of 5 (padded to 8, held against the live batch of 8's first 5)
   equal the live predictor's (valid, classes and packed masks
   equal; boxes within rtol 1e-5 / atol 1e-4, scores rtol 1e-5 / atol
   1e-5); launch counts zeroed in the child just before its batches show
   both kernels twice a batch and the mask tail once from inside the
   loaded program; export
   seconds, artifact MB, load and first-call seconds, the exported and
   the live predictor's img/s; then the ``export`` verb at batch 4 (the
   staged canvas as the pad canvas) and ``serve --artifact ... --once``
   over 4 16-bit TIFFs write the JSONs of a live ``serve --once`` at the
   same batch and canvas;
13. dp golden: the train golden of phase 8 data-parallel: two gloo ranks
   on ``cuda:0`` (NCCL refuses two ranks on one card) and, with two or
   more cards, two NCCL ranks on ``cuda:0`` and ``cuda:1``, each rank on
   one of the golden's two images with its rows of the sampler draws, in
   f32 (TF32 off); each step's all-reduced losses and the step-0 norms of
   the gradients summed over the ranks within 1e-3 relative of the JAX
   package's global-batch values, the masters bit-identical across ranks
   (``run_ranks``: spawned ranks, a ``file://`` rendezvous, a timeout);
14. dp train: ``Trainer.fit`` at the default config (R50-FPN-256, bf16
   compute, f32 masters, 800×800) over the 12 gate images staged on each
   rank's card, each rank on its share of the global batch
   (``TrainLoader(process_index, process_count)``): on one card two gloo
   ranks sharing ``cuda:0`` at global batch 2, 2 + 8 steps (a correctness
   run, not a rate); with two or more cards one NCCL rank per card at
   global batch 2 × cards, 2 + 20 steps, and ``nvidia-smi topo -m``'s
   rows of the cards; finite global losses, bit-identical masters, per
   rank B1 2, B1-bwd 2 and B2 1 a step (counts zeroed just before);
   ms/step, img/s and the gradient all-reduce's share of a step (CUDA
   events); a phase skipped for want of a second card says so;
15. mesh predict: the full-width model over a mesh of ``[cuda:0,
   cuda:0]`` (one card) or of every card: a batch of 8 equal to the
   single-device predictor on each device's slice, then
   ``run_batch_inference`` over 16 16-bit TIFFs at batch 5, each chunk
   padded to the mesh; B1 and B2 2 a batch and the mask tail 1 on each
   device;
16. sp golden: the train golden of phase 8 over a (1, 2) mesh (the
   model axis): two gloo ranks on ``cuda:0`` and, with two or more cards,
   two NCCL ranks on ``cuda:0`` and ``cuda:1``; each rank runs the trunk on
   its rows of both images (halo rows exchanged, the FPN levels gathered)
   and the heads on the whole levels; losses and step-0 global gradient
   norms within 1e-3 relative of JAX's, masters bit-identical;
17. sp train: phase 14's full-width training side over (1, 2) with two
   gloo ranks sharing ``cuda:0`` (2 images, 2 + 8 steps: a check, not a
   rate), or over (cards // 2, 2) with one NCCL rank a card (2 images a
   data row, 2 + 20 steps); ms/step, the halo and gather spans a step
   (CUDA events), peak memory a rank beside phase 14's; launches and
   masters as phase 14;
18. sp predict: the full-width model in f32 (TF32 off) over a (1, 2)
   mesh ``[cuda:0, cuda:0]`` against the one-device predictor on 4 gray
   1024×1280 images at the gate golden's limits (valid and classes equal,
   boxes ≤ 1e-2 px, scores ≤ 1e-4, mask IoU ≥ 0.99); then one seeded
   4096×5120 micrograph at the default config (bf16, the test size raised
   to the image) over (1, 1) and, with two or more cards, (1, cards):
   batch ms and peak memory a card; B1 and B2 2 a batch, the mask tail 1;
19. hpo groups: ``run_reference_hpo`` over groups of two devices, each
   trial in two spawned ranks of a process group of its own, scored on
   the driver: one trial at the default config over ``[cuda:0, cuda:0]``
   (two gloo ranks), 10 steps, scored on the hpo phase's 4 test images;
   the CPU test's equality on the card (R26/FPN-64 in f32, TF32 off, 5
   steps without a Test split: two gloo ranks' global losses within 1e-3
   relative of one process's at the same global batch); with two or more
   cards, ``cards // 2`` groups of two NCCL ranks, two trials each, whose
   training intervals must overlap.  Every trial COMPLETE (segm AP in [0,
   1] where scored), each group's masters bit-identical across its ranks;
   launches summed over the ranks' reports and the driver's count, zeroed
   just before: B1 2, B1-bwd 2, B2 1 a step a rank, B1 2 and B2 2 an eval
   batch on the driver; seconds per trial (spawn, set-up, training, eval),
   ms/step and peak memory per rank and on the driver's cards;
20. only with ``--against DIR``: the kernel wrappers (``roi_align_windows``,
   ``roi_align_windows_backward``, ``nms_greedy``) of the
   ``uwcv_tpu_torch`` package under DIR, e.g. an
   earlier commit unpacked with ``git archive <commit> uwcv_tpu_torch``,
   against these on the timed inputs of phase 2: each side in its own
   process, in turns (DIR, this, this, DIR); their outputs must agree as
   in phase 2.

A rank that fails or hangs fails its phase; no rank falls back to the
CPU.  Scratch files go under ``build/chip_smoke/``.  Prints the card's
name and power limit, the folder and eval records, a ``{"kernels":
[...]}`` line, and as its last line ``{"ok": true, "device": {...}}``.
Needs one CUDA device; without one it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import copy
import csv
import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_gate_golden.npz")
GATE_CKPT = os.path.join(REPO, "assets", "gate", "gate_ckpt.npz")
GATE_META = os.path.join(REPO, "assets", "gate", "gate_meta.json")
GATE_SPLIT = os.path.join(REPO, "tests", "data", "gate_split")
WORK = os.path.join(REPO, "build", "chip_smoke")

# H100 SXM data-sheet peaks (dense), for the roofline bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, calls: int = 20, groups: int = 5, warmup: int = 3) -> float:
    """Time of one call of ``fn`` in ms: CUDA events around ``calls``
    back-to-back calls, the elapsed time over ``calls``, and the median of
    ``groups`` such groups.  The device queue stays full, so host time per
    call shows only where it outlasts the device work it enqueues."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def device_split(fn, calls: int = 10) -> dict:
    """Device time per call of ``fn`` by kernel name, in ms, from a
    ``torch.profiler`` trace of ``calls`` calls (names cut to 48 chars)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if us > 0:
            key = ev.key[:48]
            split[key] = split.get(key, 0.0) + us / calls / 1e3
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


def op_split_by_shape(fn, shapes, calls: int = 5) -> dict:
    """Device time per call of ``fn`` in the aten ops that take an input of
    one of ``shapes`` (each a list), by op name and input shapes, in ms
    (``torch.profiler`` with the shapes recorded; each op's own kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages(group_by_input_shape=True):
        us = ev.self_device_time_total
        if us > 0 and any(list(s) in shapes for s in ev.input_shapes):
            key = f"{ev.key} {ev.input_shapes}"
            split[key] = split.get(key, 0.0) + us / calls / 1e3
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


def bound(bytes_moved: float, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def write_tiff16(path: str, px: np.ndarray) -> None:
    """A [H, W] uint16 image as a one-strip uncompressed little-endian
    16-bit grayscale TIFF (the SEM micrographs' format)."""
    h, w = px.shape
    data = px.astype("<u2").tobytes()
    entries = [(256, 4, w), (257, 4, h), (258, 3, 16), (259, 3, 1),
               (262, 3, 1), (273, 4, 8), (277, 3, 1), (278, 4, h),
               (279, 4, len(data))]
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHII" if typ == 4 else "<HHIHxx", tag, typ, 1, val)
        for tag, typ, val in entries) + struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", 8 + len(data)) + data + ifd)


# ---------------------------------------------------------------- kernels

def _proposal_like_rois(rng, b, r, h, w):
    """Boxes the size mix of RPN proposals (log-uniform 8–600 px sides)
    inside an h×w canvas, plus one image-wide 20:1 scale bar per image."""
    side = np.exp(rng.uniform(np.log(8), np.log(600), (b, r, 2)))
    ctr = rng.uniform(0, 1, (b, r, 2)) * [w, h]
    boxes = np.concatenate([ctr - side / 2, ctr + side / 2], -1)
    boxes[..., 0::2] = boxes[..., 0::2].clip(0, w)
    boxes[..., 1::2] = boxes[..., 1::2].clip(0, h)
    boxes[:, 0] = [20.0, h / 2 - 25.0, w - 20.0, h / 2 + 25.0]   # ~20:1 bar
    return torch.from_numpy(boxes.astype(np.float32))


def check_roi_align(dev):
    """Each case against the plain version; the bf16 C=256 cases (the main
    path's) are timed.  → (the P=7 timed case, all cases, the timed cases'
    arguments by P)."""
    from uwcv_tpu_torch.ops.roi_align import (
        level_canvas,
        level_strides,
        roi_align_windows,
        roi_align_windows_reference,
        window_geometry,
    )

    rng = np.random.default_rng(1)
    b, h, w = 8, 832, 1024          # 1024×1280 inputs → 832×1024 canvas
    strides = {f"p{l}": 2 ** l for l in range(2, 6)}
    cases, timed, timed_args = [], None, {}
    for c in (256, 64):
        feats32 = {f"p{l}": torch.from_numpy(rng.standard_normal(
            (b, h >> l, w >> l, c), dtype=np.float32)).to(dev)
            for l in range(2, 6)}
        for dtype in (torch.bfloat16, torch.float32):
            canvas, shapes = level_canvas(
                {k: v.to(dtype) for k, v in feats32.items()}, 32)
            assert tuple(canvas.shape) == (5 * b, 208, 256, c), canvas.shape
            for p, r_per in ((7, 1000), (14, 50)):
                rois = _proposal_like_rois(rng, b, r_per, h, w).to(dev)
                li, y0, x0, wy, wx = window_geometry(
                    rois.reshape(-1, 4), shapes, level_strides(strides), p,
                    224.0, 4, 2, 32)
                slab = (torch.arange(b, device=dev).repeat_interleave(r_per)
                        * 5 + li).to(torch.int32)
                full = (canvas, slab, y0.to(torch.int32), x0.to(torch.int32),
                        wy, wx)
                # the batch, one roi (the 20:1 bar) and none
                for r in (b * r_per, 1, 0):
                    args = full[:1] + tuple(t[:r] for t in full[1:])
                    got = roi_align_windows(*args)
                    want = roi_align_windows_reference(*args)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item() if r else 0.0
                    ref = want.float().abs().max().item() if r else 0.0
                    ok = tuple(got.shape) == (r, p, p, c) and (
                        err <= 1e-4 * ref if dtype == torch.float32
                        else err <= 2e-2 * ref)
                    case = {"dtype": str(dtype).replace("torch.", ""),
                            "C": c, "P": p, "R": r, "max_abs_err": err,
                            "max_abs_ref": ref, "ok": ok,
                            "subwindow_GB": _subwindow_bytes(*args) / 1e9}
                    log(f"  roi_align_windows {case}")
                    if not ok:
                        raise RuntimeError(
                            f"roi_align_windows disagrees: {case}")
                    if c == 256 and dtype == torch.bfloat16 and r > 1:
                        case["ms"] = cuda_ms(lambda: roi_align_windows(*args))
                        case["plain_ms"] = cuda_ms(
                            lambda: roi_align_windows_reference(*args),
                            calls=5, groups=3)
                        case["bound_ms"], case["bound_by"] = _roi_bound(*args)
                        case["bound_whole_windows_ms"] = _roi_bound(
                            *args, whole_windows=True)[0]
                        # the same rois in (slab, y0, x0) order: blocks that
                        # run together then share windows in L2
                        key = ((args[1].long() * canvas.shape[1] + args[2])
                               * canvas.shape[2] + args[3])
                        order = torch.sort(key, stable=True).indices
                        by_place = args[:1] + tuple(t[order] for t in args[1:])
                        case["ms_rois_by_place"] = cuda_ms(
                            lambda: roi_align_windows(*by_place))
                        case["device_split_ms"] = device_split(
                            lambda: roi_align_windows(*args))
                        log(f"    kernel {case['ms']:.4f} ms (rois by place "
                            f"{case['ms_rois_by_place']:.4f} ms), plain "
                            f"{case['plain_ms']:.4f} ms, bound "
                            f"{case['bound_ms']:.4f} ms ({case['bound_by']}; "
                            f"whole windows "
                            f"{case['bound_whole_windows_ms']:.4f} ms); "
                            f"device split {case['device_split_ms']}")
                        timed_args[p] = args
                        if p == 7:
                            timed = case
                    cases.append(case)
    return timed, cases, timed_args


def _subwindow_bytes(canvas, slab, y0, x0, wy, wx) -> int:
    """Canvas bytes the kernel copies: each roi's nonzero wy × wx extent,
    all C channels."""
    from uwcv_tpu_torch.ops.roi_align import subwindow_extent

    _, nh = subwindow_extent(wy.to(canvas.dtype))
    _, nw = subwindow_extent(wx.to(canvas.dtype))
    return int((nh * nw).sum()) * canvas.shape[-1] * canvas.element_size()


def _roi_bound(canvas, slab, y0, x0, wy, wx, whole_windows=False):
    """Least time for one call: every canvas cell that some roi's
    sub-window (its nonzero wy × wx extent, the cells that reach the
    output) covers, read once; weights and origins read once; the pooled
    output written once.  Operations: the two contractions over the
    sub-windows.  ``whole_windows`` counts whole win × win windows instead."""
    from uwcv_tpu_torch.ops.roi_align import subwindow_extent

    r, p, win = wy.shape
    s, h, w, c = canvas.shape
    if whole_windows:
        hlo = wlo = torch.zeros_like(y0, dtype=torch.int64)
        nh = nw = torch.full_like(hlo, win)
    else:
        hlo, nh = subwindow_extent(wy.to(canvas.dtype))
        wlo, nw = subwindow_extent(wx.to(canvas.dtype))
    # coverage count of every cell: +1/-1 at each rectangle's corners, then
    # prefix sums (an empty rectangle's corners cancel)
    diff = torch.zeros((s, h + 1, w + 1), dtype=torch.int32,
                       device=slab.device)
    sl, ys, xs = slab.long(), y0.long() + hlo, x0.long() + wlo
    one = torch.ones_like(sl, dtype=torch.int32)
    for dy, dx, sign in ((0, 0, 1), (nh, 0, -1), (0, nw, -1), (nh, nw, 1)):
        diff.index_put_((sl, ys + dy, xs + dx), one * sign, accumulate=True)
    covered = int((diff.cumsum(1).cumsum(2) > 0).sum().item())
    elem = canvas.element_size()
    bytes_moved = (covered * c * elem + 2 * r * p * win * 4 + 3 * r * 4
                   + r * p * p * c * elem)
    flops = 2.0 * p * c * float((nh * nw).sum() + p * nw.sum())
    return bound(bytes_moved, flops, canvas.dtype)


def _nms_problems(rng, problems, n, h, w):
    """Score-sorted boxes clustered around a few objects each, so greedy
    suppression chains form; the last tenth are invalid padding."""
    ctr = rng.uniform(0, 1, (problems, 40, 2)) * [w, h]
    size = rng.uniform(16, 200, (problems, 40, 2))
    pick = rng.integers(0, 40, (problems, n))
    c = np.take_along_axis(ctr, pick[..., None], 1) + rng.normal(
        0, 6, (problems, n, 2))
    s = np.take_along_axis(size, pick[..., None], 1) * rng.uniform(
        0.8, 1.25, (problems, n, 2))
    boxes = np.concatenate([c - s / 2, c + s / 2], -1).astype(np.float32)
    valid = np.ones((problems, n), bool)
    valid[:, n - n // 10:] = False
    return torch.from_numpy(boxes), torch.from_numpy(valid)


def _nms_edge_cases(rng):
    """Three problems for each N and threshold: clustered boxes, N copies
    of one box, and an all-invalid problem."""
    for n in (1, 65, 1000, 1024, 4096, 8192):
        boxes, valid = _nms_problems(rng, 3, n, 832, 1024)
        boxes[1] = boxes[1, :1]
        valid[1] = True
        valid[2] = False
        for thr in (0.0, 0.7, 1.0):
            yield boxes, valid, thr


def check_nms(dev):
    """The main path's two calls and the edge cases against the plain
    version (identical keep masks); the main path's calls are timed.
    → (record, the timed calls' arguments)."""
    from uwcv_tpu_torch.ops.nms import nms_greedy, nms_greedy_reference

    rng = np.random.default_rng(2)
    # one batch of 8: the RPN's 8×5 per-level problems (N = pre_nms_topk
    # 1000) at 0.7 and the 8 class-offset detection problems (N = 1024) at 0.5
    launches = []
    for problems, n, thr in ((40, 1000, 0.7), (8, 1024, 0.5)):
        boxes, valid = _nms_problems(rng, problems, n, 832, 1024)
        launches.append((boxes.to(dev), valid.to(dev), thr))
    kept_pairs, mismatches, n_kept, max_err = 0, 0, 0, 0.0
    for boxes, valid, thr in launches:
        got = nms_greedy(boxes, valid, thr)
        want = nms_greedy_reference(boxes, valid, thr)
        mismatches += int((got != want).sum().item())
        max_err = max(max_err, (got.float() - want.float()).abs().max().item())
        n_kept += int(want.sum().item())
        # IoU evaluations the greedy walk needs: each kept i against the
        # valid j > i
        n_valid = valid.sum(1, keepdim=True)
        idx = torch.arange(boxes.shape[1], device=dev)[None]
        kept_pairs += int(((n_valid - idx - 1).clamp_min(0) * want).sum())
    log(f"  nms_greedy: {mismatches} keep-mask mismatches, {n_kept} kept")
    if mismatches:
        raise RuntimeError(f"nms_greedy disagrees in {mismatches} entries")
    edge = 0
    for boxes, valid, thr in _nms_edge_cases(rng):
        boxes, valid = boxes.to(dev), valid.to(dev)
        got = nms_greedy(boxes, valid, thr)
        want = nms_greedy_reference(boxes, valid, thr)
        bad = int((got != want).sum().item())
        edge += 1
        if bad:
            raise RuntimeError(f"nms_greedy disagrees in {bad} entries at "
                               f"N={boxes.shape[1]}, threshold {thr}")
    log(f"  nms_greedy: {edge} edge cases (N 1..8192, thresholds 0/0.7/1, "
        f"identical boxes, all-invalid) identical")

    tb, tv = _rpn_train_problems(rng)
    tb, tv = tb.to(dev), tv.to(dev)
    got, want = nms_greedy(tb, tv, 0.7), nms_greedy_reference(tb, tv, 0.7)
    bad = int((got != want).sum().item())
    if bad:
        raise RuntimeError(f"nms_greedy disagrees in {bad} entries at the "
                           f"training shape (10 × 2000)")
    train = {"problems": [10, 2000, 0.7], "kept": int(want.sum().item()),
             "ms": cuda_ms(lambda: nms_greedy(tb, tv, 0.7)),
             "plain_ms": cuda_ms(lambda: nms_greedy_reference(tb, tv, 0.7),
                                 calls=3, groups=3, warmup=1)}
    log(f"  nms_greedy: training shape 10 × 2000 identical, "
        f"{train['kept']} kept; {train['ms']:.4f} ms, plain "
        f"{train['plain_ms']:.4f} ms")

    run = lambda f: [f(bx, v, t) for bx, v, t in launches]
    ms = cuda_ms(lambda: run(nms_greedy))
    plain_ms = cuda_ms(lambda: run(nms_greedy_reference), calls=3, groups=3,
                       warmup=1)
    n_boxes = sum(bx.shape[0] * bx.shape[1] for bx, _, _ in launches)
    # 16 B box + 1 B valid read, 1 B keep written; ~13 f32 ops per IoU test
    b_ms, b_by = bound(n_boxes * 18, kept_pairs * 13.0, torch.float32)
    split = device_split(lambda: run(nms_greedy))
    log(f"    both calls {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.6f} ms ({b_by}); the greedy walk's sequential dependency "
        f"is not in this bound; device split {split}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": max_err,
            "device_split_ms": split, "train": train,
            "problems": [[bx.shape[0], bx.shape[1], t] for bx, _, t in launches]
            }, launches


def mask_tail_inputs(g, b, d, h, w, m=28):
    """Inputs of ``paste_claim_pack`` from a ``torch.Generator``: cleaned
    head masks (blobs with specks, so the masks have edges inside), boxes
    of 0.3–300 px over and beyond the canvas, one wholly off it and one
    under a pixel, scores with ties, a second image with no kept
    detection, extents smaller than the canvas but the third image's."""
    yy, xx = torch.meshgrid(torch.arange(m), torch.arange(m), indexing="ij")
    c = torch.rand(b, d, 2, generator=g) * m
    r = torch.rand(b, d, generator=g) * m / 2 + 2
    masks = ((yy - c[..., :1, None]) ** 2 + (xx - c[..., 1:, None]) ** 2
             < r[..., None, None] ** 2)
    masks ^= torch.rand(b, d, m, m, generator=g) < 0.05
    ctr = (torch.rand(b, d, 2, generator=g) * torch.tensor([w + 40, h + 40])
           - 20)
    wh = torch.rand(b, d, 2, generator=g) * 300 + 0.3
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    boxes[0, 0] = torch.tensor([-90.0, -60.0, -8.0, -2.0])
    boxes[0, 1] = torch.tensor([40.2, 30.7, 40.6, 31.1])
    keep = torch.rand(b, d, generator=g) > 0.2
    keep[min(1, b - 1)] = False
    scores = (torch.rand(b, d, generator=g) * 8).floor() / 8
    out_sizes = torch.stack([torch.randint(h // 2, h + 1, (b,), generator=g),
                             torch.randint(w // 2, w + 1, (b,), generator=g)],
                            -1).int()
    out_sizes[min(2, b - 1)] = torch.tensor([h, w])
    return masks, boxes, keep, scores, out_sizes


def check_mask_tail(dev) -> dict:
    """``paste_claim_pack`` at the resident-predict cell's shapes (B 8,
    D 50, 832×1024, min 2 pixels) against its plain chain on the card,
    bit for bit, for f32 and bf16 paste with and without overlap removal;
    the main path's case (f32, overlap removal) timed beside the chain,
    split by kernel, and held against its byte bound."""
    from uwcv_tpu_torch.ops.mask_paste import (
        paste_claim_pack,
        paste_claim_pack_reference,
    )

    b, d, h, w, m = 8, 50, 832, 1024, 28
    g = torch.Generator().manual_seed(7)
    masks, boxes, keep, scores, out_sizes = (
        t.to(dev) for t in mask_tail_inputs(g, b, d, h, w, m))
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for overlaps in (True, False):
            args = (masks, boxes, keep, scores, out_sizes)
            got = paste_claim_pack(*args, (h, w), min_pixels=2,
                                   do_remove_overlaps=overlaps, dtype=dtype)
            want = paste_claim_pack_reference(*args, h, w, 2, overlaps,
                                              dtype)
            torch.cuda.synchronize()
            bits = int((got[0] != want[0]).sum().item())
            keeps = int((got[1] != want[1]).sum().item())
            cases.append({"dtype": str(dtype).split(".")[-1],
                          "remove_overlaps": overlaps, "bytes_differing": bits,
                          "keep_differing": keeps,
                          "kept": int(want[1].sum().item())})
            if bits or keeps:
                raise RuntimeError(f"paste_claim_pack differs from its chain: "
                                   f"{cases[-1]}")
    log(f"  paste_claim_pack: {len(cases)} cases bit-identical to the chain "
        f"at B {b}, D {d}, {h}×{w}: {cases}")
    run = lambda: paste_claim_pack(masks, boxes, keep, scores, out_sizes,
                                   (h, w), min_pixels=2)
    plain = lambda: paste_claim_pack_reference(
        masks, boxes, keep, scores, out_sizes, h, w, 2, True, torch.float32)
    ms = cuda_ms(run)
    plain_ms = cuda_ms(plain, calls=3, groups=3, warmup=1)
    # least bytes: the packed output written, masks, boxes, keep and
    # scores read once; the design adds the int16 owner map, written and
    # read back inside the boxes
    least = b * d * (h * w // 8 + m * m + 16 + 1 + 4) + b * 8
    owner = 2 * b * h * w
    b_ms, b_by = bound(least, 0.0, torch.float32)
    split = device_split(run)
    log(f"    {ms:.4f} ms, plain chain {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
        f"({b_by}: {least / 1e6:.1f} MB; with the owner map written and "
        f"read once {(least + 2 * owner) / 1e6:.1f} MB, "
        f"{(least + 2 * owner) / HBM_BYTES_PER_S * 1e3:.6f} ms); device "
        f"split {split}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_bytes": least,
            "owner_map_bytes": owner, "device_split_ms": split,
            "cases": cases, "shape": {"B": b, "D": d, "H": h, "W": w,
                                      "M": m, "dtype": "float32"}}


def trunk_epilogues(depth: int, batch: int, h: int, w: int, dev,
                    dtype=torch.bfloat16, seed: int = 0) -> list:
    """The arguments of every ``frozen_bn_act`` call in one forward of a
    seeded ResNet-``depth`` (FrozenBN scale in [0.5, 1.5], bias in
    [-0.2, 0.2]) over a channels-last [batch, 3, h, w] input on ``dev``,
    in call order."""
    from uwcv_tpu_torch.models import resnet

    torch.manual_seed(seed)
    net = resnet.ResNet(depth)
    for mod in net.modules():
        if isinstance(mod, resnet.FrozenBN):
            mod.scale.uniform_(0.5, 1.5)
            mod.bias.uniform_(-0.2, 0.2)
    net = net.to(dev, dtype)
    x = torch.randn(batch, 3, h, w, device=dev).to(dtype).contiguous(
        memory_format=torch.channels_last)
    calls, real = [], resnet.frozen_bn_act

    def keep(*args):
        calls.append(args)
        return real(*args)

    resnet.frozen_bn_act = keep
    try:
        with torch.no_grad():
            net(x)
    finally:
        resnet.frozen_bn_act = real
    return calls


def epilogues(depth: int, training: bool = False) -> int:
    """``frozen_bn_act`` launches of one ResNet-``depth`` forward on a
    card: the stem's and 3 a block; in a training step at ``freeze_at`` 2
    only the frozen stem's and res2's (the chain runs where a gradient
    flows)."""
    from uwcv_tpu_torch.models.resnet import STAGE_BLOCKS

    blocks = STAGE_BLOCKS[depth]
    return 1 + 3 * (blocks[0] if training else sum(blocks))


def all_fused(rec, calls: int, what: str) -> None:
    """Raise unless the recording ``rec`` of an inference run counted
    ``calls`` epilogues through the op and none on the chain."""
    got = {k: rec.counters.get(k, 0)
           for k in ("frozen_bn.fused", "frozen_bn.plain")}
    if got != {"frozen_bn.fused": calls, "frozen_bn.plain": 0}:
        raise RuntimeError(f"{what}: trunk epilogues {got}, expected "
                           f"{calls} fused and none on the chain")


def epilogue_bytes(args) -> int:
    """Least bytes of one ``frozen_bn_act`` call: x and the residual read
    once, the output written once, the per-channel parameters read."""
    x, scale, bias, residual, res_scale, res_bias = args[:6]
    return sum(t.numel() * t.element_size()
               for t in (x, x, scale, bias, residual, res_scale, res_bias)
               if t is not None)


def check_frozen_bn(dev) -> dict:
    """``frozen_bn_act`` (``csrc/frozen_bn.cu``) on the trunk's own
    epilogues: the 49 calls of one R50 forward at the predict cell's
    shapes (B 8, the 832×1024 canvas, bf16), each bit-identical to the
    chain, also cast to f32; the whole forward's calls timed beside the
    chain and their byte bound, with the device split and the host's time
    a call; then R101's res4 epilogues at the training cell's B 16,
    800² (16 × {256, 1024} × 50 × 50), the bn1/bn2 one over 8 distinct
    inputs so that, 41 MB a call, they are read from HBM and not from the
    50 MB L2.  → the R50 forward's figures, its shape, and ``r101_res4``."""
    from uwcv_tpu_torch.ops.frozen_bn import (
        frozen_bn_act,
        frozen_bn_act_reference,
    )

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32)

    def same(args) -> bool:
        with torch.no_grad():
            got = frozen_bn_act(*args)
        return torch.equal(bits(got), bits(frozen_bn_act_reference(*args)))

    r50 = trunk_epilogues(50, 8, 832, 1024, dev)
    if len(r50) != epilogues(50):
        raise RuntimeError(f"R50 forward made {len(r50)} epilogue calls, "
                           f"not {epilogues(50)}")
    as_f32 = lambda args: tuple(a.float() if isinstance(a, torch.Tensor)
                                else a for a in args)
    for i, args in enumerate(r50):
        if not same(args) or (i % 7 == 0 and not same(as_f32(args))):
            raise RuntimeError(f"frozen_bn_act differs from its chain at "
                               f"call {i}: {tuple(args[0].shape)}")
    log(f"  frozen_bn_act: the 49 epilogues of an R50 forward (B 8, "
        f"832×1024, bf16; every 7th also in f32) bit-identical to the chain")

    def timed(calls, what: str) -> dict:
        run = lambda: [frozen_bn_act(*a) for a in calls]
        plain = lambda: [frozen_bn_act_reference(*a) for a in calls]
        with torch.no_grad():
            ms = cuda_ms(run, calls=5, groups=5)
            plain_ms = cuda_ms(plain, calls=2, groups=3, warmup=1)
            split = device_split(run, calls=5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            host_us = (time.perf_counter() - t0) * 1e6 / len(calls)
            torch.cuda.synchronize()
        least = sum(epilogue_bytes(a) for a in calls)
        b_ms, b_by = bound(least, 0.0, torch.bfloat16)
        kernel_ms = sum(v for k, v in split.items() if "frozen_bn" in k)
        log(f"    {what}: {len(calls)} calls {ms:.4f} ms (kernels "
            f"{kernel_ms:.4f} ms, {least / 1e9:.3f} GB at "
            f"{least / kernel_ms / 1e9:.3f} TB/s), plain chain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); host "
            f"{host_us:.1f} us a call; device split {split}")
        return {"calls": len(calls), "ms": ms, "kernel_ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "bound_bytes": least, "host_us_per_call": host_us,
                "device_split_ms": split}

    rec = {**timed(r50, "R50 forward, B 8, 832×1024"),
           "shape": {"depth": 50, "B": 8, "H": 832, "W": 1024,
                     "dtype": "bfloat16"}}
    del r50
    g = torch.Generator(device=dev).manual_seed(11)
    rand = lambda *s: torch.randn(*s, device=dev, generator=g).to(
        torch.bfloat16)
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)
    mids = [(cl(rand(16, 256, 50, 50)), rand(256), rand(256), None, None,
             None) for _ in range(8)]
    out = (cl(rand(16, 1024, 50, 50)), rand(1024), rand(1024),
           cl(rand(16, 1024, 50, 50)), None, None)
    for args in mids[:1] + [out]:
        if not same(args):
            raise RuntimeError(f"frozen_bn_act differs from its chain at "
                               f"{tuple(args[0].shape)}")
    rec["r101_res4"] = {
        "conv1/conv2 epilogue (16, 256, 50, 50), 8 distinct inputs": timed(
            mids, "R101 res4 bn1/bn2, B 16, 8 distinct inputs"),
        "conv3 epilogue + identity (16, 1024, 50, 50)": timed(
            [out], "R101 res4 bn3 + shortcut, B 16")}
    return rec


BWD_TILE = 8     # side of csrc/roi_align_bwd.cu's output tiles (kTile)


def _roi_bwd_bound(g, slab, y0, x0, wy, wx, canvas_shape):
    """Least time for one backward call: g, the weights and the window
    origins read once and the canvas gradient written once (in g's dtype);
    operations, the two contractions over each roi's sub-window.  Also the
    floor of this design: the same reads, the task pass's tasks and rounded
    weights written once, each roi's g, task and weights read once per
    ``BWD_TILE``² output tile that its sub-window overlaps, and the canvas
    gradient written once.  → (bound ms, what bounds it, design floor ms)."""
    from uwcv_tpu_torch.ops.roi_align import MAX_WINDOW, subwindow_extent

    r, p, win = wy.shape
    n_canvas = int(np.prod(canvas_shape))
    c = canvas_shape[-1]
    elem = g.element_size()
    hlo, nh = subwindow_extent(wy.to(g.dtype))
    wlo, nw = subwindow_extent(wx.to(g.dtype))
    g_bytes = r * p * p * c * elem
    inputs = 2 * r * p * win * 4 + 3 * r * 4
    bytes_moved = g_bytes + inputs + n_canvas * elem
    flops = 2.0 * p * c * float((p * nw + nh * nw).sum())
    b_ms, b_by = bound(bytes_moved, flops, g.dtype)
    # output tiles each roi's sub-window overlaps (none when it is empty)
    ys, xs = y0.long() + hlo, x0.long() + wlo
    span = lambda lo, n: torch.where(
        n > 0, (lo + n - 1) // BWD_TILE - lo // BWD_TILE + 1, 0)
    pairs = int((span(ys, nh) * span(xs, nw)).sum())
    per_roi = 16 + 2 * p * MAX_WINDOW * elem      # a task and its weights
    floor_bytes = (inputs + r * per_roi + pairs * (p * p * c * elem + per_roi)
                   + n_canvas * elem)
    return b_ms, b_by, floor_bytes / HBM_BYTES_PER_S * 1e3


def check_bwd_result(got, g, geo, canvas_shape):
    """A backward kernel's canvas gradient against the plain version in f32
    on g's values, with the weights rounded to g's dtype as the kernel
    rounds them: f32 within 1e-5·max|ref| (another order of f32 sums); bf16
    within one rounding, elementwise |got − ref| <= 2⁻⁷·|ref| +
    1e-5·max|ref|.  → (max abs error, max|ref|, ok)."""
    from uwcv_tpu_torch.ops.roi_align import (
        roi_align_windows_backward_reference,
    )

    slab, y0, x0, wy, wx = geo
    rnd = lambda w: w.to(g.dtype).float()
    ref = roi_align_windows_backward_reference(g.float(), slab, y0, x0,
                                               rnd(wy), rnd(wx), canvas_shape)
    diff = (got.float() - ref).abs()
    top = ref.abs().max().item()
    if g.dtype == torch.float32:
        ok = diff.max().item() <= 1e-5 * top
    else:
        ok = bool((diff <= 2.0 ** -7 * ref.abs() + 1e-5 * top).all())
    ok = ok and tuple(got.shape) == tuple(canvas_shape) and got.dtype == g.dtype
    return diff.max().item(), top, ok


def check_roi_align_backward(dev):
    """The RoIAlign backward at the training shapes (B=2 at 800², canvas
    [10, 200, 200, 256], R = 2·32 rois, P = 7 and 14) in f32 and bf16, held
    by ``check_bwd_result``; each call made into a caching-allocator block
    filled with NaN just before (no NaN may come back) and repeated (the two
    results bit-identical).  Edge cases: rois at the canvas border, 64
    copies of one roi, R = 0; and R = 2·512 (Detectron2's default
    ``roi_batch_size_per_image``).  The bf16 cases of R = 64 and 2·512 are
    timed.  → (the P=7 R=64 bf16 record, all cases, the timed calls'
    arguments by "P=.. R=..")."""
    from uwcv_tpu_torch.ops.roi_align import (
        level_canvas,
        level_strides,
        roi_align_windows_backward,
        roi_align_windows_backward_reference,
        window_geometry,
    )

    rng = np.random.default_rng(6)
    b, size, c, r_per = 2, 800, 256, 32
    strides = {f"p{l}": 2 ** l for l in range(2, 6)}
    feats = {f"p{l}": torch.zeros((b, size >> l, size >> l, c), device=dev)
             for l in range(2, 6)}
    shapes = level_canvas(feats, 32)[1]
    canvas_shape = (5 * b, 200, 200, c)
    border = torch.tensor([[0.0, 0.0, 40.0, 30.0], [760.0, 770.0, 800.0, 800.0],
                           [0.0, 700.0, 800.0, 800.0], [790.0, 0.0, 800.0,
                                                        800.0]])
    cases, timed, timed_args = [], None, {}
    for p in (7, 14):
        rois = _proposal_like_rois(rng, b, r_per, size, size)
        rois[:, 1:5] = border
        same = rois[:1, 5:6].expand(b, r_per, 4)
        wide = _proposal_like_rois(rng, b, 512, size, size)
        for name, rr in (("proposal-like", rois), ("one roi ×64", same),
                         ("proposal-like 2×512", wide)):
            per = rr.shape[1]
            li, y0, x0, wy, wx = window_geometry(
                rr.reshape(-1, 4).to(dev), shapes, level_strides(strides), p,
                224.0, 4, 2, 32)
            slab = (torch.arange(b, device=dev).repeat_interleave(per) * 5
                    + li).to(torch.int32)
            full = (slab, y0.to(torch.int32), x0.to(torch.int32), wy, wx)
            for dtype in (torch.float32, torch.bfloat16):
                for r in ((b * per, 0) if name == "proposal-like"
                          else (b * per,)):
                    geo = tuple(t[:r] for t in full)
                    g = torch.from_numpy(rng.standard_normal(
                        (r, p, p, c), dtype=np.float32)).to(dev, dtype)
                    # the block the output will take holds NaN
                    poison = torch.full(canvas_shape, float("nan"),
                                        dtype=dtype, device=dev)
                    poisoned_at = poison.data_ptr()
                    del poison
                    got = roi_align_windows_backward(g, *geo, canvas_shape)
                    again = roi_align_windows_backward(g, *geo, canvas_shape)
                    torch.cuda.synchronize()
                    err, ref, ok = check_bwd_result(got, g, geo, canvas_shape)
                    case = {"rois": name, "dtype": str(dtype).replace(
                        "torch.", ""), "P": p, "R": r, "max_abs_err": err,
                        "max_abs_ref": ref, "ok": ok,
                        "into_nan_block": got.data_ptr() == poisoned_at,
                        "nan": bool(torch.isnan(got).any()),
                        "repeat_identical": torch.equal(got, again)}
                    del again
                    log(f"  roi_align_windows_backward {case}")
                    if not (ok and case["into_nan_block"] and not case["nan"]
                            and case["repeat_identical"]):
                        raise RuntimeError(
                            f"roi_align_windows_backward disagrees: {case}")
                    if name != "one roi ×64" and dtype == torch.bfloat16 and r:
                        args = (g,) + geo + (canvas_shape,)
                        case["ms"] = cuda_ms(
                            lambda: roi_align_windows_backward(*args))
                        case["plain_ms"] = cuda_ms(
                            lambda: roi_align_windows_backward_reference(
                                *args), calls=5, groups=3)
                        # the design floor is an estimate from the HBM
                        # rate, logged beside the measured times only
                        case["bound_ms"], case["bound_by"], floor = \
                            _roi_bwd_bound(*args)
                        case["device_split_ms"] = device_split(
                            lambda: roi_align_windows_backward(*args))
                        log(f"    kernel {case['ms']:.4f} ms, plain "
                            f"{case['plain_ms']:.4f} ms, bound "
                            f"{case['bound_ms']:.4f} ms ({case['bound_by']}), "
                            f"design floor {floor:.4f} ms; "
                            f"device split {case['device_split_ms']}")
                        timed_args[f"P={p} R={r}"] = args
                        if name == "proposal-like" and p == 7:
                            timed = case
                    del got
                    cases.append(case)
    return timed, cases, timed_args


def _rpn_train_problems(rng):
    """The training RPN's NMS call at 800², batch 2: 2 × 5 level problems
    padded to N = 2000, with 2000, 2000, 2000, 1875 and 507 candidates."""
    boxes, valid = _nms_problems(rng, 10, 2000, 800, 800)
    valid[:] = False
    for i, k in enumerate((2000, 2000, 2000, 1875, 507) * 2):
        valid[i, :k] = True
    return boxes, valid


# ---------------------------------------------------------------- against

def time_wrappers(inputs: str, out: str, outputs: bool = True) -> None:
    """Time the kernel wrappers of the ``uwcv_tpu_torch`` first on
    ``sys.path`` on the inputs saved at ``inputs``; save {name: (ms, the
    outputs on the host, or None without ``outputs``)} at ``out``."""
    from uwcv_tpu_torch.ops.nms import nms_greedy
    from uwcv_tpu_torch.ops.roi_align import (
        roi_align_windows,
        roi_align_windows_backward,
    )

    saved = torch.load(inputs, map_location="cuda")
    calls = {f"roi_align_windows P={p}": (roi_align_windows, [a])
             for p, a in sorted(saved["roi"].items())}
    calls.update({f"roi_align_windows_backward {k}":
                  (roi_align_windows_backward, [a])
                  for k, a in sorted(saved["bwd"].items())})
    calls["nms_greedy (both calls)"] = (nms_greedy, saved["nms"])
    result = {}
    for name, (fn, arg_list) in calls.items():
        run = lambda: [fn(*a) for a in arg_list]
        result[name] = (cuda_ms(run),
                        [o.cpu() for o in run()] if outputs else None)
    torch.save(result, out)


def compare_against(root: str, roi_args, nms_calls, bwd_args) -> dict:
    """The kernel wrappers of the package under ``root`` against these on
    the same inputs (RoIAlign by P, its backward by "P=.. R=..", the NMS
    calls), each side in its own process, in turns (root, this, this,
    root).  → {name: times}; raises when the outputs disagree."""
    work = os.path.join(REPO, "build", "against")
    os.makedirs(work, exist_ok=True)
    inputs = os.path.join(work, "inputs.pt")
    torch.save({"roi": roi_args, "nms": nms_calls, "bwd": bwd_args}, inputs)
    turns = []
    for i, pkg in enumerate((root, REPO, REPO, root)):
        out = os.path.join(work, f"turn{i}.pt")
        # the first turn of each side keeps its outputs for the comparison
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--time-wrappers", os.path.abspath(pkg), inputs, out]
                       + (["--times-only"] if i > 1 else []), check=True)
        turns.append(torch.load(out))
    result = {}
    for name, (_, theirs) in turns[0].items():
        for a, b in zip(theirs, turns[1][name][1]):
            ok = torch.equal(a, b) if a.dtype == torch.bool else (
                (a.float() - b.float()).abs().max()
                <= 2e-2 * a.float().abs().max())
            if not ok:
                raise RuntimeError(f"{name}: {root} and this disagree")
        t = [turn[name][0] for turn in turns]
        result[name] = {"against_ms": (t[0] + t[3]) / 2,
                        "ms": (t[1] + t[2]) / 2, "turns_ms": t}
        log(f"  {name}: {root} {t[0]:.4f}/{t[3]:.4f} ms, this "
            f"{t[1]:.4f}/{t[2]:.4f} ms (turns: {root}, this, this, {root})")
    return result


# ---------------------------------------------------------------- golden

def _mask_iou(a, b):
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return 1.0 if union == 0 else inter / union


def check_gate_golden(dev):
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.weights import load_npz

    # f32 golden: cuDNN convolutions default to TF32 in f32, so turn TF32
    # off for convolutions and matmuls alike
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with np.load(GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    cfg = Config.from_dict(json.loads(str(g["config_json"])))
    assert cfg.model.dtype == "float32"
    pred = Predictor(cfg, load_npz(GATE_CKPT), device=dev)
    images = [np.repeat(im, 3, axis=-1) for im in g["images"]]
    insts = pred.predict_batch(images)
    worst_iou, n_inst = 1.0, 0
    for i, inst in enumerate(insts):
        v = inst.valid
        want_v = g["valid"][i]
        if v.sum() != want_v.sum():
            raise RuntimeError(f"golden image {i}: {v.sum()} valid vs "
                               f"{want_v.sum()} from JAX")
        k = int(v.sum())
        if not np.array_equal(inst.classes[v], g["classes"][i][want_v]):
            raise RuntimeError(f"golden image {i}: classes differ")
        db = np.abs(inst.boxes[v] - g["boxes"][i][want_v]).max(initial=0.0)
        ds = np.abs(inst.scores[v] - g["scores"][i][want_v]).max(initial=0.0)
        if db > 1e-2 or ds > 1e-4:
            raise RuntimeError(f"golden image {i}: box err {db}, score err {ds}")
        want_m = np.unpackbits(g["masks"][i][:k], axis=-1).astype(bool)
        for j in range(k):
            worst_iou = min(worst_iou, _mask_iou(inst.masks[v][j], want_m[j]))
        n_inst += k
    log(f"  gate golden: {len(insts)} images, {n_inst} instances match JAX; "
        f"worst mask IoU {worst_iou:.4f}")
    if worst_iou < 0.99:
        raise RuntimeError(f"golden mask IoU {worst_iou} < 0.99")
    torch.backends.cudnn.allow_tf32 = True


# ---------------------------------------------------------------- folder

FOLDER_CSVS = ("R50_flip_.csv", "ShapeDescriptor.csv")


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def compare_folder_csvs(got_dir: str, want_dir: str, image_hw: dict) -> dict:
    """The folder CSVs in ``got_dir`` against those in ``want_dir``: the
    ImageId sequences and row counts equal, each RLE row's mask at IoU ≥
    0.99 with the other's (``image_hw``: ImageId → (H, W)), and per class
    equal descriptor row counts with each descriptor's median within 1%.
    Raises on a violation; → {"rows", "worst_iou", "worst_median_rel",
    "identical"}."""
    from uwcv_tpu_torch.measure.rle import rle_decode

    got = _read_csv(os.path.join(got_dir, FOLDER_CSVS[0]))
    want = _read_csv(os.path.join(want_dir, FOLDER_CSVS[0]))
    if [r[0] for r in got] != [r[0] for r in want]:
        raise RuntimeError(f"RLE CSV: ImageId sequences differ "
                           f"({len(got) - 1} vs {len(want) - 1} rows)")
    worst_iou = 1.0
    for g, w in zip(got[1:], want[1:]):
        hw = image_hw[g[0]]
        worst_iou = min(worst_iou, _mask_iou(rle_decode(g[1], hw),
                                             rle_decode(w[1], hw)))
    if worst_iou < 0.99:
        raise RuntimeError(f"RLE CSV: worst row mask IoU {worst_iou} < 0.99")
    got = _read_csv(os.path.join(got_dir, FOLDER_CSVS[1]))
    want = _read_csv(os.path.join(want_dir, FOLDER_CSVS[1]))
    if got[0] != want[0]:
        raise RuntimeError("ShapeDescriptor.csv: headers differ")
    worst_rel = 0.0
    for cls in sorted({r[0] for r in got[1:] + want[1:]}):
        a = np.asarray([r[1:] for r in got[1:] if r[0] == cls], np.float64)
        b = np.asarray([r[1:] for r in want[1:] if r[0] == cls], np.float64)
        if len(a) != len(b):
            raise RuntimeError(f"ShapeDescriptor.csv: {cls!r} has {len(a)} "
                               f"rows vs {len(b)}")
        ma, mb = np.median(a, axis=0), np.median(b, axis=0)
        rel = np.abs(ma - mb) / np.maximum(np.abs(mb), 1e-12)
        worst_rel = max(worst_rel, float(rel.max()))
    if worst_rel > 0.01:
        raise RuntimeError(f"ShapeDescriptor.csv: a median differs by "
                           f"{worst_rel:.4%} > 1%")
    identical = all(_read_bytes(os.path.join(got_dir, n))
                    == _read_bytes(os.path.join(want_dir, n))
                    for n in FOLDER_CSVS)
    return {"rows": len(_read_csv(os.path.join(got_dir, FOLDER_CSVS[0]))) - 1,
            "worst_iou": worst_iou, "worst_median_rel": worst_rel,
            "identical": identical}


def check_rows_decode(result: dict) -> int:
    """Every row of the run's RLE CSV decodes to its instance's mask, in
    order.  → the number of rows."""
    from uwcv_tpu_torch.measure.rle import rle_decode

    rows = _read_csv(result["csv"])[1:]
    k = 0
    for path, inst in result["predictions"].items():
        name = os.path.basename(path)
        masks = inst.get("masks")
        for m in ([] if masks is None else masks):
            if not m.any():
                continue
            if k >= len(rows) or rows[k][0] != name or not np.array_equal(
                    rle_decode(rows[k][1], m.shape), m):
                raise RuntimeError(f"RLE CSV row {k} does not decode to "
                                   f"instance mask of {name}")
            k += 1
    if k != len(rows):
        raise RuntimeError(f"RLE CSV has {len(rows)} rows, {k} instances")
    return k


def _gate_folder_cfg(output_dir: str):
    from uwcv_tpu_torch.config import Config

    with open(os.path.join(GATE_SPLIT, "jax", "gate_config.json")) as f:
        cfg = Config.from_dict(json.load(f))
    cfg.data.classes_csv = os.path.join(GATE_SPLIT, "classes.csv")
    cfg.output_dir = output_dir
    return cfg


def check_folder_golden(dev) -> dict:
    """The gate checkpoint in f32 (TF32 off) over the committed gate PNGs
    through ``run_batch_inference``, against the JAX package's committed
    CSVs."""
    from uwcv_tpu_torch.engine.batch_inference import run_batch_inference
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.weights import load_npz

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params = load_npz(GATE_CKPT)
    cfg = _gate_folder_cfg(os.path.join(WORK, "gate_folder"))
    pred = Predictor(cfg, params, device=dev)
    run = run_batch_inference(cfg, pred,
                              image_dir=os.path.join(GATE_SPLIT, "Test"),
                              progress=lambda *_: None)
    image_hw = {os.path.basename(p): inst["masks"].shape[1:]
                for p, inst in run["predictions"].items()}
    record = compare_folder_csvs(os.path.dirname(run["csv"]),
                                 os.path.join(GATE_SPLIT, "jax"), image_hw)
    record["rows_decode"] = check_rows_decode(run)
    log(f"  folder golden: {len(image_hw)} PNGs, {record['rows']} RLE rows "
        f"vs JAX: worst IoU {record['worst_iou']:.4f}, worst descriptor "
        f"median {record['worst_median_rel']:.2e} rel, byte-identical "
        f"{record['identical']}")
    torch.backends.cudnn.allow_tf32 = True
    return record


def check_eval(dev) -> dict:
    """``evaluate_split`` with the gate checkpoint (f32, TF32 off) over the
    committed split: segm and bbox AP within 0.005 of the JAX package's
    (same scanline rasterizer), segm AP ≥ 0.8 × the checkpoint's own."""
    from uwcv_tpu_torch.data.superannotate import get_superannotate_dicts
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.eval.coco_eval import evaluate_split
    from uwcv_tpu_torch.weights import load_npz

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _gate_folder_cfg(os.path.join(WORK, "gate_eval"))
    pred = Predictor(cfg, load_npz(GATE_CKPT), device=dev)
    dicts = get_superannotate_dicts(os.path.join(GATE_SPLIT, "Test"))
    res = evaluate_split(cfg, dicts, predictor=pred)
    with open(os.path.join(GATE_SPLIT, "jax", "gate_ap.json")) as f:
        want = json.load(f)
    with open(GATE_META) as f:
        meta = json.load(f)
    rec = {"segm_AP": res["segm"]["AP"], "bbox_AP": res["bbox"]["AP"],
           "jax_segm_AP": want["segm_AP"], "jax_bbox_AP": want["bbox_AP"],
           "images": len(dicts)}
    log(f"  gate eval ({torch.device(dev)}): segm AP {rec['segm_AP']:.4f} (JAX "
        f"{want['segm_AP']:.4f}), bbox AP {rec['bbox_AP']:.4f} (JAX "
        f"{want['bbox_AP']:.4f}), {len(dicts)} images")
    for kind in ("segm_AP", "bbox_AP"):
        if abs(rec[kind] - want[kind]) > 0.005:
            raise RuntimeError(f"gate {kind} {rec[kind]} vs JAX {want[kind]}")
    if rec["segm_AP"] < 0.8 * meta["segm_AP"]:
        raise RuntimeError(f"gate segm AP {rec['segm_AP']} < 0.8 × "
                           f"{meta['segm_AP']}")
    torch.backends.cudnn.allow_tf32 = True
    return rec


def _launch_counts() -> dict:
    from uwcv_tpu_torch.kernels import launch_counts

    return launch_counts()


def _zero_launch_counts() -> None:
    from uwcv_tpu_torch.ops.frozen_bn import frozen_bn_act
    from uwcv_tpu_torch.ops.mask_paste import paste_claim_pack
    from uwcv_tpu_torch.ops.nms import nms_greedy
    from uwcv_tpu_torch.ops.roi_align import (
        roi_align_windows,
        roi_align_windows_backward,
    )

    for f in (roi_align_windows, roi_align_windows_backward, nms_greedy,
              paste_claim_pack, frozen_bn_act):
        f.launches = 0


def write_folder_tiffs(image_dir: str, n_images: int) -> str:
    """``n_images`` seeded 1024×1280 16-bit TIFFs in a fresh
    ``image_dir``."""
    shutil.rmtree(image_dir, ignore_errors=True)
    os.makedirs(image_dir)
    rng = np.random.default_rng(5)
    for i in range(n_images):
        write_tiff16(os.path.join(image_dir, f"sem_{i:03d}.tif"),
                     rng.integers(0, 65536, (1024, 1280), dtype=np.uint16))
    return image_dir


# the host stages of the predictor and the folder pipeline, as spans of the
# recorder (``uwcv_tpu_torch/utils/trace.py``)
HOST_STAGES = ("stage_batch", "_run", "d2h wait", "to_instances", "decode",
               "resize_masks_to_original", "rle", "measurement", "csv writes")


def host_stages(rec, per: int = 1) -> tuple:
    """(host ms, calls) by stage of ``HOST_STAGES`` in a recording, the ms
    over ``per``."""
    ms, calls = rec.host_ms(), rec.calls()
    return ({k: v / per for k, v in ms.items() if k in HOST_STAGES},
            {k: v for k, v in calls.items() if k in HOST_STAGES})


def run_folder_full_width(dev, n_images: int = 16, batch: int = 8) -> dict:
    """R50-FPN-256 bf16 with seeded weights over ``n_images`` seeded
    1024×1280 16-bit TIFFs through ``run_batch_inference`` with the
    measurements on.  Launch counts are zeroed just before and read just
    after; host ms per stage come from the recorder's spans."""
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.batch_inference import run_batch_inference
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.utils.trace import recording

    image_dir = write_folder_tiffs(os.path.join(WORK, "folder_tiff"),
                                   n_images)
    cfg = Config()
    cfg.model.roi_score_thresh_test = 0.0
    cfg.output_dir = os.path.join(WORK, "folder_out")
    pred = Predictor(cfg, seeded_flax_params(cfg.model, 0), device=dev)
    _zero_launch_counts()
    t0 = time.perf_counter()
    with recording() as rec:
        result = run_batch_inference(cfg, pred, image_dir=image_dir,
                                     batch_size=batch, with_measurements=True,
                                     with_plots=False,
                                     progress=lambda *_: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    n_batches = -(-n_images // batch)
    want = {"roi_align_windows": 2 * n_batches,
            "roi_align_windows_backward": 0, "nms_greedy": 2 * n_batches,
            "paste_claim_pack": n_batches,
            "frozen_bn_act": epilogues(50) * n_batches}
    if launches != want:
        raise RuntimeError(f"folder phase launches {launches}, expected "
                           f"{want} (2, 1 and 49 a batch × {n_batches})")
    all_fused(rec, epilogues(50) * n_batches, "folder phase")
    rows = check_rows_decode(result)
    stages, stage_calls = host_stages(rec)
    stage_sum = sum(stages.values())
    counts = [int(len(i["scores"])) for i in result["predictions"].values()]
    log(f"  folder full width: {n_images} × 1024×1280 16-bit TIFF, batch "
        f"{batch}, measurements on: {n_images / wall:.3f} img/s "
        f"({wall * 1e3:.1f} ms, host clock over the call); {rows} RLE rows "
        f"decode to their masks; instances per image {counts}; launches "
        f"{launches}")
    log("  folder host stages (host clock, ms, summed over the call): "
        + json.dumps({k: round(v, 1) for k, v in stages.items()}))
    log(f"  folder stage sum {stage_sum:.1f} ms over {wall * 1e3:.1f} ms of "
        f"wall: the pipeline hides {max(stage_sum - wall * 1e3, 0.0):.1f} ms")
    if sum(counts) == 0:
        raise RuntimeError("folder phase: no instance survived")
    return {"img_per_s": n_images / wall, "wall_ms": wall * 1e3,
            "stages_ms": stages, "stage_calls": stage_calls,
            "rows": rows, "launches": launches}


# ---------------------------------------------------------------- full width

def seeded_flax_params(model_cfg, seed: int):
    """Random weights in the Flax layout (lecun-normal kernels, Detectron2's
    small-std RPN and predictor inits), made with numpy from ``seed``.  The
    class-0 logit and the mask-predictor biases are raised so that the
    untrained model yields confident, solid masks and the mask tail (score
    floor, topology cleanup, overlap claim) keeps work to do."""
    from uwcv_tpu_torch.weights import flax_param_shapes

    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in sorted(flax_param_shapes(model_cfg).items()):
        if key.endswith("frozen_bn_scale"):
            a = np.ones(shape)
        elif key.endswith("bias") or key.endswith("frozen_bn_bias"):
            a = np.zeros(shape)
        else:
            std = 1.0 / np.sqrt(np.prod(shape[:-1]))
            if "rpn_head" in key or "cls_score" in key:
                std = 0.01
            elif "bbox_pred" in key:
                std = 0.001
            a = rng.standard_normal(shape) * std
        out[key] = a.astype(np.float32)
    out["params/box_head/cls_score/bias"][0] = 4.0
    out["params/mask_head/predictor/bias"][:] = 4.0
    return out


_D2_MODULES = {
    "backbone/stem_conv": "backbone.bottom_up.stem.conv1",
    "backbone/stem_bn": "backbone.bottom_up.stem.conv1.norm",
    "rpn_head/rpn_conv": "proposal_generator.rpn_head.conv",
    "rpn_head/objectness": "proposal_generator.rpn_head.objectness_logits",
    "rpn_head/anchor_deltas": "proposal_generator.rpn_head.anchor_deltas",
    "box_head/fc1": "roi_heads.box_head.fc1",
    "box_head/fc2": "roi_heads.box_head.fc2",
    "box_head/cls_score": "roi_heads.box_predictor.cls_score",
    "box_head/bbox_pred": "roi_heads.box_predictor.bbox_pred",
}


def _d2_module(mod: str) -> str:
    """A Flax module path → its module name in a Detectron2 checkpoint."""
    import re

    m = re.fullmatch(r"backbone/res(\d)_block(\d+)/(\w+)", mod)
    if m:
        stage, block, part = m.groups()
        base = f"backbone.bottom_up.res{stage}.{block}."
        return base + {"shortcut_conv": "shortcut",
                       "shortcut_bn": "shortcut.norm"}.get(
            part, part if part.startswith("conv") else f"conv{part[2:]}.norm")
    m = re.fullmatch(r"fpn/(lateral_c|output_p)(\d)", mod)
    if m:
        return f"backbone.fpn_{m.group(1)[:-2]}{m.group(2)}"
    if mod.startswith("mask_head/"):
        return "roi_heads.mask_head." + mod.split("/", 1)[1]
    return _D2_MODULES[mod]


def detectron2_state_dict(flat: dict, rng, pool: int = 7):
    """Flat Flax params → a checkpoint in Detectron2's names and layouts,
    as ``torch.save`` would write a trained model's: ``{"model": state
    dict, ...}`` with convs OIHW, linears [out, in], ``fc1`` over the
    CHW-flattened pool, the deconv IOHW and unflipped, and every FrozenBN
    as a BatchNorm (weight, bias, running_mean, running_var drawn from
    ``rng``).  → (the checkpoint, the flat params it imports to: ``flat``
    with each FrozenBN leaf folded from its drawn stats, eps 1e-5)."""
    sd, expected = {}, dict(flat)
    for key, a in flat.items():
        parts = key.split("/")
        mod, leaf = "/".join(parts[1:-1]), parts[-1]
        name = _d2_module(mod)
        if leaf == "frozen_bn_bias":
            continue                      # written with its scale
        if leaf == "frozen_bn_scale":
            n = a.shape[0]
            gamma = rng.uniform(0.9, 1.1, n).astype(np.float32)
            beta = rng.normal(0.0, 0.01, n).astype(np.float32)
            mean = rng.normal(0.0, 0.01, n).astype(np.float32)
            var = rng.uniform(0.9, 1.1, n).astype(np.float32)
            scale = gamma / np.sqrt(var + 1e-5)
            expected[key] = scale.astype(np.float32)
            expected[key[:-len("scale")] + "bias"] = (
                beta - mean * scale).astype(np.float32)
            for field, v in (("weight", gamma), ("bias", beta),
                             ("running_mean", mean), ("running_var", var)):
                sd[f"{name}.{field}"] = torch.from_numpy(v)
            continue
        if leaf == "kernel" and mod == "mask_head/deconv":
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)           # → IOHW
        elif leaf == "kernel" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)                       # HWIO → OIHW
        elif leaf == "kernel" and mod == "box_head/fc1":
            out = a.shape[1]
            a = a.T.reshape(out, pool, pool, -1).transpose(0, 3, 1, 2) \
                .reshape(out, -1)                             # HWC → CHW
        elif leaf == "kernel":
            a = a.T
        field = "weight" if leaf == "kernel" else "bias"
        sd[f"{name}.{field}"] = torch.from_numpy(
            np.ascontiguousarray(a, np.float32))
    sd["pixel_mean"] = torch.tensor([[[103.53]], [[116.28]], [[123.675]]])
    sd["pixel_std"] = torch.ones(3, 1, 1)
    return {"model": sd, "__author__": "seeded", "iteration": 0}, expected


def run_full_width(dev):
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.predictor import Predictor

    cfg = Config()                       # R50-FPN-256, bf16, 1024×1344 pad
    cfg.model.roi_score_thresh_test = 0.0
    pred = Predictor(cfg, seeded_flax_params(cfg.model, 0), device=dev)
    rng = np.random.default_rng(3)
    b = 8
    images = [np.repeat(rng.integers(0, 256, (1024, 1280, 1), dtype=np.uint8),
                        3, axis=-1) for _ in range(b)]
    warmup, timed = 2, 5

    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    for _ in range(warmup):
        pred.predict_batch(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        insts = pred.predict_batch(images)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # one more batch, staged by hand, for the per-stage breakdown
    pred.model.marks = []
    host = {}
    t = time.perf_counter()
    ops, unmap = pred.stage_batch(images)
    host["stage_batch (host resize, pad, H2D)"] = time.perf_counter() - t
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t = time.perf_counter()
    out = pred._run(*ops)
    host["_run (enqueue + tail syncs)"] = time.perf_counter() - t
    t = time.perf_counter()
    insts_s = pred.to_instances(out + tuple(unmap))
    host["to_instances (sync, D2H, unpack)"] = time.perf_counter() - t
    marks, pred.model.marks = pred.model.marks, None
    launches = _launch_counts()
    n_batches = warmup + timed + 1
    peak = torch.cuda.max_memory_allocated()

    stages, prev = {}, start
    for name, ev in marks:
        stages[name] = prev.elapsed_time(ev)
        prev = ev
    log(f"  full width R50-FPN-256 bf16, batch {b} of 1024×1280 → canvas "
        f"{tuple(ops[0].shape[1:3])}: {b * timed / wall:.2f} img/s "
        f"({wall / timed * 1e3:.1f} ms/batch, host clock, {timed} batches)")
    log("  device stages (CUDA events, ms): " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}))
    log("  host stages (host clock, ms): " + json.dumps(
        {k: round(v * 1e3, 1) for k, v in host.items()}))
    log(f"  peak device memory {peak / 2**30:.2f} GiB; launches over "
        f"{n_batches} batches: {launches}")

    if launches["roi_align_windows"] != 2 * n_batches:
        raise RuntimeError(f"RoIAlign kernel launches {launches} != 2 per batch")
    if launches["nms_greedy"] != 2 * n_batches:
        raise RuntimeError(f"NMS kernel launches {launches} != 2 per batch "
                           f"(RPN 5·B problems + detection B problems)")
    if launches["paste_claim_pack"] != n_batches:
        raise RuntimeError(f"mask tail launches {launches} != 1 per batch")
    if launches["roi_align_windows_backward"]:
        raise RuntimeError(f"inference launched the backward: {launches}")
    if launches["frozen_bn_act"] != epilogues(50) * n_batches:
        raise RuntimeError(f"trunk epilogue launches {launches} != "
                           f"{epilogues(50)} per batch")
    for inst in insts + insts_s:
        if not (np.isfinite(inst.boxes).all() and np.isfinite(inst.scores).all()):
            raise RuntimeError("non-finite detections")
        nonempty = inst.valid & inst.masks.reshape(len(inst.valid), -1).any(1)
        if not nonempty.any():
            raise RuntimeError("an image has no valid detection with a mask")
    log(f"  valid detections per image: {[int(i.valid.sum()) for i in insts]}")
    return launches


# ---------------------------------------------------------------- training

TRAIN_GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_train_golden.npz")
LOSS_KEYS = ("rpn_cls", "rpn_loc", "cls", "box_reg", "mask")
TRAIN_WARMUP, TRAIN_TIMED = 2, 20     # full-width training steps


def check_train_golden(dev, out_dir=None, loss_rtol: float = 1e-3,
                       norm_rtol: float = 1e-3) -> dict:
    """The gate checkpoint trained 3 SGD steps in f32 (TF32 off) on the
    golden's two gate images with augmentation off and the golden's sampler
    draws, through ``Trainer.train_step``: each step's losses within
    ``loss_rtol`` of the JAX package's and the step-1 gradient norm of
    every trainable leaf within ``norm_rtol`` (cuDNN's backward algorithms
    sum in other orders than XLA's)."""
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.trainer import Trainer, step_generator
    from uwcv_tpu_torch.weights import flax_leaf_names, load_npz

    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    with np.load(TRAIN_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    cfg = Config.from_dict(json.loads(str(g["config_json"])))
    cfg.output_dir = out_dir or os.path.join(WORK, "train_golden")
    trainer = Trainer(cfg, device=dev)
    trainer.load_params(load_npz(GATE_CKPT))
    put = lambda a: torch.from_numpy(a).to(dev)
    batch = {k: put(g[k]) for k in ("image", "boxes", "classes", "valid",
                                    "masks_packed")}
    steps = sorted({int(k[4:].split("_")[0]) for k in g if k.startswith("step")})
    worst_loss, worst_norm = 0.0, 0.0
    for step in steps:
        draws = {k: put(g[f"step{step}_{k}"])
                 for k in ("rpn_pos", "rpn_neg", "roi_pos", "roi_neg")}
        m = trainer.train_step(batch, step_generator(cfg.solver.seed, step,
                                                     dev), sampler_draws=draws)
        got = np.asarray([float(m[k]) for k in LOSS_KEYS + ("total_loss",)])
        want = g[f"step{step}_losses"]
        rel = np.abs(got - want) / np.abs(want)
        worst_loss = max(worst_loss, float(rel.max()))
        if not (rel <= loss_rtol).all():
            raise RuntimeError(f"train golden step {step}: losses {got} vs "
                               f"JAX {want}")
        if step == 0:
            names = flax_leaf_names(trainer.compute)
            params = dict(trainer.compute.named_parameters())
            norms = {k: float(params[names[k]].grad.float().norm())
                     for k in g["grad_norm_keys"]}
            for k, want_n in zip(g["grad_norm_keys"], g["grad_norms"]):
                r = abs(norms[k] - want_n) / max(want_n, 1e-12)
                worst_norm = max(worst_norm, r)
                if r > norm_rtol:
                    raise RuntimeError(f"train golden: |grad| of {k} "
                                       f"{norms[k]} vs JAX {want_n}")
    rec = {"steps": len(steps), "worst_loss_rel": worst_loss,
           "worst_grad_norm_rel": worst_norm,
           "leaves": int(len(g["grad_norm_keys"]))}
    log(f"  train golden ({torch.device(dev)}): {rec['steps']} SGD steps, "
        f"losses within {worst_loss:.2e} rel of JAX, {rec['leaves']} "
        f"step-1 gradient norms within {worst_norm:.2e} rel")
    if cuda:
        torch.backends.cudnn.allow_tf32 = True
    return rec


def run_train_full_width(dev) -> dict:
    """``Trainer.fit`` at the default config (R50-FPN-256, box FC 1024,
    bf16 compute, f32 masters, 800×800, batch 2) from seeded weights over
    the 12 annotated gate-split images staged on the device
    (``TrainLoader.device_dataset``): ``TRAIN_WARMUP`` steps, then
    ``TRAIN_TIMED`` timed steps at the default ``solver.log_period`` (the
    host waits for the device at each logged step), then ``TRAIN_TIMED``
    more logging every step, which shows what a wait per step costs.
    Launch counts are zeroed just before and read just after; every
    logged loss and every master weight must be finite (a non-finite loss
    at an unlogged step reaches the weights through its gradient), and
    ``model_final.npz`` must load into the port's ``Predictor``."""
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.data.classes import ClassRegistry
    from uwcv_tpu_torch.data.loader import TrainLoader
    from uwcv_tpu_torch.data.superannotate import get_superannotate_dicts
    from uwcv_tpu_torch.engine.predictor import load_predictor
    from uwcv_tpu_torch.engine.trainer import Trainer

    cfg = Config()
    out = os.path.join(WORK, "train_full")
    shutil.rmtree(out, ignore_errors=True)
    cfg.output_dir = out
    cfg.solver.checkpoint_period = 0
    registry = ClassRegistry.load(os.path.join(GATE_SPLIT, "classes.csv"))
    dicts = get_superannotate_dicts(os.path.join(GATE_SPLIT, "Test"),
                                    registry=registry)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev)
    trainer.load_params(seeded_flax_params(cfg.model, 0))
    loader = TrainLoader(dicts, cfg, seed=cfg.solver.seed)
    dd = loader.device_dataset(trainer.device)
    if dd is None:
        raise RuntimeError("the gate split does not fit the device budget")
    setup_s = time.perf_counter() - t0
    batches = loader.index_batches()
    lines = []
    fit = lambda n: trainer.fit(batches, max_iter=trainer.step + n,
                                log_fn=lines.append, device_dataset=dd)
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    fit(TRAIN_WARMUP)
    trainer.marks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit(TRAIN_TIMED)
    wall = time.perf_counter() - t0
    marks, trainer.marks = trainer.marks, None
    trainer.cfg.solver.log_period = 1
    fit(TRAIN_TIMED)
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = {m["iteration"]: m for m in map(json.loads, f)}
    n_steps = TRAIN_WARMUP + 2 * TRAIN_TIMED
    step_ms = metrics[TRAIN_WARMUP + TRAIN_TIMED]["time_per_iter"] * 1e3
    synced_ms = metrics[n_steps]["time_per_iter"] * 1e3
    split = {}
    prev = None
    for name, ev in marks:
        if prev is not None and name != "start":
            split[name] = (split.get(name, 0.0)
                           + prev.elapsed_time(ev) / TRAIN_TIMED)
        prev = ev
    want = {"roi_align_windows": 2 * n_steps,
            "roi_align_windows_backward": 2 * n_steps, "nms_greedy": n_steps,
            "paste_claim_pack": 0,
            "frozen_bn_act": epilogues(50, training=True) * n_steps}
    log(f"  train full width R50-FPN-256 bf16 (f32 masters), batch 2 at "
        f"800×800, {len(dicts)} images on the device: {step_ms:.1f} ms/step "
        f"({2e3 / step_ms:.2f} img/s; host clock over {TRAIN_TIMED} steps "
        f"after {TRAIN_WARMUP} warm-up at log period "
        f"{cfg.solver.log_period}, Trainer's time_per_iter), wall "
        f"{wall:.2f} s incl. the final checkpoint; logging every step "
        f"(a host wait per step) {synced_ms:.1f} ms/step; setup "
        f"{setup_s:.1f} s")
    log("  train step split (CUDA events, ms/step): " + json.dumps(
        {k: round(v, 3) for k, v in split.items()}))
    log(f"  peak device memory {peak / 2**30:.2f} GiB; launches over "
        f"{n_steps} steps: {launches}")
    if launches != want:
        raise RuntimeError(f"train launches {launches}, expected {want}")
    logged = sorted(metrics)
    losses = [metrics[i][k] for i in logged
              for k in LOSS_KEYS + ("total_loss",)]
    if logged[-1] != n_steps or not np.isfinite(losses).all():
        raise RuntimeError(f"train: logged steps {logged}, losses finite "
                           f"{np.isfinite(losses).all()}")
    if not all(torch.isfinite(p).all() for p in trainer.model.parameters()):
        raise RuntimeError("train: a master weight is not finite")
    working = dict(trainer.compute.named_parameters())
    for n, p in trainer.model.named_parameters():
        if not torch.equal(working[n], p.to(working[n].dtype)):
            raise RuntimeError(f"train: the working copy's {n} is not its "
                               f"master rounded to {working[n].dtype}")
    pcfg = Config()
    pred = load_predictor(pcfg, os.path.join(out, "model_final.npz"),
                          device=dev)
    trained = dict(trainer.model.named_parameters())
    for n, p in pred.model.named_parameters():
        if not torch.equal(p.float(), trained[n].to(p.dtype).float()):
            raise RuntimeError(f"model_final.npz: {n} differs from the "
                               f"trained weights")
    first, last = metrics[logged[0]], metrics[n_steps]
    log(f"  model_final.npz loads into Predictor ({pcfg.model.dtype}); "
        f"total loss at steps {logged[0]} / {n_steps}: "
        f"{first['total_loss']:.4f} / {last['total_loss']:.4f}")
    # the device's busy time in a step, by kernel (after the counts were
    # read): busy against the step's host-clock time gives the idle share
    idx = torch.arange(2, device=dev)
    batch = {k: v.index_select(0, idx) for k, v in dd.items()}
    gen = torch.Generator(device=dev)
    by_kernel = device_split(lambda: trainer.train_step(batch, gen), calls=5)
    busy = sum(by_kernel.values())
    top = dict(list(by_kernel.items())[:8])
    log(f"  device busy {busy:.2f} ms of a {step_ms:.1f} ms step (idle "
        f"{1 - busy / step_ms:.1%}; {1 - busy / synced_ms:.1%} logging "
        f"every step; torch.profiler over 5 steps); top kernels (ms/step): "
        + json.dumps({k: round(v, 3) for k, v in top.items()}))
    # the ops on the pooler's canvas and its gradient ([5B, Hmax, Wmax, C]
    # and its [B, 5, Hmax, Wmax, C] view; p2 at stride 4 is the largest
    # level): B1-bwd's output, autograd's add of the box and mask canvas
    # gradients, level_canvas's fill, copies and slice backward
    b = cfg.solver.ims_per_batch
    hw = [max(n // 4, 32) for n in cfg.input.train_size]
    canvas = [[5 * b, *hw, cfg.model.fpn_channels],
              [b, 5, *hw, cfg.model.fpn_channels]]
    canvas_ops = op_split_by_shape(lambda: trainer.train_step(batch, gen),
                                   canvas)
    log(f"  ops on the canvas {canvas[0]} (ms/step, torch.profiler over 5 "
        f"steps): {sum(canvas_ops.values()):.3f} in all; "
        + json.dumps({k: round(v, 4) for k, v in canvas_ops.items()}))
    return {"ms_per_step": step_ms, "img_per_s": 2e3 / step_ms,
            "ms_per_step_logging_every_step": synced_ms,
            "split_ms": split, "peak_gib": peak / 2**30,
            "launches": launches, "steps": n_steps,
            "device_busy_ms": busy, "idle_share": 1 - busy / step_ms,
            "idle_share_logging_every_step": 1 - busy / synced_ms,
            "top_kernels_ms": top, "canvas_ops_ms": canvas_ops,
            "losses_first_last": [first["total_loss"], last["total_loss"]]}


# ---------------------------------------------------------------- pth, hpo

def run_pth_import(dev) -> dict:
    """R101-FPN (the reference's architecture) at the default config in
    bf16: seeded weights written as a Detectron2-named ``.pth`` (FPN, RPN
    and heads included, BN with running stats, ``fc1`` over CHW) and read
    by ``load_predictor``.  Every leaf of the R101 tree must hold the
    checkpoint's value (rounded to bf16); the imported params, written to
    an ``.npz`` and read by ``load_predictor`` again, must give outputs
    bit-identical to the ``.pth`` predictor's on one batch of 8 gray
    1024×1280 images.  Launch counts are zeroed just before the two
    batches (each kernel twice a batch)."""
    import copy

    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.checkpoint import save_params_npz
    from uwcv_tpu_torch.engine.predictor import load_predictor
    from uwcv_tpu_torch.weights import flax_param_shapes, params_to_flax

    cfg = Config()
    cfg.model.depth = 101
    work = os.path.join(WORK, "pth_import")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    flat = seeded_flax_params(cfg.model, 0)
    rng = np.random.default_rng(7)
    for k, a in flat.items():
        # biases unlike any initialisation, so a missed one shows
        if k.endswith("/bias"):
            flat[k] = a + rng.normal(0.0, 0.01, a.shape).astype(np.float32)
    ckpt, expected = detectron2_state_dict(flat, rng)
    pth = os.path.join(work, "model_final.pth")
    torch.save(ckpt, pth)
    n_leaves = len(flax_param_shapes(cfg.model))
    t0 = time.perf_counter()
    pred = load_predictor(copy.deepcopy(cfg), pth, device=dev)
    load_s = time.perf_counter() - t0
    got = params_to_flax(pred.model)
    bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    missed = sorted(k for k in expected
                    if not np.array_equal(got[k], bf16(expected[k])))
    matched = len(expected) - len(missed)
    log(f"  R101-FPN-256 bf16: {matched} of {n_leaves} leaves of the R101 "
        f"tree hold the Detectron2 .pth's values ({len(ckpt['model'])} "
        f"state-dict entries, {os.path.getsize(pth) / 1e6:.1f} MB; "
        f"load_predictor {load_s:.1f} s)")
    if missed or len(expected) != n_leaves:
        raise RuntimeError(f"pth import: {len(missed)} leaves unmatched: "
                           f"{missed[:20]}")
    npz = save_params_npz(os.path.join(work, "imported.npz"), got)
    pred_npz = load_predictor(copy.deepcopy(cfg), npz, device=dev)
    rng = np.random.default_rng(3)
    images = [np.repeat(rng.integers(0, 256, (1024, 1280, 1), dtype=np.uint8),
                        3, axis=-1) for _ in range(8)]
    _zero_launch_counts()
    outs = [p.predict_batch(images) for p in (pred, pred_npz)]
    torch.cuda.synchronize()
    launches = _launch_counts()
    for a, b in zip(*outs):
        for field in ("boxes", "scores", "classes", "valid", "masks"):
            x, y = getattr(a, field), getattr(b, field)
            if not np.array_equal(x, y):
                raise RuntimeError(f"pth import: {field} of the .pth and the "
                                   f".npz predictors differ")
        if not (np.isfinite(a.boxes).all() and np.isfinite(a.scores).all()):
            raise RuntimeError("pth import: non-finite detections")
    want = {"roi_align_windows": 4, "roi_align_windows_backward": 0,
            "nms_greedy": 4, "paste_claim_pack": 2,
            "frozen_bn_act": 2 * epilogues(101)}
    valid = [int(i.valid.sum()) for i in outs[0]]
    log(f"  .pth and .npz predictors bit-identical on a batch of 8 gray "
        f"1024×1280 images (valid detections per image {valid}); launches "
        f"over the two batches: {launches}")
    if launches != want:
        raise RuntimeError(f"pth import launches {launches}, expected {want}")
    return {"leaves_matched": matched, "leaves": n_leaves,
            "state_dict_entries": len(ckpt["model"]), "load_s": load_s,
            "valid_per_image": valid, "launches": launches}


HPO_TRIALS, HPO_ITERS = 3, 20       # the CLI's default is 8 trials × 100


def run_hpo(dev) -> dict:
    """``synth`` writes 8 train and 4 test images at 1024×1280; then
    ``run_reference_hpo`` at the default config (R50-FPN-256, bf16 compute,
    f32 masters, 800×800, batch 2) runs ``HPO_TRIALS`` trials of
    ``HPO_ITERS`` steps, space v1, each scored by segm AP on the 4 test
    images.  Every trial must complete with a finite value in [0, 1];
    launch counts, zeroed just before, must be the sums over the trials
    (RoIAlign and its backward twice a step, NMS once; RoIAlign and NMS
    twice an eval batch).  Every trial's eval must fill a predictor
    through ``Predictor.set_params`` (watched here) with its own trained
    weights, and the last one filled must hold the last trial's weights
    rounded to bf16.  Then ``save_gt_visualizations`` over 2 train
    images, whose PNGs must decode to the images' shape."""
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.data.catalog import DatasetCatalog
    from uwcv_tpu_torch.data.classes import ClassRegistry
    from uwcv_tpu_torch.data.imageio import decode_png
    from uwcv_tpu_torch.data.superannotate import get_superannotate_dicts
    from uwcv_tpu_torch.data.synthetic import generate_dataset
    from uwcv_tpu_torch.engine.batch_inference import save_gt_visualizations
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.hpo.study import run_reference_hpo
    from uwcv_tpu_torch.weights import params_to_flax

    root = os.path.join(WORK, "hpo_data")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    n_train, n_test, size = 8, 4, (1024, 1280)
    paths = generate_dataset(root, num_train=n_train, num_test=n_test,
                             num_inference=0, image_size=size, seed=0)
    synth_s = time.perf_counter() - t0
    cfg = Config()
    cfg.output_dir = os.path.join(WORK, "hpo_out")
    shutil.rmtree(cfg.output_dir, ignore_errors=True)
    cfg.data.classes_csv = paths["classes_csv"]
    cfg.data.train_dataset = "chip_smoke_hpo_train"
    cfg.data.test_dataset = "chip_smoke_hpo_test"
    for name in (cfg.data.train_dataset, cfg.data.test_dataset):
        DatasetCatalog.remove(name)
    # every params dict the sweep swaps into an eval predictor: a digest
    # of one leaf of each (trials start from inits of their own seeds, so
    # every leaf differs between them), and the last predictor and params
    fills, last = [], {}
    set_params = Predictor.set_params

    def watched(self, params):
        fills.append((id(self), hashlib.sha256(np.ascontiguousarray(
            params["params/box_head/fc2/kernel"])).hexdigest()))
        last.update(pred=self, params=params)
        set_params(self, params)

    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    Predictor.set_params = watched
    t0 = time.perf_counter()
    try:
        res = run_reference_hpo(cfg, n_trials=HPO_TRIALS,
                                data_dir=paths["Train"], max_iter=HPO_ITERS,
                                seed=0, space="v1", device=dev)
    finally:
        Predictor.set_params = set_params
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    trials = res["trials"]
    for t in trials:
        a = t["user_attrs"]
        log(f"  trial {t['number']} {t['state']}: segm AP {t['value']}, "
            f"params {t['params']}; set-up {a.get('setup_s', 0):.2f} s, "
            f"{a.get('steps', 0)} steps {a.get('train_s', 0):.2f} s "
            f"({a.get('train_s', 0) / max(a.get('steps', 1), 1) * 1e3:.1f} "
            f"ms/step, host clock, first step included), eval "
            f"{a.get('eval_s', 0):.2f} s" + (f"; error {a['error']}"
                                            if "error" in a else ""))
    bad = [t for t in trials if t["state"] != "COMPLETE"]
    if bad or len(trials) != HPO_TRIALS:
        raise RuntimeError(f"hpo: trials not complete: {bad}")
    if res["objective"] != "segm_mAP":
        raise RuntimeError(f"hpo objective {res['objective']}")
    for t in trials:
        if not (np.isfinite(t["value"]) and 0.0 <= t["value"] <= 1.0):
            raise RuntimeError(f"hpo trial {t['number']} value {t['value']}")
    eval_batches = HPO_TRIALS * 1            # 4 test images, one batch
    steps = HPO_TRIALS * HPO_ITERS
    want = {"roi_align_windows": 2 * steps + 2 * eval_batches,
            "roi_align_windows_backward": 2 * steps,
            "nms_greedy": steps + 2 * eval_batches,
            "paste_claim_pack": eval_batches,
            "frozen_bn_act": (epilogues(50, training=True) * steps
                              + epilogues(50) * eval_batches)}
    log(f"  hpo: {HPO_TRIALS} trials × {HPO_ITERS} steps in {wall:.1f} s "
        f"(synth {synth_s:.1f} s before); {res['eval_predictors']} eval "
        f"predictors built; peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}")
    if launches != want:
        raise RuntimeError(f"hpo launches {launches}, expected {want}")
    # each trial trains from its own init, so each eval needs new weights
    if len(fills) != HPO_TRIALS or len({h for _, h in fills}) != HPO_TRIALS:
        raise RuntimeError(f"hpo: {len(fills)} eval fills, "
                           f"{len({h for _, h in fills})} distinct weights; "
                           f"expected {HPO_TRIALS} of each")
    if len({i for i, _ in fills}) != res["eval_predictors"]:
        raise RuntimeError("hpo: eval predictors filled != built")
    held = params_to_flax(last["pred"].model)
    bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    stale = sorted(k for k, v in last["params"].items()
                   if not np.array_equal(held[k], bf16(np.asarray(v))))
    if stale or sorted(held) != sorted(last["params"]):
        raise RuntimeError(f"hpo: the last eval predictor does not hold the "
                           f"last trial's weights: {stale[:10]}")
    log(f"  hpo: {len(fills)} eval fills with {len(fills)} distinct weights "
        f"into {res['eval_predictors']} predictors; the last holds the last "
        f"trial's {len(held)} leaves rounded to bf16")
    gallery = save_gt_visualizations(
        get_superannotate_dicts(paths["Train"]), ClassRegistry(),
        os.path.join(WORK, "hpo_gt"), max_images=2)
    for p in gallery:
        with open(p, "rb") as f:
            shape = decode_png(f.read()).pixels.shape
        if shape != size + (3,):
            raise RuntimeError(f"gt gallery {p}: shape {shape}")
    log(f"  gt gallery: {len(gallery)} PNGs decode to {size + (3,)}")
    for name in (cfg.data.train_dataset, cfg.data.test_dataset):
        DatasetCatalog.remove(name)
    return {"trials": trials, "best_value": res["best_value"],
            "best_params": res["best_params"], "wall_s": wall,
            "synth_s": synth_s, "eval_predictors": res["eval_predictors"],
            "peak_gib": peak / 2**30, "launches": launches,
            "gallery": len(gallery), "paths": paths}


# ---------------------------------------------------------------- hpo groups

GROUP_ITERS, GROUP_EQ_ITERS = 10, 5


def _gib(peak: dict) -> dict:
    return {k: round(v / 2**30, 2) for k, v in peak.items()}


def _steady_ms(attrs: dict) -> float:
    """A trial's ms/step after its first step (host clock)."""
    return ((attrs["train_s"] - attrs["first_step_s"])
            / max(attrs["steps"] - 1, 1) * 1e3)


def _sweep_over_groups(cfg, paths: dict, with_test: bool, **kw) -> tuple:
    """``run_reference_hpo`` over the hpo phase's synthetic split, with its
    Test split (segm AP) or without (the final loss).  Launch counts and
    the peak memory of the driver's cards are zeroed just before.  → the
    result, the driver's launches and its peak bytes per card."""
    from uwcv_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_superannotate,
    )
    from uwcv_tpu_torch.hpo.study import run_reference_hpo

    # a hung rank fails its collective within two minutes
    cfg.parallel.init_timeout_s = 120
    names = (cfg.data.train_dataset, cfg.data.test_dataset)
    for name in names:
        DatasetCatalog.remove(name)
    torch.cuda.init()              # the allocator's stats need it
    cards = range(torch.cuda.device_count())
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    _zero_launch_counts()
    try:
        if with_test:
            res = run_reference_hpo(cfg, data_dir=paths["Train"], seed=0, **kw)
        else:
            cfg.data.dataset_root = os.path.join(WORK, "nowhere")
            register_superannotate(names[0], paths["Train"],
                                   classes_csv=paths["classes_csv"])
            res = run_reference_hpo(cfg, seed=0, **kw)
    finally:
        for name in names:
            DatasetCatalog.remove(name)
    for i in cards:
        torch.cuda.synchronize(i)
    return res, _launch_counts(), {
        f"cuda:{i}": torch.cuda.max_memory_allocated(i) for i in cards}


def _check_group_sweep(name: str, res: dict, driver: dict, steps: int,
                       eval_batches: int, ranks: int, use_map: bool,
                       depth: int = 50) -> dict:
    """Every trial COMPLETE (segm AP in [0, 1] when scored), ``ranks``
    ranks with bit-identical masters, each rank's launches B1 2, B1-bwd 2,
    B2 1 and the frozen stages' epilogues a step, the driver's B1 2, B2 2,
    the mask tail 1 and a ResNet-``depth`` forward's epilogues an eval
    batch.  Prints each trial's seconds.  → the launches summed over ranks
    and driver."""
    total = dict(driver)
    per_rank = {"roi_align_windows": 2 * steps,
                "roi_align_windows_backward": 2 * steps, "nms_greedy": steps,
                "paste_claim_pack": 0,
                "frozen_bn_act": epilogues(depth, training=True) * steps}
    for t in res["trials"]:
        a = t["user_attrs"]
        if t["state"] != "COMPLETE":
            raise RuntimeError(f"{name}: trial {t['number']} {t['state']}: "
                               f"{a.get('error')}")
        if use_map and not (np.isfinite(t["value"]) and
                            0.0 <= t["value"] <= 1.0):
            raise RuntimeError(f"{name}: trial {t['number']} segm AP "
                               f"{t['value']}")
        reps = a["rank_reports"]
        if a["ranks"] != ranks or len(reps) != ranks or \
                len({r["masters_sha256"] for r in reps}) != 1:
            raise RuntimeError(f"{name}: trial {t['number']}: {a['ranks']} "
                               f"ranks, masters digests "
                               f"{[r['masters_sha256'] for r in reps]}")
        for r in reps:
            if r["launches"] != per_rank:
                raise RuntimeError(f"{name}: rank on {r['device']} launched "
                                   f"{r['launches']}, expected {per_rank}")
            for k, v in r["launches"].items():
                total[k] += v
        log(f"  {name} trial {t['number']} (group {a['group']}: "
            f"{[r['device'] for r in reps]}): "
            + (f"segm AP {t['value']}" if use_map else
               f"final loss {t['value']:.6f}")
            + f"; spawn {a['spawn_s']:.2f} s, set-up {a['setup_s']:.2f} s, "
            f"{a['steps']} steps {a['train_s']:.2f} s "
            f"({a['train_s'] / a['steps'] * 1e3:.1f} ms/step, rank 0's host "
            f"clock; the first step {a['first_step_s']:.2f} s, then "
            f"{_steady_ms(a):.1f} ms/step)"
            + (f", eval {a['eval_s']:.2f} s" if use_map else "")
            + f"; peak per rank "
            f"{[round(r['peak_bytes'] / 2**30, 2) for r in reps]} GiB")
    want = {"roi_align_windows": 2 * eval_batches,
            "roi_align_windows_backward": 0, "nms_greedy": 2 * eval_batches,
            "paste_claim_pack": eval_batches,
            "frozen_bn_act": epilogues(depth) * eval_batches}
    if driver != want:
        raise RuntimeError(f"{name}: the driver launched {driver}, expected "
                           f"{want}")
    return total


def run_hpo_groups(paths: dict) -> dict:
    """[hpo groups] on one card: trials over a group of two devices, each
    trial in two spawned ranks of a process group of its own, scored on
    the driver.

    - one trial at the default config (R50-FPN-256, bf16 compute, f32
      masters, 800×800, batch 2) over ``[cuda:0, cuda:0]`` (two gloo
      ranks), ``GROUP_ITERS`` steps, scored on the 4 test images;
    - the equality of the CPU test on the card: R26/FPN-64 (the gate's
      width) in f32, TF32 off, ``GROUP_EQ_ITERS`` steps without the Test
      split over ``[cuda:0, cuda:0]`` and in one process at the same global
      batch of 2; each step's global loss within 1e-3 relative.

    Every trial COMPLETE, the masters bit-identical across its ranks;
    launches summed over the ranks' reports and the driver's count, each
    zeroed just before: B1 2, B1-bwd 2, B2 1 a step a rank, B1 2 and B2 2
    an eval batch on the driver."""
    from uwcv_tpu_torch.config import Config

    cfg = Config()
    cfg.output_dir = os.path.join(WORK, "hpo_groups_gloo")
    cfg.data.classes_csv = paths["classes_csv"]
    cfg.data.train_dataset = "chip_smoke_groups_train"
    cfg.data.test_dataset = "chip_smoke_groups_test"
    t0 = time.perf_counter()
    res, driver, peak = _sweep_over_groups(
        cfg, paths, True, n_trials=1, max_iter=GROUP_ITERS, n_parallel=1,
        devices=["cuda:0", "cuda:0"])
    wall = time.perf_counter() - t0
    launches = _check_group_sweep("hpo groups gloo", res, driver,
                                  GROUP_ITERS, 1, 2, True)
    log(f"  hpo groups gloo: 1 trial × {GROUP_ITERS} steps over [cuda:0, "
        f"cuda:0] (two ranks share the card: a correctness run, not a rate) "
        f"in {wall:.1f} s; driver peak per card {_gib(peak)} GiB; "
        f"launches {driver} on the driver")
    out = {"gloo": {"trials": res["trials"], "wall_s": wall,
                    "driver_peak_bytes": peak}}

    # the CPU test's equality on the card
    eq = Config()
    m = eq.model
    m.depth, m.fpn_channels, m.box_fc_dim, m.dtype = 26, 64, 256, "float32"
    m.anchor_aspect_ratios = (0.1, 0.5, 1.0, 2.0, 10.0)
    eq.data.classes_csv = paths["classes_csv"]
    eq.data.train_dataset = "chip_smoke_groups_eq"
    eq.data.test_dataset = "chip_smoke_groups_eq_test"
    eq.solver.ims_per_batch = 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {}
        for key, devices in (("two gloo ranks", ["cuda:0", "cuda:0"]),
                             ("one process", ["cuda:0"])):
            c = copy.deepcopy(eq)
            c.output_dir = os.path.join(WORK, "hpo_groups_eq",
                                        key.replace(" ", "_"))
            runs[key] = _sweep_over_groups(c, paths, False, n_trials=1,
                                           max_iter=GROUP_EQ_ITERS,
                                           n_parallel=1, devices=devices)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    two, one = runs["two gloo ranks"], runs["one process"]
    for k, v in _check_group_sweep("hpo groups equality", two[0], two[1],
                                   GROUP_EQ_ITERS, 0, 2, False,
                                   depth=m.depth).items():
        launches[k] += v
    t1 = one[0]["trials"][0]
    want_one = {"roi_align_windows": 2 * GROUP_EQ_ITERS,
                "roi_align_windows_backward": 2 * GROUP_EQ_ITERS,
                "nms_greedy": GROUP_EQ_ITERS, "paste_claim_pack": 0,
                "frozen_bn_act": (epilogues(m.depth, training=True)
                                  * GROUP_EQ_ITERS)}
    if t1["state"] != "COMPLETE" or one[1] != want_one:
        raise RuntimeError(f"hpo groups equality: the one-process trial "
                           f"{t1['state']}, launches {one[1]}")
    for k, v in one[1].items():
        launches[k] += v
    got = np.asarray(two[0]["trials"][0]["user_attrs"]["losses"])
    want = np.asarray(t1["user_attrs"]["losses"])
    rel = np.abs(got - want) / np.abs(want)
    if got.shape != (GROUP_EQ_ITERS,) or not (rel <= 1e-3).all():
        raise RuntimeError(f"hpo groups equality: two ranks' losses {got} "
                           f"vs one process's {want}")
    log(f"  hpo groups equality, R26/FPN-64 f32 (TF32 off), global batch 2, "
        f"{GROUP_EQ_ITERS} steps: two gloo ranks' global losses within "
        f"{rel.max():.2e} rel of one process's ({got.tolist()} vs "
        f"{want.tolist()})")
    out["equality"] = {"worst_loss_rel": float(rel.max()),
                       "losses_two_ranks": got.tolist(),
                       "losses_one_process": want.tolist()}
    out["launches"] = launches
    return out


def run_hpo_groups_over_cards(paths: dict, n_cards: int) -> dict:
    """[hpo groups] over cards: ``cards // 2`` groups of two NCCL ranks,
    two trials each, at the default config, ``GROUP_ITERS`` steps, scored
    on the 4 test images.  The checks of ``run_hpo_groups``, and with two
    groups or more their training intervals must overlap."""
    from uwcv_tpu_torch.config import Config

    g = n_cards // 2
    cfg = Config()
    cfg.output_dir = os.path.join(WORK, "hpo_groups_nccl")
    cfg.data.classes_csv = paths["classes_csv"]
    cfg.data.train_dataset = "chip_smoke_groups_nccl"
    cfg.data.test_dataset = "chip_smoke_groups_nccl_test"
    t0 = time.perf_counter()
    res, driver, peak = _sweep_over_groups(
        cfg, paths, True, n_trials=2 * g, max_iter=GROUP_ITERS, n_parallel=g,
        devices=[f"cuda:{i}" for i in range(2 * g)])
    wall = time.perf_counter() - t0
    launches = _check_group_sweep("hpo groups nccl", res, driver,
                                  GROUP_ITERS, 2 * g, 2, True)
    spans = [(t["user_attrs"]["group"], *t["user_attrs"]["train_span"])
             for t in res["trials"]]
    overlap = any(ga != gb and max(a0, b0) < min(a1, b1)
                  for ga, a0, a1 in spans for gb, b0, b1 in spans)
    if g > 1 and not overlap:
        raise RuntimeError(f"hpo groups nccl: no two groups trained at "
                           f"once: {spans}")
    log(f"  hpo groups nccl: {2 * g} trials × {GROUP_ITERS} steps over {g} "
        f"group(s) of two cards in {wall:.1f} s; training intervals "
        + ("overlap across groups" if g > 1 else "of one group")
        + f"; driver peak per card {_gib(peak)} GiB")
    return {"trials": res["trials"], "wall_s": wall,
            "driver_peak_bytes": peak, "overlap": overlap,
            "launches": launches}


# ---------------------------------------------------------------- export

EXPORT_BATCH, EXPORT_PARTIAL, EXPORT_TIMED = 8, 5, 3
OUT_FIELDS = ("boxes", "scores", "classes", "valid", "masks")


def _instances_arrays(insts, prefix: str) -> dict:
    """Instances → arrays for an ``.npz`` (masks bit-packed)."""
    return {f"{prefix}{k}": np.stack([
        np.packbits(i.masks, axis=-1) if k == "masks" else getattr(i, k)
        for i in insts]) for k in OUT_FIELDS}


def serve_artifact(path: str, inputs: str, out: str) -> None:
    """The child process of the export phase: ``Predictor.from_exported``
    with ``MaskRCNN`` made unbuildable, then a batch of 8, a partial batch
    of 5 and ``EXPORT_TIMED`` timed batches of 8 of the gray images in
    ``inputs``.  Launch counts are zeroed just before those batches and
    read just after.  Writes the first two batches' outputs, the counts
    and the host-clock seconds to ``out``."""
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.models import rcnn
    from uwcv_tpu_torch.utils.trace import recording

    def no_model(*_args, **_kwargs):
        raise RuntimeError("the served predictor built MaskRCNN")

    rcnn.MaskRCNN.__init__ = no_model
    with np.load(inputs) as z:
        images = [np.repeat(im, 3, axis=-1) for im in z["images"]]
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    cuda_init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = Predictor.from_exported(Config(), path)
    load_s = time.perf_counter() - t0
    _zero_launch_counts()
    t0 = time.perf_counter()
    full = served.predict_batch(images)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    partial = served.predict_batch(images[:EXPORT_PARTIAL])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording() as rec:
        for _ in range(EXPORT_TIMED):
            served.predict_batch(images)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    np.savez(out, **_instances_arrays(full, "full_"),
             **_instances_arrays(partial, "partial_"),
             record=json.dumps({
                 "cuda_init_s": cuda_init_s, "load_s": load_s,
                 "first_call_s": first_s,
                 "stages_ms": host_stages(rec, EXPORT_TIMED)[0],
                 "img_per_s": EXPORT_BATCH * EXPORT_TIMED / wall,
                 "batches": 2 + EXPORT_TIMED, "launches": launches,
                 "no_model": served.model is None,
                 "exported_batch": served.exported_batch,
                 "exported_canvas": list(served.exported_canvas)}))


def _cli(*args) -> None:
    """``uwcv-torch ARGS`` in a process of its own; raises when it fails."""
    cmd = [sys.executable, "-m", "uwcv_tpu_torch.cli.main", *args]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}\n"
                           f"{proc.stderr[-4000:]}")


def run_export(dev) -> dict:
    """R50-FPN-256 bf16 with seeded weights (the full-width phase's model)
    exported at batch 8 on the canvas the live predictor stages 1024×1280
    gray images to, then loaded and run in a child process that never
    builds ``MaskRCNN`` (``serve_artifact``).  Its outputs on a batch of 8
    and a partial batch of 5 must equal the live predictor's (valid,
    classes and masks equal; boxes within rtol 1e-5 / atol 1e-4, scores
    rtol 1e-5 / atol 1e-5; the partial batch against the live batch of
    8's first 5, as the artifact runs it padded to 8), and the loaded
    program must launch both kernels twice a batch and the mask tail
    once.  Then the ``export`` verb writes an artifact at
    batch 4 with the staged canvas as the pad canvas, and ``uwcv-torch
    serve --artifact ... --once`` over 4 16-bit TIFFs must write the JSONs
    of a live ``serve --once`` at the same batch and canvas."""
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.checkpoint import save_params_npz
    from uwcv_tpu_torch.engine.export import export_predictor
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.utils.trace import recording

    work = os.path.join(WORK, "export")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = Config()
    cfg.model.roi_score_thresh_test = 0.0
    params = seeded_flax_params(cfg.model, 0)
    live = Predictor(cfg, params, device=dev)
    rng = np.random.default_rng(3)
    gray = rng.integers(0, 256, (EXPORT_BATCH, 1024, 1280, 1), dtype=np.uint8)
    images = [np.repeat(im, 3, axis=-1) for im in gray]
    ops, _ = live.stage_batch(images)
    canvas = tuple(ops[0].shape[1:3])
    if canvas != tuple(ops[3]):
        raise RuntimeError(f"staged canvas {canvas} != model canvas {ops[3]}")
    path = os.path.join(work, "predictor.pt2")
    t0 = time.perf_counter()
    export_predictor(live, path, batch_size=EXPORT_BATCH, canvas=canvas)
    export_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 1e6
    log(f"  exported R50-FPN-256 bf16 at batch {EXPORT_BATCH}, canvas "
        f"{canvas}: {export_s:.1f} s, {mb:.1f} MB")

    full = live.predict_batch(images)
    # the live predictor at batch 5 runs other library kernels (chosen per
    # shape) than at batch 8; the artifact runs a partial batch padded to
    # 8, so the like-for-like reference of its partial batch is the live
    # batch of 8's first 5
    live_partial = live.predict_batch(images[:EXPORT_PARTIAL])
    partial = full[:EXPORT_PARTIAL]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording() as rec:
        for _ in range(EXPORT_TIMED):
            live.predict_batch(images)
    torch.cuda.synchronize()
    live_rate = EXPORT_BATCH * EXPORT_TIMED / (time.perf_counter() - t0)
    live_stages = host_stages(rec, EXPORT_TIMED)[0]
    all_fused(rec, epilogues(50) * EXPORT_TIMED, "export: the live predictor")

    inputs = os.path.join(work, "inputs.npz")
    np.savez(inputs, images=gray)
    out = os.path.join(work, "served.npz")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                           "--serve-artifact", path, inputs, out],
                          capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"serving the artifact failed:\n{proc.stdout}\n"
                           f"{proc.stderr[-4000:]}")
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    rec = json.loads(str(got.pop("record")))
    want = {**_instances_arrays(full, "full_"),
            **_instances_arrays(partial, "partial_")}
    for key, a in want.items():
        b = got[key]
        if key.endswith(("boxes", "scores")):
            atol = 1e-4 if key.endswith("boxes") else 1e-5
            if a.shape != b.shape or not np.allclose(b, a, rtol=1e-5,
                                                     atol=atol):
                raise RuntimeError(f"export: {key} differs from the live "
                                   f"predictor's by up to "
                                   f"{np.abs(b - a).max()}")
        elif not np.array_equal(a, b):
            raise RuntimeError(f"export: {key} differs from the live "
                               f"predictor's")
    same_live = sum(np.array_equal(a.boxes, b.boxes)
                    and np.array_equal(a.masks, b.masks)
                    for a, b in zip(live_partial, partial))
    log(f"  the live predictor's batch of {EXPORT_PARTIAL} equals the first "
        f"{EXPORT_PARTIAL} of its batch of {EXPORT_BATCH} on {same_live} of "
        f"{EXPORT_PARTIAL} images (library kernels chosen per shape)")
    batches = rec["batches"]
    launches = rec["launches"]
    want_launches = {"roi_align_windows": 2 * batches,
                     "roi_align_windows_backward": 0,
                     "nms_greedy": 2 * batches, "paste_claim_pack": batches,
                     "frozen_bn_act": epilogues(50) * batches}
    valid = [int(v.sum()) for v in want["full_valid"]]
    log(f"  served in a child process with no model ({child_s:.1f} s in "
        f"all): CUDA context {rec['cuda_init_s']:.2f} s, then load "
        f"{rec['load_s']:.2f} s, first batch of "
        f"{EXPORT_BATCH} {rec['first_call_s']:.2f} s; batches of "
        f"{EXPORT_BATCH} and {EXPORT_PARTIAL} equal the live predictor's "
        f"(valid detections per image {valid}); launches over {batches} "
        f"batches: {launches}")
    log(f"  img/s over {EXPORT_TIMED} batches of {EXPORT_BATCH} (host "
        f"clock): exported {rec['img_per_s']:.2f}, live {live_rate:.2f}")
    log("  host stages a batch (ms; exported / live): " + json.dumps(
        {k: [round(rec["stages_ms"].get(k, 0.0), 1), round(v, 1)]
         for k, v in live_stages.items()}))
    if launches != want_launches:
        raise RuntimeError(f"export launches {launches}, expected "
                           f"{want_launches} (2, 1 and 49 a batch × "
                           f"{batches})")
    if (not rec["no_model"] or sum(valid) == 0
            or rec["exported_batch"] != EXPORT_BATCH
            or tuple(rec["exported_canvas"]) != canvas):
        raise RuntimeError(f"export: bad served run {rec}")

    # the export and serve verbs: an artifact at the serve batch (4) on the
    # staged canvas as the pad canvas, served against a live server at the
    # same batch and canvas over the same 4 TIFFs
    watch = os.path.join(work, "watch")
    os.makedirs(watch)
    rng = np.random.default_rng(11)
    for i in range(4):
        write_tiff16(os.path.join(watch, f"sem_{i:03d}.tif"),
                     rng.integers(0, 65536, (1024, 1280), dtype=np.uint16))
    weights = save_params_npz(os.path.join(work, "seeded.npz"), params)
    common = ["-o", "model.roi_score_thresh_test=0.0",
              "-o", f"input.pad_size_test={canvas[0]},{canvas[1]}"]
    served_path = os.path.join(work, "serve4.pt2")
    t0 = time.perf_counter()
    _cli("export", "--weights", weights, "--path", served_path,
         "--batch-size", "4", *common)
    cli_export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _cli("serve", "--once", "--artifact", served_path, "--watch-dir", watch,
         "--out-dir", os.path.join(work, "served"), *common)
    serve_s = time.perf_counter() - t0
    _cli("serve", "--once", "--weights", weights, "--watch-dir", watch,
         "--out-dir", os.path.join(work, "live"), *common)
    names = sorted(os.listdir(os.path.join(work, "live")))
    instances = []
    for name in names:
        with open(os.path.join(work, "served", name)) as f:
            a = json.load(f)
        with open(os.path.join(work, "live", name)) as f:
            b = json.load(f)
        if a != b:
            raise RuntimeError(f"serve --artifact: {name} differs from the "
                               f"live server's")
        instances.append(a["num_instances"])
    if len(names) != 4 or sorted(os.listdir(os.path.join(work, "served"))) \
            != names:
        raise RuntimeError(f"serve: answers {names}")
    log(f"  export verb at batch 4 ({cli_export_s:.1f} s, process "
        f"included), then serve --artifact --once over 4 TIFFs "
        f"({serve_s:.1f} s, process included) wrote the live server's "
        f"JSONs; instances {instances}")
    return {"export_s": export_s, "artifact_mb": mb,
            "cuda_init_s": rec["cuda_init_s"], "load_s": rec["load_s"],
            "stages_ms": rec["stages_ms"], "live_stages_ms": live_stages,
            "first_call_s": rec["first_call_s"],
            "img_per_s": rec["img_per_s"], "live_img_per_s": live_rate,
            "canvas": list(canvas), "valid_per_image": valid,
            "live_partial_equal": same_live,
            "cli_export_s": cli_export_s, "serve_s": serve_s,
            "serve_instances": instances,
            "launches": launches}


# ---------------------------------------------------------------- data parallel

# full-width data-parallel training: (global batch per rank, warm-up, timed)
DP_SHARED = (1, 2, 8)        # two gloo ranks sharing one card: 10 steps
DP_CARDS = (2, 2, 20)        # one NCCL rank per card
MESH_BATCH, MESH_FOLDER_BATCH = 8, 5


def dp_golden(dev, out_dir: str, loss_rtol: float = 1e-3,
              norm_rtol: float = 1e-3, mesh_shape=(-1, 1)) -> dict:
    """One rank of the data-parallel train golden: the gate checkpoint in
    f32 (TF32 off) over a ``mesh_shape`` (d, m) mesh of the ranks, data
    row i training on image i of the golden's two (with its rows of the
    sampler draws) for the golden's 3 SGD steps, its m ranks each running
    the trunk on its rows of it.  The all-reduced losses of each step must
    lie within ``loss_rtol`` of the JAX package's global-batch values and
    the step-0 norms of the global gradients
    (``Trainer.global_gradients``) within ``norm_rtol``.  Launch counts
    are zeroed just before the steps.  → losses' and norms' worst relative
    errors, launches and a digest of the masters."""
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.engine.trainer import Trainer, step_generator
    from uwcv_tpu_torch.parallel.mesh import masters_digest
    from uwcv_tpu_torch.weights import flax_leaf_names, load_npz

    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    with np.load(TRAIN_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    cfg = Config.from_dict(json.loads(str(g["config_json"])))
    cfg.output_dir = os.path.join(out_dir, "golden")
    cfg.parallel.mesh_shape = tuple(mesh_shape)
    trainer = Trainer(cfg, device=dev)
    if trainer.group is None or trainer.device != dev:
        raise RuntimeError(f"dp golden: no process group, or the trainer "
                           f"is on {trainer.device}, not {dev}")
    trainer.load_params(load_npz(GATE_CKPT))
    b = len(g["image"]) // trainer.ranks
    rows = slice(trainer.rank * b, (trainer.rank + 1) * b)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev)
    batch = {k: put(g[k]) for k in ("image", "boxes", "classes", "valid",
                                    "masks_packed")}
    steps = sorted({int(k[4:].split("_")[0]) for k in g if k.startswith("step")})
    worst_loss, worst_norm, losses = 0.0, 0.0, []
    _zero_launch_counts()
    for step in steps:
        draws = {k: put(g[f"step{step}_{k}"])
                 for k in ("rpn_pos", "rpn_neg", "roi_pos", "roi_neg")}
        m = trainer.global_metrics(trainer.train_step(
            batch, step_generator(cfg.solver.seed, step, dev),
            sampler_draws=draws))
        got = np.asarray([m[k] for k in LOSS_KEYS + ("total_loss",)])
        losses.append(got.tolist())
        want = g[f"step{step}_losses"]
        rel = np.abs(got - want) / np.abs(want)
        worst_loss = max(worst_loss, float(rel.max()))
        if not (rel <= loss_rtol).all():
            raise RuntimeError(f"dp golden rank {trainer.group.rank} step "
                               f"{step}: losses {got} vs JAX {want}")
        if step == 0:
            names = flax_leaf_names(trainer.compute)
            grads = trainer.global_gradients()
            for k, want_n in zip(g["grad_norm_keys"], g["grad_norms"]):
                grad = grads[names[k]]
                r = abs(float(grad.norm()) - want_n) / max(want_n, 1e-12)
                worst_norm = max(worst_norm, r)
                if r > norm_rtol:
                    raise RuntimeError(f"dp golden: |summed grad| of {k} "
                                       f"{float(grad.norm())} vs JAX {want_n}")
    if cuda:
        torch.backends.cudnn.allow_tf32 = True
    return {"steps": len(steps), "worst_loss_rel": worst_loss,
            "worst_grad_norm_rel": worst_norm, "losses": losses,
            "leaves": int(len(g["grad_norm_keys"])),
            "launches": _launch_counts(),
            "masters_sha256": masters_digest(trainer.model)}


def dp_train(dev, out_dir: str, per_rank: int, warmup: int,
             timed: int, mesh_shape=(-1, 1)) -> dict:
    """One rank of full-width data-parallel training: the default
    ``Config()`` (R50-FPN-256, bf16 compute, f32 masters, 800×800) from
    seeded weights over the 12 gate-split images staged on the rank's
    device, over a ``mesh_shape`` (d, m) mesh of the ranks at a global
    batch of ``per_rank`` × d (a data row's m ranks split its images'
    height), through ``Trainer.fit`` (``warmup`` steps, then ``timed``
    with CUDA events around each phase of a step, the gradient all-reduce
    included, and around each halo exchange and level gather of a model
    axis).  Launch counts are zeroed just before and read just after and
    must be B1 2 a step, B1-bwd 2 and B2 1; every master must be
    finite."""
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.data.classes import ClassRegistry
    from uwcv_tpu_torch.data.loader import TrainLoader
    from uwcv_tpu_torch.data.superannotate import get_superannotate_dicts
    from uwcv_tpu_torch.engine.trainer import Trainer
    from uwcv_tpu_torch.parallel.mesh import masters_digest
    from uwcv_tpu_torch.utils.trace import recording

    cfg = Config()
    cfg.output_dir = os.path.join(out_dir, "train")
    cfg.solver.checkpoint_period = 0
    cfg.parallel.mesh_shape = tuple(mesh_shape)
    cfg.solver.ims_per_batch = per_rank * (
        torch.distributed.get_world_size() // max(mesh_shape[1], 1))
    registry = ClassRegistry.load(os.path.join(GATE_SPLIT, "classes.csv"))
    dicts = get_superannotate_dicts(os.path.join(GATE_SPLIT, "Test"),
                                    registry=registry)
    trainer = Trainer(cfg, device=dev)
    rank = trainer.group.rank if trainer.group else 0
    if trainer.group is None or trainer.device != dev:
        raise RuntimeError(f"dp train: no process group, or the trainer is "
                           f"on {trainer.device}, not {dev}")
    cfg = trainer.cfg
    trainer.load_params(seeded_flax_params(cfg.model, 0))
    loader = TrainLoader(dicts, cfg, seed=cfg.solver.seed,
                         process_index=trainer.rank,
                         process_count=trainer.ranks)
    dd = loader.device_dataset(dev)
    if dd is None:
        raise RuntimeError("the gate split does not fit the device budget")
    batches = loader.index_batches()
    fit = lambda n: trainer.fit(batches, max_iter=trainer.step + n,
                                log_fn=lambda *_: None, device_dataset=dd)
    cuda = dev.type == "cuda"
    sync = lambda: torch.cuda.synchronize(dev) if cuda else None
    axis = trainer.model_axis
    _zero_launch_counts()
    fit(warmup)
    trainer.marks = [] if cuda else None
    sync()
    t0 = time.perf_counter()
    with recording() as rec:
        fit(timed)
    sync()
    wall = time.perf_counter() - t0
    marks, trainer.marks = trainer.marks or [], None
    launches = _launch_counts()
    n = warmup + timed
    want = {"roi_align_windows": 2 * n, "roi_align_windows_backward": 2 * n,
            "nms_greedy": n, "paste_claim_pack": 0,
            "frozen_bn_act": epilogues(50, training=True) * n}
    if launches != want:
        raise RuntimeError(f"dp train rank {rank}: launches "
                           f"{launches}, expected {want}")
    if not all(torch.isfinite(p).all() for p in trainer.model.parameters()):
        raise RuntimeError(f"dp train rank {rank}: a master weight is "
                           f"not finite")
    split, prev = {}, None
    for name, ev in marks:
        if prev is not None and name != "start":
            split[name] = split.get(name, 0.0) + prev.elapsed_time(ev) / timed
        prev = ev
    # the halo swaps' and level gathers' CUDA events (none on the CPU)
    for name, ms in rec.device_ms().items():
        if name in ("halo", "gather"):
            split[f"model axis {name}"] = ms / timed
    rec = {"launches": launches, "steps": n, "timed": timed,
           "global_batch": cfg.solver.ims_per_batch, "wall_s": wall,
           "mesh_shape": [trainer.ranks, axis.size if axis else 1],
           "split_ms": split, "masters_sha256": masters_digest(trainer.model),
           "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                        if cuda else 0.0)}
    if trainer.is_writer:
        with open(os.path.join(cfg.output_dir, "metrics.json")) as f:
            metrics = [json.loads(line) for line in f]
        losses = [m[k] for m in metrics for k in LOSS_KEYS + ("total_loss",)]
        if metrics[-1]["iteration"] != n or not np.isfinite(losses).all():
            raise RuntimeError(f"dp train: logged {metrics}")
        rec["ms_per_step"] = metrics[-1]["time_per_iter"] * 1e3
        rec["total_loss_first_last"] = [metrics[0]["total_loss"],
                                        metrics[-1]["total_loss"]]
    return rec


def dp_rank(rank: int, world: int, init: str, backend: str, device: str,
            phases: tuple, out_dir: str, train_shape: tuple,
            mesh_shape: tuple) -> None:
    """A rank of ``run_ranks``: joins the group on its device (the CPU,
    ``cuda:rank`` under NCCL, ``cuda:0`` for gloo ranks sharing one card),
    runs ``phases`` over a ``mesh_shape`` mesh of the ranks and writes
    their records to ``rank<r>.json``."""
    from uwcv_tpu_torch.config import ParallelConfig
    from uwcv_tpu_torch.parallel.mesh import initialize_multi_host

    if device == "cpu":
        torch.set_num_threads(2)
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
    initialize_multi_host(ParallelConfig(
        multi_host=True, coordinator_address=init, num_processes=world,
        process_id=rank, init_timeout_s=300), dev, backend=backend)
    try:
        rec = {"device": str(dev), "backend": backend}
        if "golden" in phases:
            rec["golden"] = dp_golden(dev, out_dir, mesh_shape=mesh_shape)
        if "train" in phases:
            rec["train"] = dp_train(dev, out_dir, *train_shape,
                                    mesh_shape=mesh_shape)
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def run_ranks(world: int, backend: str, device: str, phases: tuple,
              out_dir: str, timeout: float, train_shape: tuple = DP_SHARED,
              mesh_shape: tuple = (-1, 1)) -> list:
    """``world`` processes of ``dp_rank`` (spawned, a ``file://``
    rendezvous under ``out_dir``) over a ``mesh_shape`` (d, m) mesh,
    joined within ``timeout`` seconds: a rank that fails or hangs fails
    the call, and every rank is stopped.  → each rank's record, in rank
    order; the masters must be bit-identical across ranks after every
    phase."""
    from uwcv_tpu_torch.parallel.mesh import spawn_ranks

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    init = "file://" + os.path.join(out_dir, "rendezvous")
    spawn_ranks(dp_rank, world, args=(world, init, backend, device,
                                      tuple(phases), out_dir,
                                      tuple(train_shape), tuple(mesh_shape)),
                timeout=timeout)
    recs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    for phase in phases:
        digests = {rec[phase]["masters_sha256"] for rec in recs}
        if len(digests) != 1:
            raise RuntimeError(f"{phase}: the ranks' masters differ")
    return recs


def _topology(n: int) -> str:
    """What the card's machine says of the links between the first ``n``
    cards: ``nvidia-smi topo -m`` and ``nvlink --status`` (a machine may
    refuse either) and CUDA peer access between each pair."""
    out = []
    for cmd in (["nvidia-smi", "topo", "-m"],
                ["nvidia-smi", "nvlink", "--status", "-i", "0"]):
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60)
        text = (proc.stdout + proc.stderr).strip().splitlines()
        out.append(f"  $ {' '.join(cmd)} (exit {proc.returncode}): "
                   + " | ".join(line.strip() for line in text[:n + 20]))
    peer = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
            for i in range(n) for j in range(n) if i != j}
    out.append(f"  CUDA peer access: {peer}")
    return "\n".join(out)


def run_data_parallel(n_cards: int) -> dict:
    """[dp golden] and [dp train]: two gloo ranks on ``cuda:0`` (the
    golden, and on one card the full-width training at global batch 2,
    10 steps: two ranks share the card, a correctness run, not a rate);
    with two or more cards also two NCCL ranks on ``cuda:0`` and
    ``cuda:1`` for the golden and one NCCL rank per card for the
    full-width training at global batch 2 × cards, 2 + 20 steps."""
    work = os.path.join(WORK, "dp")
    out = {"golden": {}, "train": {}}
    phases = ("golden", "train") if n_cards == 1 else ("golden",)
    recs = run_ranks(2, "gloo", "cuda", phases, os.path.join(work, "gloo"),
                     timeout=600)
    out["golden"]["gloo, 2 ranks on cuda:0"] = recs
    if n_cards == 1:
        out["train"]["gloo, 2 ranks share cuda:0"] = recs
        log("  [dp] one card: the NCCL runs (cuda:0 + cuda:1; one rank per "
            "card) need two cards and are skipped")
    else:
        log("  links between the cards used:\n" + _topology(n_cards))
        out["golden"]["nccl, cuda:0 + cuda:1"] = run_ranks(
            2, "nccl", "cuda", ("golden",), os.path.join(work, "nccl2"),
            timeout=600)
        out["train"][f"nccl, {n_cards} ranks, one a card"] = run_ranks(
            n_cards, "nccl", "cuda", ("train",),
            os.path.join(work, f"nccl{n_cards}"), timeout=900,
            train_shape=DP_CARDS)
    for name, recs in out["golden"].items():
        g = [r["golden"] for r in recs]
        log(f"  dp golden ({name}): {g[0]['steps']} SGD steps, all-reduced "
            f"losses within {max(x['worst_loss_rel'] for x in g):.2e} rel "
            f"of JAX's global batch, {g[0]['leaves']} step-0 summed "
            f"gradient norms within "
            f"{max(x['worst_grad_norm_rel'] for x in g):.2e}; masters "
            f"bit-identical across ranks; launches per rank "
            f"{[x['launches'] for x in g]}")
    for name, recs in out["train"].items():
        t = [r["train"] for r in recs]
        ms = t[0]["ms_per_step"]
        red = t[0]["split_ms"].get("gradient all-reduce", 0.0)
        shared = name.startswith("gloo")
        log(f"  dp train full width R50-FPN-256 bf16 ({name}): global batch "
            f"{t[0]['global_batch']}, {ms:.1f} ms/step, "
            f"{t[0]['global_batch'] * 1e3 / ms:.2f} img/s "
            + ("(two ranks share one card: a correctness run, not a rate) "
               if shared else "")
            + f"over {t[0]['timed']} steps after "
            f"{t[0]['steps'] - t[0]['timed']} warm-up"
            f" (rank 0's host clock, Trainer's time_per_iter); gradient "
            f"all-reduce {red:.2f} ms/step on rank 0 ({red / ms:.1%} of a "
            f"step, CUDA events around it: the wait for the slowest rank "
            f"included); masters bit-identical; total loss "
            f"{t[0]['total_loss_first_last']}; launches per rank "
            f"{[x['launches'] for x in t]}; peak "
            f"{max(x['peak_gib'] for x in t):.2f} GiB")
        log("  dp train step split, rank 0 (CUDA events, ms/step): "
            + json.dumps({k: round(v, 3) for k, v in t[0]["split_ms"].items()}))
    return out


def _dp_launches(recs: dict, phase: str) -> dict:
    """Launch counts summed over every rank of every run of ``phase``."""
    total = {}
    for runs in recs[phase].values():
        for rec in runs:
            for k, v in rec[phase]["launches"].items():
                total[k] = total.get(k, 0) + v
    return total


def run_mesh_predict(devices: list) -> dict:
    """[mesh predict]: the full-width model (R50-FPN-256 bf16, seeded)
    over a mesh of ``devices`` (``[cuda:0, cuda:0]`` on one card, every
    card otherwise).  A batch of 8 against the single-device predictor on
    each device's slice (valid, classes and packed masks equal; boxes and
    scores bit-equal, else within the export phase's tolerances, said
    which); then ``run_batch_inference`` over 16 TIFFs as the folder
    phase's (``write_folder_tiffs``) at batch 5 (16 = 3 × 5 + 1: every chunk is
    padded to a multiple of the data axis, the tail most).  Launch counts
    are zeroed just before each mesh run: B1 and B2 2 a batch, the mask
    tail 1 and the trunk's epilogues 49 on each device."""
    from uwcv_tpu_torch.config import Config, ParallelConfig
    from uwcv_tpu_torch.engine.batch_inference import run_batch_inference
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.parallel.mesh import batch_sharding, build_mesh

    mesh = build_mesh(ParallelConfig(), devices=devices)
    sync = lambda: [torch.cuda.synchronize(dev) for dev in mesh.devices[:, 0]
                    if dev.type == "cuda"]
    d = len(devices)
    cfg = Config()
    cfg.model.roi_score_thresh_test = 0.0
    cfg.output_dir = os.path.join(WORK, "mesh_out")
    params = seeded_flax_params(cfg.model, 0)
    pred = Predictor(cfg, params, mesh=mesh)
    single = Predictor(cfg, params, device=devices[0])
    rng = np.random.default_rng(3)
    images = [np.repeat(rng.integers(0, 256, (1024, 1280, 1), dtype=np.uint8),
                        3, axis=-1) for _ in range(MESH_BATCH)]
    pred.predict_batch(images)                  # warm-up
    sync()
    _zero_launch_counts()
    t0 = time.perf_counter()
    got = pred.predict_batch(images)
    sync()
    batch_s = time.perf_counter() - t0
    launches = _launch_counts()
    want_l = {"roi_align_windows": 2 * d, "roi_align_windows_backward": 0,
              "nms_greedy": 2 * d, "paste_claim_pack": d,
              "frozen_bn_act": epilogues(50) * d}
    if launches != want_l:
        raise RuntimeError(f"mesh predict launches {launches}, expected "
                           f"{want_l}")
    want = [i for s in batch_sharding(mesh, MESH_BATCH)
            for i in single.predict_batch(images[s])]
    exact = True
    for k in OUT_FIELDS:
        a = np.stack([getattr(i, k) for i in want])
        b = np.stack([getattr(i, k) for i in got])
        if k in ("boxes", "scores"):
            if a.shape == b.shape and np.array_equal(a, b):
                continue
            exact = False
            atol = 1e-4 if k == "boxes" else 1e-5
            if a.shape != b.shape or not np.allclose(b, a, rtol=1e-5,
                                                     atol=atol):
                raise RuntimeError(f"mesh predict: {k} differs from the "
                                   f"single device's by up to "
                                   f"{np.abs(b - a).max()}")
        elif not np.array_equal(a, b):
            raise RuntimeError(f"mesh predict: {k} differs from the single "
                               f"device's")
    log(f"  mesh predict, R50-FPN-256 bf16 over {devices}, batch "
        f"{MESH_BATCH}: valid, classes and masks equal to the single-device "
        f"predictor's on each slice of {MESH_BATCH // d}; boxes and scores "
        + ("bit-equal" if exact else "within rtol 1e-5 / atol 1e-4 (boxes), "
           "1e-5 (scores), not bit-equal")
        + f"; {batch_s * 1e3:.1f} ms for the batch; launches {launches}")
    n_images = 16
    image_dir = write_folder_tiffs(os.path.join(WORK, "mesh_tiff"), n_images)
    _zero_launch_counts()
    t0 = time.perf_counter()
    result = run_batch_inference(cfg, pred, image_dir=image_dir,
                                 batch_size=MESH_FOLDER_BATCH,
                                 with_measurements=True, with_plots=False,
                                 progress=lambda *_: None)
    sync()
    wall = time.perf_counter() - t0
    folder_launches = _launch_counts()
    chunks = -(-n_images // MESH_FOLDER_BATCH)
    want_f = {"roi_align_windows": 2 * chunks * d,
              "roi_align_windows_backward": 0, "nms_greedy": 2 * chunks * d,
              "paste_claim_pack": chunks * d,
              "frozen_bn_act": epilogues(50) * chunks * d}
    if folder_launches != want_f:
        raise RuntimeError(f"mesh folder launches {folder_launches}, "
                           f"expected {want_f}")
    if result["num_images"] != n_images or \
            len(result["predictions"]) != n_images:
        raise RuntimeError(f"mesh folder: {len(result['predictions'])} of "
                           f"{n_images} images predicted")
    rows = check_rows_decode(result)
    sizes = [min(MESH_FOLDER_BATCH, n_images - s)
             for s in range(0, n_images, MESH_FOLDER_BATCH)]
    log(f"  mesh folder: {n_images} TIFFs at batch {MESH_FOLDER_BATCH} "
        f"(chunks {sizes}, each padded to a multiple of {d}): "
        f"{n_images / wall:.3f} img/s (host clock over the call), {rows} "
        f"RLE rows decode to their masks; launches {folder_launches}")
    total = {k: launches[k] + folder_launches[k] for k in launches}
    return {"devices": devices, "bit_equal": exact, "batch_ms": batch_s * 1e3,
            "folder_img_per_s": n_images / wall, "rows": rows,
            "launches": total}


# ---------------------------------------------------------------- model axis

# full-width training over a model axis: (images per data row, warm-up,
# timed)
SP_SHARED = (2, 2, 8)        # (1, 2): two gloo ranks sharing one card
SP_CARDS = (2, 2, 20)        # (cards // 2, 2): one NCCL rank per card
SP_BATCH = 4                 # sp predict's batch of 1024×1280 images
GIANT = (4096, 5120)         # one large micrograph, batch 1


def run_model_axis(n_cards: int, dp: dict) -> dict:
    """[sp golden] and [sp train]: the train golden over a (1, 2) mesh of
    two gloo ranks on ``cuda:0`` (and, with two or more cards, of two NCCL
    ranks on ``cuda:0`` and ``cuda:1``), each rank running the trunk on
    half of each image's rows; then the default training side (R50-FPN-256
    bf16, 800×800, 2 images a data row) over (1, 2) on one card (two gloo
    ranks sharing it: a check, not a rate) or (cards // 2, 2) with one
    NCCL rank a card, beside (cards // 2, 1) at the same images a data row,
    its peak memory a rank beside those runs' and the [dp train] run's
    (``dp``).  ``run_ranks`` fails on unequal masters; the halo and gather
    spans are CUDA events around each exchange."""
    work = os.path.join(WORK, "sp")
    out = {"golden": {}, "train": {}}
    phases = ("golden", "train") if n_cards == 1 else ("golden",)
    recs = run_ranks(2, "gloo", "cuda", phases, os.path.join(work, "gloo"),
                     timeout=600, train_shape=SP_SHARED, mesh_shape=(1, 2))
    out["golden"]["gloo, (1, 2) on cuda:0"] = recs
    if n_cards == 1:
        out["train"]["gloo, (1, 2) shares cuda:0"] = recs
        log("  [sp] one card: the NCCL runs ((1, 2) over cuda:0 + cuda:1; "
            "(cards // 2, 2)) need two cards and are skipped")
    else:
        out["golden"]["nccl, (1, 2) over cuda:0 + cuda:1"] = run_ranks(
            2, "nccl", "cuda", ("golden",), os.path.join(work, "nccl2"),
            timeout=600, mesh_shape=(1, 2))
        d = n_cards // 2
        out["train"][f"nccl, ({d}, 2), one rank a card"] = run_ranks(
            2 * d, "nccl", "cuda", ("train",),
            os.path.join(work, f"nccl{2 * d}"), timeout=900,
            train_shape=SP_CARDS, mesh_shape=(d, 2))
        ref = run_ranks(d, "nccl", "cuda", ("train",),
                        os.path.join(work, f"nccl{d}x1"), timeout=900,
                        train_shape=SP_CARDS, mesh_shape=(d, 1))
        out["reference"] = ref
        dp = {"train": dict(dp["train"], **{
            f"nccl, ({d}, 1), the same images a data row": ref})}
        t = ref[0]["train"]
        log(f"  ({d}, 1) reference, R50-FPN-256 bf16, NCCL: global batch "
            f"{t['global_batch']}, {t['ms_per_step']:.1f} ms/step over "
            f"{t['timed']} steps; step split, rank 0 (CUDA events, "
            f"ms/step): " + json.dumps({k: round(v, 3) for k, v in
                                        t["split_ms"].items()}))
    for name, recs in out["golden"].items():
        g = [r["golden"] for r in recs]
        log(f"  sp golden ({name}): {g[0]['steps']} SGD steps, losses "
            f"within {max(x['worst_loss_rel'] for x in g):.2e} rel of JAX's "
            f"global batch, {g[0]['leaves']} step-0 global gradient norms "
            f"within {max(x['worst_grad_norm_rel'] for x in g):.2e}; "
            f"masters bit-identical across ranks; launches per rank "
            f"{[x['launches'] for x in g]}")
    dp_peak = {name: max(r["train"]["peak_gib"] for r in recs)
               for name, recs in dp["train"].items()}
    for name, recs in out["train"].items():
        t = [r["train"] for r in recs]
        ms = t[0]["ms_per_step"]
        split = t[0]["split_ms"]
        log(f"  sp train full width R50-FPN-256 bf16 ({name}): mesh "
            f"{tuple(t[0]['mesh_shape'])}, global batch "
            f"{t[0]['global_batch']}, {ms:.1f} ms/step"
            + (" (two ranks share one card: a check, not a rate)"
               if name.startswith("gloo") else "")
            + f" over {t[0]['timed']} steps after "
            f"{t[0]['steps'] - t[0]['timed']} warm-up (rank 0's host "
            f"clock); halo {split.get('model axis halo', 0.0):.2f} and "
            f"gather {split.get('model axis gather', 0.0):.2f} ms/step on "
            f"rank 0 (CUDA events around each exchange); masters "
            f"bit-identical; total loss {t[0]['total_loss_first_last']}; "
            f"launches per rank {[x['launches'] for x in t]}; peak per rank "
            f"{[round(x['peak_gib'], 2) for x in t]} GiB, beside [dp train] "
            + json.dumps({k: round(v, 2) for k, v in dp_peak.items()}))
        log("  sp train step split, rank 0 (CUDA events, ms/step): "
            + json.dumps({k: round(v, 3) for k, v in split.items()}))
    return out


def _compare_golden_limits(got, want, what: str) -> dict:
    """``got`` against ``want`` (lists of Instances) at the gate golden's
    limits (PERF.md §2): valid counts and classes equal, boxes within 1e-2
    px, scores within 1e-4, mask IoU ≥ 0.99.  → the worst of each."""
    worst = {"box": 0.0, "score": 0.0, "iou": 1.0, "instances": 0}
    for i, (a, b) in enumerate(zip(got, want)):
        if a.valid.sum() != b.valid.sum() or not np.array_equal(
                a.classes[a.valid], b.classes[b.valid]):
            raise RuntimeError(f"{what} image {i}: {a.valid.sum()} valid vs "
                               f"{b.valid.sum()}, or other classes")
        va, vb = a.valid, b.valid
        worst["box"] = max(worst["box"], float(np.abs(
            a.boxes[va] - b.boxes[vb]).max(initial=0.0)))
        worst["score"] = max(worst["score"], float(np.abs(
            a.scores[va] - b.scores[vb]).max(initial=0.0)))
        for ma, mb in zip(a.masks[va], b.masks[vb]):
            worst["iou"] = min(worst["iou"], _mask_iou(ma, mb))
        worst["instances"] += int(va.sum())
    if worst["box"] > 1e-2 or worst["score"] > 1e-4 or worst["iou"] < 0.99:
        raise RuntimeError(f"{what}: beyond the golden limits: {worst}")
    return worst


def run_sp_predict(cards: list) -> dict:
    """[sp predict]: the full-width model (R50-FPN-256, seeded) in f32
    with TF32 off over a (1, 2) mesh of ``cards[0]`` twice against the
    one-device predictor on a batch of ``SP_BATCH`` gray 1024×1280 images,
    at the gate golden's limits; then one seeded ``GIANT`` micrograph at
    the default config (bf16; the test size raised to the image) on (1, 1)
    and, with two or more ``cards``, (1, cards): peak memory a card, batch
    ms, and the mesh's outputs beside the one card's (not gated: bf16 and
    cuDNN's per-shape algorithms round differently).  Launch counts are
    zeroed just before each mesh batch: B1 and B2 2 a batch and the mask
    tail 1 on the row's first device, the trunk's epilogues 49 a part."""
    from uwcv_tpu_torch.config import Config, ParallelConfig
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.parallel.mesh import build_mesh

    launches = {}
    rec = {}
    cuda = torch.device(cards[0]).type == "cuda"

    def mesh_batch(pred, images, what):
        m = pred.mesh.devices.shape[1]
        want_l = {"roi_align_windows": 2, "roi_align_windows_backward": 0,
                  "nms_greedy": 2, "paste_claim_pack": 1,
                  "frozen_bn_act": epilogues(50) * m}
        pred.predict_batch(images)                      # warm-up
        for dev in set(pred.mesh.devices.flat) if cuda else ():
            torch.cuda.synchronize(dev)
        _zero_launch_counts()
        t0 = time.perf_counter()
        got = pred.predict_batch(images)
        ms = (time.perf_counter() - t0) * 1e3
        counts = _launch_counts()
        if counts != want_l:
            raise RuntimeError(f"{what}: launches {counts}, expected "
                               f"{want_l}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return got, ms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config()
    cfg.model.dtype = "float32"
    cfg.model.roi_score_thresh_test = 0.0
    params = seeded_flax_params(cfg.model, 0)
    rng = np.random.default_rng(5)
    images = [np.repeat(rng.integers(0, 256, (1024, 1280, 1),
                                     dtype=np.uint8), 3, axis=-1)
              for _ in range(SP_BATCH)]
    want = Predictor(cfg, params, device=cards[0]).predict_batch(images)
    pair = [cards[0], cards[0]]
    pred = Predictor(cfg, params, mesh=build_mesh(
        ParallelConfig(mesh_shape=(1, 2)), pair))
    got, ms = mesh_batch(pred, images, "sp predict (1, 2)")
    rec["f32 (1, 2) vs one device"] = dict(
        _compare_golden_limits(got, want, "sp predict (1, 2)"), batch_ms=ms)
    del pred
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    log(f"  sp predict R50-FPN-256 f32 (TF32 off), batch {SP_BATCH} of "
        f"1024×1280 over (1, 2) {pair} vs one device: "
        + json.dumps(rec["f32 (1, 2) vs one device"]))

    cfg = Config()
    cfg.model.roi_score_thresh_test = 0.0
    cfg.input.pad_size_test = GIANT
    cfg.input.test_short_edge, cfg.input.test_max_size = GIANT
    params = seeded_flax_params(cfg.model, 0)
    giant = [np.repeat(np.random.default_rng(7).integers(
        0, 256, GIANT + (1,), dtype=np.uint8), 3, axis=-1)]
    base = None
    for devices in [cards[:1]] + ([cards] if len(cards) > 1 else []):
        for dev in devices if cuda else ():
            torch.cuda.reset_peak_memory_stats(dev)
        pred = Predictor(cfg, params, mesh=build_mesh(
            ParallelConfig(mesh_shape=(1, len(devices))), devices))
        what = f"sp predict {GIANT[0]}×{GIANT[1]} (1, {len(devices)})"
        (inst,), ms = mesh_batch(pred, giant, what)
        if not (np.isfinite(inst.boxes).all()
                and np.isfinite(inst.scores).all() and inst.valid.any()):
            raise RuntimeError(f"{what}: non-finite or no detections")
        r = {"devices": devices, "batch_ms": ms, "valid": int(
            inst.valid.sum()), "peak_gib_per_card": [
                round(torch.cuda.max_memory_allocated(d) / 2**30, 3)
                for d in sorted(set(devices))] if cuda else None}
        if base is None:
            base = inst
        else:
            n = int(min(inst.valid.sum(), base.valid.sum()))
            r["vs (1, 1)"] = {
                "valid": [int(inst.valid.sum()), int(base.valid.sum())],
                "max_score_diff": float(np.abs(
                    inst.scores[:n] - base.scores[:n]).max(initial=0.0)),
                "classes_equal": bool(np.array_equal(
                    inst.classes[:n], base.classes[:n]))}
        rec[f"giant (1, {len(devices)})"] = r
        log(f"  {what}, R50-FPN-256 bf16: " + json.dumps(r))
        del pred
    rec["launches"] = launches
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", metavar="DIR",
                    help="also time the kernel wrappers of the "
                         "uwcv_tpu_torch package under DIR against these")
    # the child process of --against: PKG INPUTS OUT
    ap.add_argument("--time-wrappers", nargs=3, help=argparse.SUPPRESS)
    ap.add_argument("--times-only", action="store_true",
                    help=argparse.SUPPRESS)
    # the child process of the export phase: ARTIFACT INPUTS OUT
    ap.add_argument("--serve-artifact", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.time_wrappers:
        pkg, inputs, out = args.time_wrappers
        sys.path.insert(0, pkg)
        time_wrappers(inputs, out, outputs=not args.times_only)
        return 0
    if args.serve_artifact:
        sys.path.insert(0, REPO)
        serve_artifact(*args.serve_artifact)
        return 0
    sys.path.insert(0, REPO)
    from uwcv_tpu_torch import kernels

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    info = kernels.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s: " + ", ".join(
        f"{k} {v['seconds']:.1f} s" for k, v in info.items()))
    for name, v in info.items():
        for line in v["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("[kernels] against their plain versions")
    roi_timed, roi_cases, roi_args = check_roi_align(dev)
    bwd_timed, bwd_cases, bwd_args = check_roi_align_backward(dev)
    nms_rec, nms_calls = check_nms(dev)
    tail_rec = check_mask_tail(dev)
    frozen_bn_rec = check_frozen_bn(dev)

    log("[golden] gate checkpoint vs committed JAX outputs")
    check_gate_golden(dev)

    log("[full width] main path")
    launches = run_full_width(dev)

    log("[folder] full width through run_batch_inference")
    folder = run_folder_full_width(dev)

    log("[folder golden] gate checkpoint over the gate PNGs vs the JAX CSVs")
    folder_golden = check_folder_golden(dev)

    log("[eval] gate split through evaluate_split")
    gate_eval = check_eval(dev)

    log("[train golden] gate checkpoint, 3 SGD steps vs committed JAX values")
    train_golden = check_train_golden(dev)

    log("[train] full width through Trainer.fit")
    train = run_train_full_width(dev)

    log("[pth import] R101-FPN from a Detectron2-named .pth")
    pth = run_pth_import(dev)

    log("[hpo] synth, then run_reference_hpo at the default config")
    hpo = run_hpo(dev)

    log("[export] full width: export, serve from the artifact")
    export = run_export(dev)

    n_cards = torch.cuda.device_count()
    log(f"[dp golden] + [dp train] data-parallel training over processes "
        f"({n_cards} card{'s' if n_cards > 1 else ''})")
    t0 = time.perf_counter()
    dp = run_data_parallel(n_cards)
    log(f"  [dp golden] + [dp train]: {time.perf_counter() - t0:.1f} s")

    log("[mesh predict] full width over a mesh of devices")
    t0 = time.perf_counter()
    mesh = run_mesh_predict(["cuda:0", "cuda:0"] if n_cards == 1
                            else [f"cuda:{i}" for i in range(n_cards)])
    log(f"  [mesh predict]: {time.perf_counter() - t0:.1f} s; mesh folder "
        f"{mesh['folder_img_per_s']:.3f} img/s beside the folder phase's "
        f"{folder['img_per_s']:.3f} (one device, batch 8); the mesh's batch "
        f"of 8 {8e3 / mesh['batch_ms']:.2f} img/s (one batch, host clock)")

    log("[sp golden] + [sp train] the model axis: image height over "
        "ranks, halo-exchanged trunk")
    t0 = time.perf_counter()
    sp = run_model_axis(n_cards, dp)
    log(f"  [sp golden] + [sp train]: {time.perf_counter() - t0:.1f} s")

    log("[sp predict] the model axis in one process: Predictor over a "
        "(1, m) mesh")
    t0 = time.perf_counter()
    sp_predict = run_sp_predict([f"cuda:{i}" for i in range(n_cards)])
    log(f"  [sp predict]: {time.perf_counter() - t0:.1f} s")

    log("[hpo groups] trials over groups of devices, ranks spawned per trial")
    t0 = time.perf_counter()
    groups = run_hpo_groups(hpo["paths"])
    if n_cards < 2:
        log("  [hpo groups] one card: groups of two NCCL ranks need two "
            "cards and are skipped")
    else:
        groups["nccl"] = run_hpo_groups_over_cards(hpo["paths"], n_cards)
        for k, v in groups["nccl"]["launches"].items():
            groups["launches"][k] += v
    log(f"  [hpo groups]: {time.perf_counter() - t0:.1f} s")

    against = {}
    if args.against:
        log(f"[against] kernel wrappers of {args.against} against these")
        against = compare_against(args.against, roi_args, nms_calls,
                                  bwd_args)

    phases = {"full width": launches, "folder": folder["launches"],
              "train": train["launches"], "pth import": pth["launches"],
              "hpo": hpo["launches"], "export": export["launches"],
              "dp golden": _dp_launches(dp, "golden"),
              "dp train": _dp_launches(dp, "train"),
              "mesh predict": mesh["launches"],
              "sp golden": _dp_launches(sp, "golden"),
              "sp train": _dp_launches(sp, "train"),
              "sp predict": sp_predict["launches"],
              "hpo groups": groups["launches"]}

    def counts(name):
        by_phase = {k: v.get(name, 0) for k, v in phases.items()}
        return {"launches": sum(by_phase.values()),
                "launches_by_phase": by_phase}

    records = [
        {"name": "roi_align_windows", "route": "cuda",
         "source": "uwcv_tpu_torch/csrc/roi_align.cu",
         "replaces": "uwcv_tpu/ops/pallas/roi_align_kernel.py:89",
         **counts("roi_align_windows"),
         "max_abs_err": roi_timed["max_abs_err"], "ms": roi_timed["ms"],
         "plain_ms": roi_timed["plain_ms"], "bound_ms": roi_timed["bound_ms"],
         "bound_by": roi_timed["bound_by"], "library_ms": None,
         "shape": {k: roi_timed[k] for k in ("dtype", "C", "P", "R")},
         "cases": roi_cases},
        {"name": "nms_greedy", "route": "cuda",
         "source": "uwcv_tpu_torch/csrc/nms.cu",
         "replaces": "uwcv_tpu/ops/pallas/nms_kernel.py:64",
         **counts("nms_greedy"),
         "max_abs_err": nms_rec["max_abs_err"], "ms": nms_rec["ms"],
         "plain_ms": nms_rec["plain_ms"], "bound_ms": nms_rec["bound_ms"],
         "bound_by": nms_rec["bound_by"], "library_ms": None,
         "problems": nms_rec["problems"], "train": nms_rec["train"]},
        {"name": "roi_align_windows_backward", "route": "cuda",
         "source": "uwcv_tpu_torch/csrc/roi_align_bwd.cu",
         "replaces": "uwcv_tpu/ops/roi_align.py:405",
         **counts("roi_align_windows_backward"),
         "max_abs_err": bwd_timed["max_abs_err"], "ms": bwd_timed["ms"],
         "plain_ms": bwd_timed["plain_ms"], "bound_ms": bwd_timed["bound_ms"],
         "bound_by": bwd_timed["bound_by"], "library_ms": None,
         "shape": {k: bwd_timed[k] for k in ("dtype", "P", "R")},
         "cases": bwd_cases},
        {"name": "paste_claim_pack", "route": "cuda",
         "source": "uwcv_tpu_torch/csrc/mask_tail.cu",
         "replaces": None,
         "why": "eager PyTorch does not fuse the mask tail's chain as XLA "
                "did; no [B, D, H, W] stack",
         **counts("paste_claim_pack"), "max_abs_err": 0.0,
         "ms": tail_rec["ms"], "plain_ms": tail_rec["plain_ms"],
         "bound_ms": tail_rec["bound_ms"], "bound_by": tail_rec["bound_by"],
         "library_ms": None, "shape": tail_rec["shape"],
         "device_split_ms": tail_rec["device_split_ms"],
         "cases": tail_rec["cases"]},
        {"name": "frozen_bn_act", "route": "cuda",
         "source": "uwcv_tpu_torch/csrc/frozen_bn.cu",
         "replaces": None,
         "why": "eager PyTorch runs the trunk's FrozenBN, residual add and "
                "ReLU as 3-5 broadcast passes where XLA fused them",
         **counts("frozen_bn_act"), "max_abs_err": 0.0, **frozen_bn_rec,
         "library_ms": None},
    ]
    if against:
        records[0]["against"] = {k: v for k, v in against.items()
                                 if k.startswith("roi_align_windows P")}
        records[1]["against"] = against["nms_greedy (both calls)"]
        records[2]["against"] = {k: v for k, v in against.items()
                                 if k.startswith("roi_align_windows_backward")}
    log(json.dumps({"folder": folder, "folder_golden": folder_golden,
                    "eval": gate_eval, "train_golden": train_golden,
                    "train": train, "pth_import": pth, "hpo": hpo,
                    "export": export, "data_parallel": dp,
                    "mesh_predict": mesh, "model_axis": sp,
                    "sp_predict": sp_predict, "hpo_groups": groups},
                   default=str))
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
