"""Trainer: fine-tuning on one GPU, or data-parallel with one process per
GPU (port of ``uwcv_tpu/engine/trainer.py``).

- parameters are f32 masters; the forward and backward run on a working
  copy in the compute dtype (``model.dtype``), refreshed from the masters
  after every step, so weights round to the compute dtype at use as Flax
  casts them (no ``torch.autocast``: it would run FrozenBN in f32); the
  RPN head, shared by the five levels, keeps f32 in the working copy and
  casts at use, so its gradient is summed in f32;
- the optimizer is the JAX package's optax chain, written out in its
  order: weight decay added to the gradient, clipping by the global norm
  of the trainable gradients, momentum trace (t = g + 0.9·t), then
  −lr(step) (``engine/lr_schedule.py``);
- FrozenBN is buffers, and stages below ``solver.freeze_at`` have
  ``requires_grad=False`` (Detectron2 FREEZE_AT);
- ``fit`` prefetches the next batch, writes ``metrics.json`` lines and
  TensorBoard scalars, checkpoints every ``solver.checkpoint_period`` steps
  and at the end, where it also writes ``model_final.npz`` (flat Flax
  layout) and ``config.json``.

Each step's random draws (augmentation, then the two samplers) come from a
generator seeded by (``solver.seed``, step).  A resumed run whose batches
skip the steps already taken (``TrainLoader.skip``, as the ``train`` verb
does) therefore repeats an uninterrupted one.

Data parallelism (a process group of several ranks,
``parallel/mesh.py::initialize_multi_host``): each rank trains on its rows
of the global batch (``TrainLoader(process_index, process_count)``), draws
for the whole global batch and keeps its rows, and computes its share of
the global loss (``MaskRCNN.forward_train(world=...)``).  The trainable
gradients are summed over the ranks in one f32 buffer before weight decay
and clipping, so every rank applies the same update and the masters stay
bit-identical; rank 0's weights, traces and step are broadcast after every
load.  The logged losses are the global ones; rank 0 writes the metrics,
TensorBoard, checkpoints and ``config.json`` while the others wait.  Each
rank keeps the three CUDA kernels on its own card.

The model axis (``parallel.mesh_shape = (d, m)``, m > 1; a process group
of d·m ranks, ``parallel/mesh.py::mesh_axes``): the m ranks of a data row
load the same rows and draw the same numbers, and each runs the trunk on
its rows of the augmented images (``forward_train(model_axis=...)``).  The
loss denominators and the logged losses are summed over the data axis
only, so each image counts once.  The trainable gradients are summed over
all d·m ranks in one f32 buffer: the trunk's (ResNet and FPN) are each
rank's share of its row's; the heads' and the RPN's are the whole row's on
every rank of it, so only the row's first rank adds them (every rank of a
row holds the same bits afterwards, whatever order the backward
algorithms summed in).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import time
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from uwcv_tpu_torch.config import Config
from uwcv_tpu_torch.data.augment import (
    augment_batch,
    augment_draws,
    unpack_bitmasks,
)
from uwcv_tpu_torch.data.loader import TRAIN_KEYS
from uwcv_tpu_torch.engine import checkpoint as ckpt
from uwcv_tpu_torch.engine.lr_schedule import warmup_multistep
from uwcv_tpu_torch.models.rcnn import MaskRCNN, compute_dtype
from uwcv_tpu_torch.parallel.mesh import Mesh, mesh_axes
from uwcv_tpu_torch.utils.device import mark, resolve_device
from uwcv_tpu_torch.utils.tb_writer import SummaryWriter
from uwcv_tpu_torch.weights import (
    flax_leaf_names,
    params_from_flax,
    params_to_flax,
)

LOSS_WEIGHTS = {"rpn_cls": 1.0, "rpn_loc": 1.0, "cls": 1.0,
                "box_reg": 1.0, "mask": 1.0}


def trainable_mask(model: torch.nn.Module, freeze_at: int = 2
                   ) -> Dict[str, bool]:
    """Flax leaf path → whether the optimizer updates it: FrozenBN affines
    never, and the backbone stages through ``freeze_at`` (1 = stem, 2..5 =
    through res2..res5) not (trainer.py:43-69)."""
    if not 0 <= freeze_at <= 5:
        raise ValueError(
            f"freeze_at must be 0..5 (Detectron2 BACKBONE.FREEZE_AT: "
            f"1=stem, 2..5=through res2..res5), got {freeze_at}")

    def decide(path: str) -> bool:
        if "frozen_bn" in path:
            return False
        if freeze_at >= 1 and "/stem_" in "/" + path:
            return False
        return not any(freeze_at >= stage and f"res{stage}_block" in path
                       for stage in (2, 3, 4, 5))

    return {path: decide(path) for path in flax_leaf_names(model)}


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one training step's random draws."""
    g = torch.Generator(device=device)
    g.manual_seed((seed + 1) * 1_000_003 + step)
    return g


class Trainer:
    """trainer = Trainer(cfg); trainer.resume_or_load(); trainer.fit(...)

    Runs on CUDA unless ``device="cpu"`` is passed; without a card the
    default raises.  In an initialized process group of several ranks it
    trains data-parallel, over a model axis of ``parallel.mesh_shape[1]``
    (module docstring).  ``rank`` and ``ranks`` are this rank's data index
    and the data axis's size.  ``mesh`` (d, m) replaces the config's
    model axis and places the ranks, rank r on ``mesh.devices[r // m, r %
    m]`` unless ``device`` is given; it must hold one device per rank."""

    def __init__(self, cfg: Config,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[Mesh] = None):
        # own copy: later edits of the caller's cfg do not reach the run
        self.cfg = cfg = copy.deepcopy(cfg)
        m = (mesh.devices.shape[1] if mesh is not None
             else max(cfg.parallel.mesh_shape[1], 1))
        # every process; the data axis (each image counted once); the
        # model axis of this rank's row
        self.group, self.world, self.model_axis = mesh_axes(m)
        self.rank, self.ranks = ((self.world.rank, self.world.size)
                                 if self.world else (0, 1))
        if mesh is not None:
            n = self.group.size if self.group else 1
            if mesh.devices.size != n:
                raise ValueError(
                    f"a trainer's mesh puts one rank on each device: "
                    f"{mesh.devices.size} devices for {n} ranks (launch "
                    f"one process per device)")
            if device is None:
                device = mesh.devices[divmod(self.group.rank if self.group
                                             else 0, m)]
        self.mesh = mesh
        self.device = resolve_device(device)
        self.is_writer = self.group is None or self.group.rank == 0
        self.schedule = warmup_multistep(cfg.solver)
        # (name, CUDA event) per step phase, recorded while a caller sets
        # a list here
        self.marks: Optional[list] = None
        self.init_state()
        if self.is_writer:
            os.makedirs(cfg.output_dir, exist_ok=True)
            # the full config beside the checkpoints, so a consumer
            # rebuilds the matching model
            with open(os.path.join(cfg.output_dir, "config.json"), "w") as f:
                f.write(cfg.dumps())
        self._barrier()

    # -------- state --------

    def _build(self, model: MaskRCNN) -> None:
        """Install ``model`` as the f32 masters (rank 0's in a
        data-parallel run), make the working copy and reset the
        optimizer."""
        self.model = model.to(device=self.device, dtype=torch.float32)
        if self.group:
            self.group.broadcast_(list(self.model.state_dict().values()))
        dtype = compute_dtype(self.cfg.model)
        self.compute = self.model
        if dtype != torch.float32:
            self.compute = copy.deepcopy(self.model).to(dtype)
            # the RPN head runs once per level: it stays f32 and casts at
            # use, so its five gradient contributions add in f32 as the vjp
            # of Flax's cast adds them
            self.compute.rpn_head.float()
        names = flax_leaf_names(self.model)
        mask = trainable_mask(self.model, self.cfg.solver.freeze_at)
        train = {names[k] for k, v in mask.items() if v}
        masters = dict(self.model.named_parameters())
        self._trainable = []          # (name, master, working copy)
        for name, p in self.compute.named_parameters():
            p.requires_grad_(name in train)
            if name in train:
                self._trainable.append((name, masters[name], p))
        # over a model axis only the row's first rank adds the heads'
        # gradients: each rank of the row holds the whole of them
        heads_here = self.model_axis is None or self.model_axis.rank == 0
        self._summed = [heads_here or name.startswith(("backbone.", "fpn."))
                        for name, _, _ in self._trainable]
        if self.compute is not self.model:
            self.model.requires_grad_(False)
        self.traces = [torch.zeros_like(m) for _, m, _ in self._trainable]
        self.step = 0

    def _refresh(self, everything: bool = False) -> None:
        """Round the trainable masters (``everything``: all parameters and
        buffers) into the working copy."""
        if self.compute is self.model:
            return
        if everything:
            pairs = zip(self.compute.state_dict().values(),
                        self.model.state_dict().values())
        else:
            pairs = ((c, m) for _, m, c in self._trainable)
        # one foreach copy per (dst, src) dtype pair: the RPN head's f32
        # weights sit beside the bf16 rest
        groups: Dict[tuple, list] = {}
        for c, m in pairs:
            groups.setdefault((c.dtype, m.dtype), []).append((c, m))
        with torch.no_grad():
            for group in groups.values():
                dst, src = zip(*group)
                torch._foreach_copy_(list(dst), list(src))

    def init_state(self, seed: Optional[int] = None) -> None:
        """Fresh weights (the modules' own initialisation, seeded by
        ``seed`` or ``solver.seed``; the global RNG is left as it was) and
        a fresh optimizer."""
        seed = self.cfg.solver.seed if seed is None else seed
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = MaskRCNN(self.cfg.model)
        self._build(model)

    def load_params(self, flat: Dict[str, np.ndarray]) -> None:
        """Install flat Flax params (``weights.load_npz``) and reset the
        optimizer."""
        model = MaskRCNN(self.cfg.model)
        model.load_state_dict(params_from_flax(flat), strict=True)
        self._build(model)

    # -------- one step --------

    def global_gradients(self) -> Dict[str, torch.Tensor]:
        """The global batch's f32 gradients of the trainable parameters by
        name, from the working copy's ``.grad`` (this rank's): in a process
        group one f32 sum over every rank, in which a model axis's trunk
        gradients add up and only the row's first rank adds the heads'.
        Every rank must call it."""
        names = [n for n, _, _ in self._trainable]
        masters = [m for _, m, _ in self._trainable]
        grads = [torch.zeros_like(m) if c.grad is None or not summed
                 else c.grad.float()
                 for (_, m, c), summed in zip(self._trainable, self._summed)]
        if self.group:
            flat = torch.cat([g.reshape(-1) for g in grads])
            mark(self.marks, "gradient f32 pack")
            self.group.all_reduce_sum(flat)
            mark(self.marks, "gradient all-reduce")
            grads = [part.view_as(m) for part, m in zip(
                flat.split([m.numel() for m in masters]), masters)]
        return dict(zip(names, grads))

    def _apply_gradients(self) -> None:
        """The optax chain of trainer.py:72-88, over the trainable
        parameters: g += wd·p; g clipped by the global norm; t = g + m·t;
        p += −lr(step)·t."""
        sc = self.cfg.solver
        masters = [m for _, m, _ in self._trainable]
        # the ranks' gradients summed in f32, before weight decay and
        # clipping, which act on the global gradient once
        grads = list(self.global_gradients().values())
        if sc.weight_decay > 0:
            grads = torch._foreach_add(grads,
                                       torch._foreach_mul(masters,
                                                          sc.weight_decay))
        if sc.clip_grad_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            # optax: (g / norm) · max_norm unless norm < max_norm, without
            # a host sync
            keep = norm < sc.clip_grad_norm
            one = torch.ones_like(norm)
            grads = torch._foreach_div(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(
                keep, one, torch.full_like(norm, sc.clip_grad_norm)))
        torch._foreach_mul_(self.traces, sc.momentum)
        torch._foreach_add_(self.traces, grads)
        torch._foreach_add_(masters, torch._foreach_mul(
            self.traces, -self.schedule(self.step)))
        self._refresh()

    def train_step(self, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator,
                   sampler_draws: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One SGD step on a device batch {image [B,S,S,3] uint8, boxes,
        classes, valid, masks_packed}: unpack masks, augment,
        ``forward_train``, the weighted loss sum, backward, the optimizer.
        ``sampler_draws`` (``models.rcnn.sampler_draws``) replace the
        samplers' draws from ``generator``.  → the losses and
        ``total_loss`` (device scalars; in a data-parallel run this data
        row's shares, which ``global_metrics`` sums); the working copy's
        ``.grad`` keep this rank's gradients until the next step."""
        cfg = self.cfg
        mark(self.marks, "start")
        masks = unpack_bitmasks(batch["masks_packed"], cfg.input.train_size[1])
        # draws for the global batch, in a one-process run's order; this
        # rank keeps its rows
        b, r = batch["image"].shape[0], self.rank
        draws = augment_draws(b * self.ranks, cfg.input, generator,
                              self.device)
        aug = augment_batch({"image": batch["image"].float(),
                             "boxes": batch["boxes"], "masks": masks},
                            cfg.input, draws={k: v[r * b:(r + 1) * b]
                                              for k, v in draws.items()})
        for _, _, c in self._trainable:
            c.grad = None
        losses = self.compute.forward_train(
            aug["image"], aug["boxes"], batch["classes"], aug["masks"],
            batch["valid"], generator=generator, draws=sampler_draws,
            world=self.world, model_axis=self.model_axis)
        total = sum(LOSS_WEIGHTS.get(k, 1.0) * v for k, v in losses.items())
        mark(self.marks, "forward")
        total.backward()
        mark(self.marks, "backward")
        with torch.no_grad():
            self._apply_gradients()
        mark(self.marks, "optimizer")
        self.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    def global_metrics(self, metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, float]:
        """A step's metrics as host floats: in a data-parallel run the sum
        of the data rows' shares (one all-reduce over the data axis), i.e.
        the global batch's.  Every rank must call it."""
        if self.world:
            vec = self.world.all_reduce_sum(
                torch.stack([metrics[k].float() for k in metrics]))
            metrics = dict(zip(metrics, vec))
        return {k: float(v) for k, v in metrics.items()}

    def _barrier(self) -> None:
        if self.group:
            self.group.barrier()

    # -------- the loop --------

    def _put(self, x, indexed: bool):
        """A host batch (or [B] index vector) onto the device, through
        pinned memory on a GPU so the copy overlaps the running step."""
        if indexed:
            arrays = {"idx": np.asarray(x, np.int64)}
        else:
            arrays = {k: x[k] for k in TRAIN_KEYS}
        pin = self.device.type == "cuda"
        out = {k: (torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self.device, non_blocking=True) if pin
                   else torch.from_numpy(np.ascontiguousarray(v)))
               for k, v in arrays.items()}
        return out["idx"] if indexed else out

    def fit(self, batch_iter: Iterator, max_iter: Optional[int] = None,
            log_fn=print, device_dataset: Optional[Dict] = None) -> int:
        """Train from the current step to ``max_iter`` (default
        ``solver.max_iter``).  ``batch_iter`` yields host numpy batches, or,
        with ``device_dataset`` (``TrainLoader.device_dataset``), [B] index
        vectors (``TrainLoader.index_batches``) whose batch is gathered on
        the device.  In a data-parallel run every rank calls ``fit`` with
        its own batches; rank 0 logs and writes.  → the final step."""
        cfg = self.cfg
        indexed = device_dataset is not None
        max_iter = max_iter or cfg.solver.max_iter
        start = self.step
        metrics_path = os.path.join(cfg.output_dir, "metrics.json")
        t0 = time.time()
        tb = SummaryWriter(cfg.output_dir) if self.is_writer else None
        try:
            # one batch ahead: its upload overlaps the current step; a run
            # already complete consumes nothing
            pending = (self._put(next(batch_iter), indexed)
                       if start < max_iter else None)
            with (open(metrics_path, "a") if self.is_writer
                  else contextlib.nullcontext()) as mf:
                for i in range(start, max_iter):
                    batch = pending
                    if i + 1 < max_iter:
                        pending = self._put(next(batch_iter), indexed)
                    if indexed:
                        batch = {k: v.index_select(0, batch)
                                 for k, v in device_dataset.items()}
                    metrics = self.train_step(
                        batch, step_generator(cfg.solver.seed, i, self.device))
                    logged = ((i + 1) % cfg.solver.log_period == 0
                              or i + 1 == max_iter)
                    if logged:
                        # every rank joins the sum; rank 0 writes it
                        m = self.global_metrics(metrics)
                    if logged and self.is_writer:
                        m["iteration"] = i + 1
                        m["time_per_iter"] = (time.time() - t0) / max(
                            i + 1 - start, 1)
                        mf.write(json.dumps(m) + "\n")
                        mf.flush()
                        tb.add_scalars(i + 1, {f"train/{k}": v
                                               for k, v in m.items()
                                               if k != "iteration"})
                        log_fn(f"iter {i + 1}/{max_iter} " + " ".join(
                            f"{k}={v:.4f}" for k, v in m.items()
                            if k != "iteration"))
                    if (cfg.solver.checkpoint_period > 0 and (i + 1)
                            % cfg.solver.checkpoint_period == 0):
                        self.save_checkpoint()
        finally:
            if tb is not None:
                tb.close()
        self.save_checkpoint(final=True)
        return self.step

    # -------- checkpoints --------

    def save_checkpoint(self, final: bool = False) -> str:
        """``ckpt_<step>.pt`` (masters, traces, step); with ``final`` also
        ``model_final.npz`` and, beside it, ``config.json``.  Rank 0
        writes; the other ranks wait for it.  → the checkpoint's path (None
        on the other ranks)."""
        path = None
        if self.is_writer:
            state = {"model": self.model.state_dict(),
                     "trace": {n: t for (n, _, _), t in zip(self._trainable,
                                                            self.traces)},
                     "step": self.step}
            path = ckpt.save_checkpoint(self.cfg.output_dir, state, self.step)
            if final:
                ckpt.save_params_npz(
                    os.path.join(self.cfg.output_dir, "model_final.npz"),
                    params_to_flax(self.model))
                with open(os.path.join(self.cfg.output_dir, "config.json"),
                          "w") as f:
                    f.write(self.cfg.dumps())
        self._barrier()
        return path

    def resume_or_load(self, resume: bool = False) -> None:
        """``resume``: continue from the latest ``ckpt_*.pt`` in the output
        directory, if any; otherwise load ``cfg.weights`` (an ``.npz`` of
        flat Flax params, or a torch ``.pth`` state dict mapped onto the
        current weights: ``checkpoint.load_weights``) when set, else keep
        the current weights."""
        if resume:
            latest = ckpt.latest_checkpoint(self.cfg.output_dir)
            if latest is not None:
                state = ckpt.load_checkpoint(latest, self.device)
                self.model.load_state_dict(state["model"], strict=True)
                self._refresh(everything=True)
                self.traces = [state["trace"][n].to(self.device)
                               for n, _, _ in self._trainable]
                self.step = int(state["step"])
                if self.group:
                    # rank 0's weights, traces and step
                    step = torch.tensor([self.step], dtype=torch.float64,
                                        device=self.device)
                    self.group.broadcast_(
                        list(self.model.state_dict().values())
                        + self.traces + [step])
                    self.step = int(step.item())
                    self._refresh(everything=True)
                return
        if self.cfg.weights:
            self.load_params(ckpt.load_weights(self.cfg.weights, self.model,
                                               self.cfg.model))
