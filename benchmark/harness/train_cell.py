"""Traffic kind ``train_cell``: seeded micrographs with polygon
annotations, prepared once by the program's ``TrainLoader`` and staged on
the card (``device_dataset``), then ``Trainer.train_step`` in
``Trainer.fit``'s loop: each step gathers its rows on the device from an
index batch, takes its generator from ``step_generator``, and every
``log_period`` steps the losses come to the host (``global_metrics``).

Set-up builds one trainer and drives it through the first steps with the
window's own call and feed (distinct rows); the reference follows the
first three, and the same trainer then runs the window."""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import common, flops, judge, micrographs, recorders
from benchmark.harness import trace as tr
from benchmark.harness import weights as W
from benchmark.reference.raster import rasterize

CHECK_STEPS = 3


def dataset(traffic: dict, seed: int, workdir: str):
    """Seeded micrographs written as TIFFs under ``workdir``, and their
    records for the program's loader; also the raw arrays."""
    rng = np.random.default_rng(seed)
    records, raw = [], []
    h, w = traffic["image_hw"]
    for i in range(traffic["images"]):
        img, anns = micrographs.draw(rng, (h, w), traffic["instances"])
        path = os.path.join(workdir, f"train_{i:03d}.tif")
        micrographs.write_tiff(path, img)
        records.append({"file_name": path, "height": h, "width": w,
                        "image_id": i, "annotations": [
                            {"bbox": [float(v) for v in a["box"]],
                             "segmentation": [a["poly"].reshape(-1).tolist()],
                             "category_id": int(a["cls"]), "iscrowd": 0}
                            for a in anns]})
        raw.append((img, anns))
    return records, raw


def reference_batch(raw, rows, cfg: dict, n_max: int, device) -> Dict:
    """The rows' inputs as the reference works them out from the raw
    micrographs and polygons: resized to the train size (antialiased
    bilinear), the boxes and polygons scaled, the masks rasterized."""
    import torch.nn.functional as F

    s_h, s_w = cfg["input"]["train_size"]
    imgs, boxes, classes, valid, masks = [], [], [], [], []
    for r in rows:
        img, anns = raw[r]
        h, w = img.shape
        # resized on the host, as the configuration's loader does
        x = torch.from_numpy(img).float()[None, None]
        x = F.interpolate(x, size=(s_h, s_w), mode="bilinear",
                          align_corners=False, antialias=True)
        imgs.append(x.round().clamp(0, 255)[0, 0].to(device)[
            ..., None].expand(-1, -1, 3))
        sc = np.array([s_w / w, s_h / h])
        bx = np.zeros((n_max, 4), np.float32)
        cl = np.zeros((n_max,), np.int64)
        va = np.zeros((n_max,), bool)
        mk = torch.zeros((n_max, s_h, s_w), dtype=torch.bool, device=device)
        for j, a in enumerate(anns):
            bx[j] = np.clip(np.asarray(a["box"], np.float64) * np.tile(sc, 2),
                            0, [s_w, s_h, s_w, s_h])
            cl[j], va[j] = a["cls"], True
            mk[j] = rasterize(torch.from_numpy(a["poly"] * sc).to(device),
                              s_h, s_w)
        boxes.append(bx)
        classes.append(cl)
        valid.append(va)
        masks.append(mk)
    t = lambda a: torch.from_numpy(np.stack(a)).to(device)
    return {"image": torch.stack(imgs).to(torch.uint8), "boxes": t(boxes),
            "classes": t(classes), "valid": t(valid),
            "masks": torch.stack(masks)}


def build(conf: dict, traffic: dict, seed: int, device, workdir: str):
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.data.loader import TrainLoader
    from uwcv_tpu_torch.engine.trainer import Trainer

    cfg = Config.from_dict(conf["config"])
    cfg.solver.ims_per_batch = traffic["batch"]
    cfg.solver.seed = seed
    cfg.output_dir = os.path.join(workdir, "out")
    records, raw = dataset(traffic, seed, workdir)
    loader = TrainLoader(records, cfg, seed=seed, num_workers=1)
    staged = loader.device_dataset(device)
    if staged is None:
        raise common.Unfit("the dataset does not fit data.device_dataset_mb")
    w = W.make(conf["config"]["model"], conf["init"], seed, device)
    trainer = Trainer(cfg, device=device)
    trainer.load_params(W.to_numpy(w))
    return cfg, trainer, loader, staged, w, raw


def leaf_paths(trainer) -> Dict[str, str]:
    """Torch parameter name → Flax path, of the trainer's model."""
    from uwcv_tpu_torch.weights import flax_leaf_names

    return {v: k for k, v in flax_leaf_names(trainer.model).items()}


class Loop:
    """Trainer.fit's loop over the staged dataset, a step at a time."""

    def __init__(self, trainer, loader, staged, cfg, seed: int):
        from uwcv_tpu_torch.engine.trainer import step_generator

        self.trainer, self.staged, self.cfg = trainer, staged, cfg
        self.seed, self.gen = seed, step_generator
        self.index = loader.index_batches()
        self.device = trainer.device
        self.i = 0
        self.rows: List[np.ndarray] = []
        self.logged: List[Dict[str, float]] = []

    def step(self):
        rows = next(self.index)
        self.rows.append(rows)
        idx = torch.from_numpy(rows.astype(np.int64))
        if self.device.type == "cuda":
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        batch = {k: v.index_select(0, idx) for k, v in self.staged.items()}
        m = self.trainer.train_step(batch, self.gen(self.seed, self.i,
                                                    self.device))
        self.i += 1
        if self.i % self.cfg.solver.log_period == 0:
            self.logged.append(self.trainer.global_metrics(m))
        return m


def run(ctx: Dict, args, t_start: float) -> Dict:
    conf, traffic = ctx["config"], ctx["traffic"]
    dev = torch.device(getattr(args, "device", "cuda"))
    workdir = micrographs.workdir("train")
    cfg, trainer, loader, staged, w, raw = build(conf, traffic, args.seed,
                                                 dev, workdir)
    loop = Loop(trainer, loader, staged, cfg, args.seed)
    names = leaf_paths(trainer)
    train_names = [n for n, p in trainer.compute.named_parameters()
                   if p.requires_grad]
    store, prog = {}, {"losses": [], "proposals": []}
    masters = dict(trainer.model.named_parameters())
    before = {n: masters[n].detach().clone() for n in train_names}
    with recorders.proposals(store):
        for k in range(CHECK_STEPS):
            m = loop.step()
            prog["losses"].append({t: float(v) for t, v in m.items()
                                   if t != "total_loss"})
            prog["proposals"].append(store["last"])
            if k == 0:
                prog["grad1"] = {names[n]: t.detach().clone() for n, t in
                                 zip(train_names, trainer.traces)}
    # norms only: the program's layout of a leaf need not be the reference's
    prog["change"] = {names[n]: masters[n].detach() - before.pop(n)
                      for n in train_names}
    check_rows = [r.copy() for r in loop.rows]
    for _ in range(traffic["warmup_steps"]):
        loop.step()
    common.sync(dev)
    setup_s = time.perf_counter() - t_start
    b = traffic["batch"]
    if args.trace:
        per_layer = traced_window(loop, conf, traffic, ctx)
        steps = per_layer["steps"]
    else:
        first = loop.i
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            loop.step()
        common.sync(dev)
        window = time.perf_counter() - t0
        steps = loop.i - first
    failed = sum(not math.isfinite(m["total_loss"]) for m in loop.logged)
    device = common.device_block(1, per_layer["_trace"] if args.trace
                                 else None, dev)
    n_max = staged["boxes"].shape[1]
    del trainer, loader, staged, loop, store
    torch.cuda.empty_cache()
    batches = [reference_batch(raw, rows, conf["config"], n_max, dev)
               for rows in check_rows]
    got = judge.judge_train(w, batches, conf["config"], args.seed, prog)
    numbers = {k: got[k] for k in judge.TRAIN_NUMBERS}
    common.log(f"program losses {prog['losses']}")
    common.log(f"reference losses {got['ref_losses']}")
    common.log(f"leaves compared {got['leaves']}, left out "
               f"{got['leaves_left_out']}; loss gaps by term {got['term_gaps']}")
    if args.trace:
        metrics = per_layer["metrics"]
    else:
        common.log(f"{steps} steps of {b} in {window:.3f} s")
        metrics = {"train_img_per_s": {"value": steps * b / window,
                                       "unit": "img/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    result = {"attempted": steps, "failed": failed, "metrics": metrics,
              "device": device}
    if args.trace:
        result["breakdown"] = per_layer["breakdown"]
    return {"result": result, "numbers": numbers,
            "limits": conf["limits"]["train"]}


def foreground_rois(m: dict, traffic: dict) -> int:
    """Foreground rois the sampler takes an image: the positive fraction
    of the roi batch, or fewer where an image has fewer gt instances (the
    gt boxes join the candidates, so each gt gives at least one)."""
    least = sum(lo for lo, _ in traffic["instances"].values())
    return min(int(m["roi_positive_fraction"]
                   * m["roi_batch_size_per_image"]), least)


def traced_window(loop: Loop, conf, traffic, ctx) -> Dict:
    n = traffic["traced_steps"]
    calls, marks = [], []

    def window():
        with recorders.pooler_calls(calls):
            for _ in range(n):
                loop.trainer.marks = []
                loop.step()
                marks.append(loop.trainer.marks)
        loop.trainer.marks = None

    trace = tr.traced(window, micrographs.workdir("trace"))
    m, solver = conf["config"]["model"], conf["config"]["solver"]
    s = conf["config"]["input"]["train_size"][0]
    rois = m["roi_batch_size_per_image"]
    fl = n * flops.train_step(m, solver, s, traffic["batch"], rois,
                              foreground_rois(m, traffic))
    rctx = {"trace": trace, "marks": tr.stage_ms(marks), "flops": fl,
            "pooler_calls": calls, "model": m, "steps": n,
            "power": common.power_limit()}
    common.log(f"card: {rctx['power']}")
    metrics = {}
    for spec in common.metric_names(ctx["spec"], ctx["workload"]["name"],
                                    "per_layer"):
        value = common.reader(spec["name"])(rctx)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return {"metrics": metrics, "steps": n, "_trace": trace,
            "breakdown": {"device_ops": trace["device_ops"],
                          "idle_gaps": trace["idle_gaps"]}}
