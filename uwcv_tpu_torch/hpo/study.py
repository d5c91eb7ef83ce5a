"""Hyperparameter search with one trial per GPU (port of
``uwcv_tpu/hpo/study.py``).

The reference declares Optuna HPO but never implements it (its "DO OPTUNA
OPTIMIZATION" banner, nn_train.py:194); the JAX package's
BASELINE config #5 makes it a target: a sweep of LR, anchor sizes and ROI
batch.  Optuna is not installed, so the module keeps the JAX package's own
numpy engine with an optuna-shaped API (``create_study``,
``Trial.suggest_*``, ``study.optimize``), copied so that one seed and the
same reported values give the same suggestions:

- sampler: random warm-up, then a TPE-style sampler (top-γ/bottom split,
  kernel-density ratio argmax over candidates);
- trial parallelism: one trial per device group, dispatched from a thread
  pool.  A group is one CUDA device; on one GPU the trials run in turn.
"""

from __future__ import annotations

import contextlib
import copy
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Native engine (optuna-shaped)
# ---------------------------------------------------------------------------

@dataclass
class _Distribution:
    kind: str                    # "float" | "int" | "categorical"
    low: float = 0.0
    high: float = 1.0
    log: bool = False
    choices: tuple = ()


@dataclass
class FrozenTrial:
    number: int
    params: Dict[str, Any] = field(default_factory=dict)
    value: Optional[float] = None
    state: str = "RUNNING"       # RUNNING | COMPLETE | PRUNED | FAIL
    # optuna's name: what the objective records beside its value (the
    # sweep's timings; the error of a FAIL)
    user_attrs: Dict[str, Any] = field(default_factory=dict)


class Trial:
    def __init__(self, study: "Study", frozen: FrozenTrial):
        self._study = study
        self._frozen = frozen

    @property
    def number(self) -> int:
        return self._frozen.number

    @property
    def params(self) -> Dict[str, Any]:
        return dict(self._frozen.params)

    def set_user_attr(self, key: str, value: Any) -> None:
        self._frozen.user_attrs[key] = value

    def suggest_float(self, name, low, high, log=False):
        d = _Distribution("float", low, high, log)
        v = self._study._sample(name, d)
        self._frozen.params[name] = v
        return v

    def suggest_int(self, name, low, high, log=False):
        d = _Distribution("int", low, high, log)
        v = int(round(self._study._sample(name, d)))
        v = int(np.clip(v, low, high))
        self._frozen.params[name] = v
        return v

    def suggest_categorical(self, name, choices):
        d = _Distribution("categorical", choices=tuple(choices))
        v = self._study._sample(name, d)
        self._frozen.params[name] = v
        return v


class Study:
    """Minimize or maximize an objective with TPE-lite sampling."""

    def __init__(self, direction: str = "minimize", seed: int = 0,
                 n_startup_trials: int = 5, gamma: float = 0.25):
        if direction not in ("minimize", "maximize"):
            raise ValueError(f"direction must be minimize or maximize, got "
                             f"{direction!r}")
        self.direction = direction
        self.trials: List[FrozenTrial] = []
        self._rng = np.random.default_rng(seed)
        self._n_startup = n_startup_trials
        self._gamma = gamma
        self._lock = threading.Lock()
        self._dists: Dict[str, _Distribution] = {}

    # ---- sampling ----

    def _completed(self) -> List[FrozenTrial]:
        return [t for t in self.trials if t.state == "COMPLETE"
                and t.value is not None and math.isfinite(t.value)]

    def _sample(self, name: str, d: _Distribution):
        with self._lock:
            self._dists[name] = d
            done = [t for t in self._completed() if name in t.params]
            if len(done) < self._n_startup:
                return self._random(d)
            return self._tpe(name, d, done)

    def _random(self, d: _Distribution):
        if d.kind == "categorical":
            return d.choices[int(self._rng.integers(len(d.choices)))]
        if d.log:
            return float(np.exp(self._rng.uniform(
                np.log(d.low), np.log(d.high))))
        return float(self._rng.uniform(d.low, d.high))

    def _tpe(self, name: str, d: _Distribution, done: List[FrozenTrial]):
        sign = 1.0 if self.direction == "minimize" else -1.0
        ranked = sorted(done, key=lambda t: sign * t.value)
        n_good = max(1, int(len(ranked) * self._gamma))
        good = [t.params[name] for t in ranked[:n_good]]
        bad = [t.params[name] for t in ranked[n_good:]] or good

        if d.kind == "categorical":
            # weight by the smoothed frequency ratio
            idx = {c: i for i, c in enumerate(d.choices)}
            g = np.ones(len(d.choices))
            b = np.ones(len(d.choices))
            for v in good:
                g[idx[v]] += 1
            for v in bad:
                b[idx[v]] += 1
            probs = (g / g.sum()) / (b / b.sum())
            probs /= probs.sum()
            return d.choices[int(self._rng.choice(len(d.choices), p=probs))]

        def to_u(v):
            return math.log(v) if d.log else v

        lo, hi = to_u(d.low), to_u(d.high)
        width = max((hi - lo) / max(len(good), 1), 1e-9)
        good_u = np.asarray([to_u(v) for v in good])
        bad_u = np.asarray([to_u(v) for v in bad])
        # candidates from the good KDE + uniform exploration
        cands = np.concatenate([
            self._rng.normal(self._rng.choice(good_u), width, 24),
            self._rng.uniform(lo, hi, 8)])
        cands = np.clip(cands, lo, hi)

        def kde(x, pts, bw):
            z = (x[:, None] - pts[None, :]) / bw
            return np.exp(-0.5 * z * z).sum(axis=1) / (len(pts) * bw) + 1e-12

        score = kde(cands, good_u, width) / kde(
            cands, bad_u, max((hi - lo) / max(len(bad), 1), 1e-9))
        best = float(cands[int(np.argmax(score))])
        return float(np.exp(best)) if d.log else best

    # ---- driving ----

    def ask(self) -> Trial:
        with self._lock:
            frozen = FrozenTrial(number=len(self.trials))
            self.trials.append(frozen)
        return Trial(self, frozen)

    def tell(self, trial: Trial, value: float, state: str = "COMPLETE"):
        with self._lock:
            trial._frozen.value = float(value)
            trial._frozen.state = state

    def optimize(self, objective: Callable[[Trial], float], n_trials: int,
                 n_parallel: int = 1, catch: bool = True):
        """Run ``n_trials`` trials, ``n_parallel`` at a time.  With
        ``catch``, a trial whose objective raises is marked FAIL (its error
        in ``user_attrs["error"]``) and the study goes on."""
        def run_one(_):
            t = self.ask()
            try:
                v = objective(t)
                self.tell(t, v)
            except Exception as exc:
                if not catch:
                    raise
                t._frozen.state = "FAIL"
                t._frozen.user_attrs["error"] = repr(exc)

        if n_parallel <= 1:
            for i in range(n_trials):
                run_one(i)
        else:
            with ThreadPoolExecutor(max_workers=n_parallel) as pool:
                list(pool.map(run_one, range(n_trials)))
        return self

    @property
    def best_trial(self) -> FrozenTrial:
        done = self._completed()
        if not done:
            raise ValueError("no completed trials")
        sign = 1.0 if self.direction == "minimize" else -1.0
        return min(done, key=lambda t: sign * t.value)

    @property
    def best_params(self) -> Dict[str, Any]:
        return dict(self.best_trial.params)

    @property
    def best_value(self) -> float:
        return float(self.best_trial.value)


def create_study(direction: str = "minimize", seed: int = 0) -> Study:
    """The native engine (optuna's ``create_study`` shape)."""
    return Study(direction=direction, seed=seed)


# ---------------------------------------------------------------------------
# The reference sweep: LR, anchor sizes, ROI batch (BASELINE config #5)
# ---------------------------------------------------------------------------

def device_groups(n_parallel: int,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> List[List[torch.device]]:
    """``n_parallel`` groups of devices, clipped to the device count as the
    JAX package clips them: one CUDA device per group (``device`` defaults
    to ``cuda`` and raises without a card); ``device="cpu"`` gives one
    group.  A group of several devices needs data parallelism across them,
    which the port does not have yet: asking for one raises."""
    from uwcv_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [dev])
    n_parallel = max(1, min(n_parallel, len(devs)))
    per = len(devs) // n_parallel
    if per > 1:
        raise NotImplementedError(
            f"{n_parallel} groups of {len(devs)} devices would put {per} "
            f"devices in a group; multi-device trials need data parallelism, "
            f"which uwcv_tpu_torch does not have yet")
    return [[devs[i]] for i in range(n_parallel)]


def run_reference_hpo(cfg, n_trials: int = 8, data_dir: Optional[str] = None,
                      max_iter: int = 100, n_parallel: Optional[int] = None,
                      seed: int = 0, space: str = "v1",
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Dict[str, Any]:
    """Search LR / anchor scale / ROI batch (``space="v1"``), or LR /
    rotation / scale-bar class weight around a pinned recipe (``"v2"``).

    Objective: **val segm mAP** (maximized) on the Test split after a short
    fine-tune from a fresh init (as in the JAX package, ``cfg.weights`` is
    not read), scored by ``eval/coco_eval.py::evaluate_split`` at score
    threshold 0.05; bbox AP where segm AP is undefined, else 0.0.  Without
    a Test split it is the mean training loss of the last 5 steps
    (minimized); the result's ``objective`` says which.

    Trials run one per device group (``device_groups``; ``device`` defaults
    to ``cuda``).  One eval predictor is kept per (group, inference-relevant
    model config): the key holds every ModelConfig field not tagged
    ``train``, so trials that differ only in train-only knobs share one,
    whose weights are swapped with ``Predictor.set_params``.  Each trial
    records its host seconds of training (``train_s``, ``steps``) and of
    evaluation (``eval_s``) in ``user_attrs``; the result's
    ``eval_predictors`` counts the predictors built."""
    import dataclasses
    import json
    import os
    import queue
    import time

    from uwcv_tpu_torch.config import model_fields_by_scope
    from uwcv_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_superannotate,
    )
    from uwcv_tpu_torch.data.loader import TrainLoader
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.engine.trainer import Trainer, step_generator
    from uwcv_tpu_torch.eval.coco_eval import evaluate_split
    from uwcv_tpu_torch.weights import params_to_flax

    groups = device_groups(n_parallel or torch.cuda.device_count() or 1,
                           device)

    name = cfg.data.train_dataset
    if name not in DatasetCatalog.list():
        root = data_dir or os.path.join(cfg.data.dataset_root, "Train")
        register_superannotate(name, root, classes_csv=cfg.data.classes_csv)
    dicts = DatasetCatalog.get(name)

    # eval split for the mAP objective: the registered test_dataset, else
    # the reference's DATASET/Test folder beside the train split
    eval_dicts = None
    try:
        ename = cfg.data.test_dataset
        if ename in DatasetCatalog.list():
            eval_dicts = DatasetCatalog.get(ename) or None
        else:
            troot = (os.path.join(os.path.dirname(
                os.path.abspath(data_dir).rstrip("/")), "Test")
                if data_dir else os.path.join(cfg.data.dataset_root, "Test"))
            if os.path.isdir(troot):
                register_superannotate(ename, troot,
                                       classes_csv=cfg.data.classes_csv)
                eval_dicts = DatasetCatalog.get(ename) or None
    except Exception:
        eval_dicts = None
    use_map = eval_dicts is not None

    # a trial waits for a free device group
    group_queue: "queue.Queue[int]" = queue.Queue()
    for gid in range(len(groups)):
        group_queue.put(gid)

    train_only = model_fields_by_scope("train")
    predictor_cache: Dict[tuple, Any] = {}
    cache_lock = threading.Lock()

    def eval_predictor(gid: int, tcfg, params):
        ecfg = copy.deepcopy(tcfg)
        ecfg.model.roi_score_thresh_test = 0.05
        key = (gid, json.dumps(
            {k: v for k, v in sorted(dataclasses.asdict(ecfg.model).items())
             if k not in train_only}, default=str))
        with cache_lock:
            pred = predictor_cache.get(key)
        if pred is None:
            pred = Predictor(ecfg, params, device=groups[gid][0])
            with cache_lock:
                predictor_cache[key] = pred
        else:
            pred.set_params(params)
        return pred

    def train_and_score(trial: Trial, tcfg, gid: int) -> float:
        dev = groups[gid][0]
        t0 = time.perf_counter()
        trainer = Trainer(tcfg, device=dev)
        trainer.init_state(seed + trial.number)
        loader = TrainLoader(dicts, tcfg, seed=seed + trial.number,
                             num_workers=1)
        # a fine-tune-sized dataset on the device: a step ships its
        # [B] index vector only
        dd = loader.device_dataset(dev)
        if dd is None:
            loader.start()
        losses = []
        try:
            batch_iter = (loader.index_batches() if dd is not None
                          else iter(loader))
            t1 = time.perf_counter()
            for i in range(max_iter):
                if dd is not None:
                    idx = trainer._put(next(batch_iter), indexed=True)
                    batch = {k: v.index_select(0, idx)
                             for k, v in dd.items()}
                else:
                    batch = trainer._put(next(batch_iter), indexed=False)
                metrics = trainer.train_step(
                    batch, step_generator(1000 + trial.number, i, dev))
                if i >= max_iter - 5:
                    losses.append(float(metrics["total_loss"]))
        finally:
            if dd is None:
                loader.stop()
        trial.set_user_attr("setup_s", t1 - t0)
        trial.set_user_attr("train_s", time.perf_counter() - t1)
        trial.set_user_attr("steps", max_iter)
        if use_map:
            t0 = time.perf_counter()
            pred = eval_predictor(gid, tcfg, params_to_flax(trainer.model))
            res = evaluate_split(tcfg, eval_dicts, predictor=pred)
            trial.set_user_attr("eval_s", time.perf_counter() - t0)
            v = res["segm"]["AP"]
            if not math.isfinite(v) or v < 0:   # -1 = undefined row
                v = res["bbox"]["AP"]
            return v if math.isfinite(v) and v >= 0 else 0.0
        value = float(np.mean(losses)) if losses else float("inf")
        return value if math.isfinite(value) else 1e9

    def objective(trial: Trial) -> float:
        tcfg = copy.deepcopy(cfg)
        if space == "v2":
            # the class-imbalance / orientation knobs, around a pinned
            # recipe (anchors and roi_batch from cfg); all three are
            # train-only, so every trial shares one eval predictor
            lr = trial.suggest_float("base_lr", 5e-4, 8e-3, log=True)
            rot = trial.suggest_categorical(
                "rotation_prob", (0.25, 0.5, 0.75))
            barw = trial.suggest_categorical(
                "bar_weight", (2.0, 4.0, 8.0, 16.0))
            anchor_scale = 1.0
            roi_batch = tcfg.model.roi_batch_size_per_image
            tcfg.input.rotation_prob = float(rot)
            tcfg.model.roi_fg_class_weights = (barw, 1.0, 1.0, 1.0)
            tcfg.model.rpn_fg_class_weights = (barw / 2, 1.0, 1.0, 1.0)
            tcfg.model.class_loss_weights = (barw / 2, 1.0, 1.0, 1.0)
        else:
            lr = trial.suggest_float("base_lr", 1e-5, 1e-2, log=True)
            anchor_scale = trial.suggest_categorical(
                "anchor_scale", (0.5, 1.0, 2.0))
            roi_batch = trial.suggest_categorical("roi_batch", (16, 32, 64))
        tcfg.solver.base_lr = lr
        tcfg.solver.max_iter = max_iter
        # a group is one device, so the batch needs no rounding to it
        tcfg.solver.ims_per_batch = max(1, tcfg.solver.ims_per_batch)
        tcfg.solver.checkpoint_period = 0
        tcfg.solver.log_period = max(max_iter // 2, 1)
        tcfg.model.roi_batch_size_per_image = int(roi_batch)
        tcfg.model.anchor_sizes = tuple(
            tuple(s * anchor_scale for s in level)
            for level in cfg.model.anchor_sizes)
        tcfg.output_dir = f"{cfg.output_dir}/hpo_trial{trial.number}"

        gid = group_queue.get()   # blocks until a device group frees up
        try:
            dev = groups[gid][0]
            # the kernels and CUDA events of the trial go to this
            # thread's current device
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                return train_and_score(trial, tcfg, gid)
        finally:
            group_queue.put(gid)

    study = create_study("maximize" if use_map else "minimize", seed=seed)
    study.optimize(objective, n_trials=n_trials, n_parallel=len(groups))
    trials = [{"number": t.number, "value": t.value, "params": t.params,
               "state": t.state, "user_attrs": t.user_attrs}
              for t in study.trials]
    if not study._completed():
        raise ValueError("no completed trials: " + "; ".join(
            f"trial {t['number']} {t['state']} {t['user_attrs'].get('error')}"
            for t in trials))
    return {"best_params": study.best_params, "best_value": study.best_value,
            "objective": "segm_mAP" if use_map else "final_loss",
            "n_trials": len(study.trials),
            "eval_predictors": len(predictor_cache),
            "trials": trials}
