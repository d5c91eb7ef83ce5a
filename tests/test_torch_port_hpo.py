"""The port's HPO (``uwcv_tpu_torch/hpo/study.py``) against the JAX
package's: the numpy engine suggests the same values for the same seed and
reported values (random warm-up, then TPE), ``create_study`` and the
failure path behave alike, ``device_groups`` clips as JAX clips, and a
2-trial CPU sweep at R26 on a 96² synthetic set completes with the segm
mAP objective."""

import math
import os
import sys

import numpy as np
import pytest
import torch

from torch_port_harness import hang_report, hang_report_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from uwcv_tpu.hpo import study as j_study  # noqa: E402
from uwcv_tpu_torch.hpo import study  # noqa: E402


def _objective(trial):
    """Every kind of suggestion, and a value that depends on all of them."""
    x = trial.suggest_float("x", -3.0, 2.0)
    lr = trial.suggest_float("lr", 1e-5, 1e-1, log=True)
    n = trial.suggest_int("n", 1, 9)
    c = trial.suggest_categorical("c", ("a", "b", "c"))
    return (x - 0.5) ** 2 + abs(math.log10(lr) + 3) + 0.1 * n + \
        {"a": 0.0, "b": 0.5, "c": 1.0}[c]


def _records(s):
    return [(t.number, t.params, t.value, t.state) for t in s.trials]


@pytest.mark.parametrize("direction", ["minimize", "maximize"])
@pytest.mark.parametrize("seed", [0, 5])
def test_engines_suggest_the_same_values(direction, seed):
    """12 sequential trials: 5 random, then 7 from the TPE sampler."""
    got = study.Study(direction=direction, seed=seed).optimize(_objective, 12)
    want = j_study.Study(direction=direction, seed=seed).optimize(
        _objective, 12)
    assert _records(got) == _records(want)
    assert len({t.params["x"] for t in got.trials}) >= 8     # not stuck
    assert got.best_params == want.best_params
    assert got.best_value == want.best_value
    assert got.best_trial.number == want.best_trial.number


def test_create_study_behaves_the_same():
    got = study.create_study("maximize", seed=2)
    want = j_study.create_study("maximize", seed=2, use_optuna=False)
    assert type(got).__name__ == type(want).__name__ == "Study"
    assert got.direction == want.direction == "maximize"
    assert _records(got.optimize(_objective, 6)) == \
        _records(want.optimize(_objective, 6))
    s = study.create_study()
    assert s.direction == "minimize" and s.trials == []
    with pytest.raises(ValueError):
        study.Study(direction="sideways")


def test_failure_path_behaves_the_same():
    """A raising objective marks its trial FAIL (value None) and the study
    goes on; failed trials feed no sampler; ``catch=False`` re-raises; a
    study without a complete trial has no best trial."""
    def flaky(trial):
        v = _objective(trial)
        if trial.number in (1, 4, 6):
            raise RuntimeError("diverged")
        return v

    got = study.Study(seed=3).optimize(flaky, 12)
    want = j_study.Study(seed=3).optimize(flaky, 12)
    assert _records(got) == _records(want)
    assert [t.state for t in got.trials].count("FAIL") == 3
    assert got.trials[1].value is None
    assert got.trials[1].user_attrs["error"] == "RuntimeError('diverged')"
    assert got.best_trial.number == want.best_trial.number
    with pytest.raises(RuntimeError, match="diverged"):
        study.Study().optimize(flaky, 3, catch=False)
    for s in (study.Study(), j_study.Study()):
        s.optimize(lambda t: 1 / 0, 2)
        with pytest.raises(ValueError, match="no completed trials"):
            s.best_trial


@pytest.mark.parametrize("space", ["v1", "v2"])
def test_sweep_suggestions_equal_jax(space):
    """The sweep's suggest calls, in its order, give JAX's values for the
    first trials (the warm-up)."""
    def calls(trial):
        if space == "v2":
            return (trial.suggest_float("base_lr", 5e-4, 8e-3, log=True),
                    trial.suggest_categorical("rotation_prob",
                                              (0.25, 0.5, 0.75)),
                    trial.suggest_categorical("bar_weight",
                                              (2.0, 4.0, 8.0, 16.0)))
        return (trial.suggest_float("base_lr", 1e-5, 1e-2, log=True),
                trial.suggest_categorical("anchor_scale", (0.5, 1.0, 2.0)),
                trial.suggest_categorical("roi_batch", (16, 32, 64)))

    got = study.Study("maximize", seed=0)
    want = j_study.Study("maximize", seed=0)
    for _ in range(3):
        assert calls(got.ask()) == calls(want.ask())


def test_device_groups(monkeypatch):
    """One group of one CUDA device each, clipped to the device count;
    ``cpu`` is one group; fewer groups than cards share the cards out as
    JAX does (4 cards: 1 → one group of 4, 2 → two of 2); ``cuda`` without
    a card raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        study.device_groups(1)
    assert study.device_groups(4, "cpu") == [[torch.device("cpu")]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for n in (4, 8):
        assert study.device_groups(n, "cuda") == [
            [torch.device("cuda", i)] for i in range(4)]
    cards = [torch.device("cuda", i) for i in range(4)]
    assert study.device_groups(1, "cuda") == [cards]
    assert study.device_groups(2, "cuda") == [cards[:2], cards[2:]]


def _tiny_cfg(tmp_path):
    """The JAX package's HPO smoke configuration (tests/test_hpo_smoke.py)
    over a fresh 96² synthetic set."""
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.data.synthetic import generate_dataset

    paths = generate_dataset(str(tmp_path / "data"), num_train=2,
                             num_test=1, num_inference=0,
                             image_size=(96, 96), seed=1)
    cfg = Config()
    m = cfg.model
    m.depth, m.dtype = 26, "float32"
    m.rpn_pre_nms_topk_train, m.rpn_post_nms_topk_train = 64, 32
    m.rpn_batch_size_per_image = 16
    m.rpn_pre_nms_topk_test, m.rpn_post_nms_topk_test = 64, 32
    m.nms_candidates_test, m.detections_per_image = 64, 8
    cfg.input.train_size = (96, 96)
    cfg.input.max_gt_instances = 8
    cfg.input.pad_size_test = (96, 96)
    cfg.input.test_short_edge = cfg.input.test_max_size = 96
    cfg.solver.ims_per_batch = 1
    cfg.output_dir = str(tmp_path / "out")
    cfg.data.classes_csv = paths["classes_csv"]
    return cfg, paths


def test_two_trial_cpu_sweep(tmp_path):
    """Two trials of two steps each through the Trainer, scored by segm AP
    on the Test split beside ``data_dir``; both complete, the second
    trial's eval predictor is a new one only when its anchors changed."""
    from uwcv_tpu_torch.data.catalog import DatasetCatalog

    cfg, paths = _tiny_cfg(tmp_path)
    cfg.data.train_dataset = "_port_hpo_train"
    cfg.data.test_dataset = "_port_hpo_test"
    for name in (cfg.data.train_dataset, cfg.data.test_dataset):
        DatasetCatalog.remove(name)
    try:
        res = study.run_reference_hpo(cfg, n_trials=2, max_iter=2,
                                      data_dir=paths["Train"], seed=0,
                                      device="cpu")
    finally:
        for name in (cfg.data.train_dataset, cfg.data.test_dataset):
            DatasetCatalog.remove(name)
    assert res["objective"] == "segm_mAP"
    assert res["n_trials"] == 2
    assert [t["state"] for t in res["trials"]] == ["COMPLETE", "COMPLETE"]
    for t in res["trials"]:
        assert 0.0 <= t["value"] <= 1.0
        assert t["user_attrs"]["steps"] == 2
        assert t["user_attrs"]["train_s"] > 0 and t["user_attrs"]["eval_s"] > 0
        assert set(t["params"]) == {"base_lr", "anchor_scale", "roi_batch"}
    scales = {t["params"]["anchor_scale"] for t in res["trials"]}
    assert res["eval_predictors"] == len(scales)
    assert "base_lr" in res["best_params"]
    assert os.path.exists(os.path.join(cfg.output_dir, "hpo_trial1",
                                       "config.json"))


def test_sweep_without_test_split_minimizes_the_loss(tmp_path):
    """No Test split: the objective is the mean loss of the last steps."""
    from uwcv_tpu_torch.data.catalog import DatasetCatalog

    cfg, paths = _tiny_cfg(tmp_path)
    cfg.data.train_dataset = "_port_hpo_loss"
    cfg.data.test_dataset = "_port_hpo_loss_test"
    cfg.data.dataset_root = str(tmp_path / "nowhere")
    for name in (cfg.data.train_dataset, cfg.data.test_dataset):
        DatasetCatalog.remove(name)
    try:
        from uwcv_tpu_torch.data.catalog import register_superannotate

        register_superannotate(cfg.data.train_dataset, paths["Train"],
                               classes_csv=paths["classes_csv"])
        res = study.run_reference_hpo(cfg, n_trials=1, max_iter=2, seed=0,
                                      device="cpu")
    finally:
        for name in (cfg.data.train_dataset, cfg.data.test_dataset):
            DatasetCatalog.remove(name)
    assert res["objective"] == "final_loss"
    assert res["eval_predictors"] == 0
    assert np.isfinite(res["best_value"]) and res["best_value"] > 0
