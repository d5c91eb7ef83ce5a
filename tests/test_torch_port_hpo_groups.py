"""HPO trials over groups of several devices (``uwcv_tpu_torch/hpo/study.py``)
on the CPU, against the JAX package's ``uwcv_tpu/hpo/study.py``:
``device_groups`` forms JAX's groups, a trial's batch is rounded up to its
group, and a trial over a group of two trains in two spawned gloo ranks of
a process group of its own, equal to the same trial in one process at the
same global batch.

Every run uses the 96² R26 smoke configuration of
``tests/test_torch_port_hpo.py::_tiny_cfg``.  A group trial's rendezvous is
a ``file://`` under the trial's output directory (parallel test workers
cannot collide on a port), and its ranks are bounded by a deadline of
their own, so a hung rank fails its trial instead of stalling the suite.
"""

import json
import multiprocessing
import os
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

from torch_port_harness import hang_report, hang_report_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from test_torch_port_hpo import _tiny_cfg  # noqa: E402
from uwcv_tpu_torch.hpo import study  # noqa: E402
from uwcv_tpu_torch.parallel.mesh import spawn_ranks  # noqa: E402

RANK_TIMEOUT = 240


# ---------------------------------------------------------------- groups

@pytest.mark.parametrize("n_parallel", range(1, 10))
def test_device_groups_match_jax(n_parallel):
    """Over 8 devices, the port's groups have the sizes of JAX's groups of
    its 8 virtual CPU devices: ``per = 8 // n`` devices each, the leftover
    unused."""
    import jax

    from uwcv_tpu.hpo import study as j_study

    assert len(jax.devices()) == 8
    want = j_study.device_groups(n_parallel)
    got = study.device_groups(n_parallel, devices=["cpu"] * 8)
    assert [len(g) for g in got] == [len(g) for g in want]
    assert all(d == torch.device("cpu") for g in got for d in g)


def test_device_groups_over_cards(monkeypatch):
    """Four cards: 1 → one group of 4, 2 → two of 2, 3 → three of 1; an
    explicit list keeps its repeats (two ranks sharing one card) and a bare
    ``cuda`` is the current card; without a card ``cuda`` raises."""
    cuda = lambda i: torch.device("cuda", i)  # noqa: E731
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        study.device_groups(2, devices=["cuda:0", "cuda:1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert study.device_groups(1, "cuda") == [[cuda(i) for i in range(4)]]
    assert study.device_groups(2, "cuda") == [[cuda(0), cuda(1)],
                                              [cuda(2), cuda(3)]]
    assert study.device_groups(3, "cuda") == [[cuda(0)], [cuda(1)],
                                              [cuda(2)]]
    assert study.device_groups(1, devices=["cuda", "cuda:0"]) == [
        [cuda(0), cuda(0)]]


# ---------------------------------------------------------------- spawn

def _fail_or_hang(rank: int, failing: int) -> None:
    """A rank target: rank ``failing`` raises, the others hang."""
    if rank == failing:
        raise ValueError(f"rank {rank} gives up")
    time.sleep(3600)


@pytest.mark.parametrize("failing", [1, -1], ids=["raises", "hangs"])
def test_spawn_ranks_stops_the_group(failing):
    """A rank that raises fails the call with its rank and error, a group
    still running at the deadline fails it with a TimeoutError; either way
    no rank is left running."""
    t0 = time.monotonic()
    if failing >= 0:
        with pytest.raises(RuntimeError,
                           match="rank 1 of 2 failed: ValueError: rank 1 "
                                 "gives up"):
            spawn_ranks(_fail_or_hang, 2, args=(failing,),
                        timeout=RANK_TIMEOUT)
    else:
        with pytest.raises(TimeoutError, match="2 ranks still running"):
            spawn_ranks(_fail_or_hang, 2, args=(failing,), timeout=5)
    assert time.monotonic() - t0 < 120
    assert multiprocessing.active_children() == []


# ---------------------------------------------------------------- trials

_RUNS = {}


def _hpo(tmp_path_factory, key, with_test=True, ims_per_batch=1,
         num_train=2, **kw):
    """``run_reference_hpo`` over a fresh 96² set, trials of 2 steps, once
    per ``key`` in this module (the result is kept).  Without the Test
    split the objective is the final loss.  → the result, with the params
    each eval predictor was built with under ``eval_params``."""
    if key in _RUNS:
        return _RUNS[key]
    from uwcv_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_superannotate,
    )
    from uwcv_tpu_torch.data.synthetic import generate_dataset
    from uwcv_tpu_torch.engine import predictor

    tmp = tmp_path_factory.mktemp(key)
    cfg, paths = _tiny_cfg(tmp)
    if num_train != 2:
        paths = generate_dataset(str(tmp / "small"), num_train=num_train,
                                 num_test=1, num_inference=0,
                                 image_size=(96, 96), seed=1)
        cfg.data.classes_csv = paths["classes_csv"]
    cfg.solver.ims_per_batch = ims_per_batch
    cfg.data.train_dataset = f"_groups_{key}"
    cfg.data.test_dataset = f"_groups_{key}_test"
    names = (cfg.data.train_dataset, cfg.data.test_dataset)
    seen = []

    class Recording(predictor.Predictor):
        def __init__(self, cfg, params, **kwargs):
            seen.append(params)
            super().__init__(cfg, params, **kwargs)

    for name in names:
        DatasetCatalog.remove(name)
    try:
        with mock.patch.object(predictor, "Predictor", Recording):
            if with_test:
                res = study.run_reference_hpo(cfg, data_dir=paths["Train"],
                                              max_iter=2, seed=0, **kw)
            else:
                cfg.data.dataset_root = str(tmp / "nowhere")
                register_superannotate(names[0], paths["Train"],
                                       classes_csv=paths["classes_csv"])
                res = study.run_reference_hpo(cfg, max_iter=2, seed=0, **kw)
    finally:
        for name in names:
            DatasetCatalog.remove(name)
    res = dict(res, eval_params=seen, output_dir=cfg.output_dir)
    _RUNS[key] = res
    return res


def _group_run(tmp_path_factory, objective):
    return _hpo(tmp_path_factory, f"two_ranks_{objective}",
                with_test=objective == "segm_mAP", n_trials=1,
                n_parallel=1, devices=["cpu", "cpu"])


def test_group_trial_matches_jax_trial(tmp_path_factory, tmp_path):
    """JAX's ``run_reference_hpo(n_parallel=4)`` on its 8 virtual devices
    (groups of 2) and the port's over ``["cpu", "cpu"]``: the same
    suggested params, the same objective kind, and the trial's batch of 1
    rounded to 2 in each trial's ``config.json``."""
    from uwcv_tpu.config import Config as JaxConfig
    from uwcv_tpu.data.catalog import (
        DatasetCatalog as JaxCatalog,
        register_superannotate as jax_register,
    )
    from uwcv_tpu.hpo import study as j_study

    got = _group_run(tmp_path_factory, "final_loss")
    cfg, paths = _tiny_cfg(tmp_path)
    jcfg = JaxConfig.from_dict(json.loads(cfg.dumps()))
    jcfg.data.train_dataset = "_jax_groups"
    jcfg.data.test_dataset = "_jax_groups_test"
    jcfg.data.dataset_root = str(tmp_path / "nowhere")
    JaxCatalog.remove("_jax_groups")
    try:
        jax_register("_jax_groups", paths["Train"],
                     classes_csv=paths["classes_csv"])
        want = j_study.run_reference_hpo(jcfg, n_trials=1, max_iter=1,
                                         n_parallel=4, seed=0)
    finally:
        JaxCatalog.remove("_jax_groups")
    assert got["objective"] == want["objective"] == "final_loss"
    assert [t["params"] for t in got["trials"]] == \
        [t["params"] for t in want["trials"]]
    assert [t["state"] for t in got["trials"]] == ["COMPLETE"]
    for out in (got["output_dir"], jcfg.output_dir):
        with open(os.path.join(out, "hpo_trial0", "config.json")) as f:
            assert json.load(f)["solver"]["ims_per_batch"] == 2


@pytest.mark.parametrize("objective", ["final_loss", "segm_mAP"])
def test_two_rank_trial_equals_one_process(tmp_path_factory, objective):
    """A trial over two gloo ranks equals the same trial in one process at
    the rounded global batch of 2: without a Test split the final loss
    within 1e-5 relative; with one, the params the driver evaluates within
    1e-5 and the same segm AP.  The ranks' masters are bit-identical and
    each rank launched nothing (the CPU runs the plain versions)."""
    two = _group_run(tmp_path_factory, objective)
    one = _hpo(tmp_path_factory, f"one_process_{objective}",
               with_test=objective == "segm_mAP", ims_per_batch=2,
               n_trials=1, device="cpu")
    assert two["objective"] == one["objective"] == objective
    (t2,), (t1,) = two["trials"], one["trials"]
    assert t2["params"] == t1["params"]
    assert t2["state"] == t1["state"] == "COMPLETE"
    a2, a1 = t2["user_attrs"], t1["user_attrs"]
    assert (a2["ranks"], a1["ranks"]) == (2, 1)
    assert a2["steps"] == a1["steps"] == 2 and a2["spawn_s"] > 0
    reps = a2["rank_reports"]
    assert [r["device"] for r in reps] == ["cpu", "cpu"]
    assert reps[0]["masters_sha256"] == reps[1]["masters_sha256"]
    assert all(set(r["launches"].values()) == {0} for r in reps)
    np.testing.assert_allclose(a2["losses"], a1["losses"], rtol=1e-5)
    if objective == "final_loss":
        assert t2["value"] == pytest.approx(t1["value"], rel=1e-5)
        assert two["eval_params"] == one["eval_params"] == []
        return
    (p2,), (p1,) = two["eval_params"], one["eval_params"]
    assert p2.keys() == p1.keys()
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert t2["value"] == t1["value"]
    assert 0.0 <= t2["value"] <= 1.0


def test_two_groups_of_two_ranks(tmp_path_factory):
    """``n_parallel=2`` over four CPU devices: two groups of two ranks run
    a trial each from the pool, both complete, each scored on its group's
    first device by a predictor of its own."""
    res = _hpo(tmp_path_factory, "two_groups", n_trials=2, n_parallel=2,
               devices=["cpu"] * 4)
    assert [t["state"] for t in res["trials"]] == ["COMPLETE"] * 2, res
    assert [t["user_attrs"]["ranks"] for t in res["trials"]] == [2, 2]
    assert sorted(t["user_attrs"]["group"] for t in res["trials"]) == [0, 1]
    assert res["eval_predictors"] == 2
    for t in res["trials"]:
        reps = t["user_attrs"]["rank_reports"]
        assert len({r["masters_sha256"] for r in reps}) == 1
        assert 0.0 <= t["value"] <= 1.0


def test_failing_group_fails_its_trial(tmp_path_factory):
    """A one-image train split over two ranks: each rank's ``TrainLoader``
    raises, the trial is FAIL with the rank's error, nothing falls back to
    one process, the sweep raises "no completed trials", and no rank is
    left running."""
    with pytest.raises(ValueError, match="no completed trials") as err:
        _hpo(tmp_path_factory, "failing", num_train=1, n_trials=1,
             n_parallel=1, devices=["cpu", "cpu"])
    msg = str(err.value)
    assert "trial 0 FAIL" in msg
    assert "of 2 failed: ValueError: dataset has 1 samples < process_count 2" \
        in msg
    assert multiprocessing.active_children() == []
