"""The port's recorder of spans and counters (``uwcv_tpu_torch/utils/
trace.py``): off it records nothing and calls nothing; on it changes no
output, nests its spans per thread under one trace id, counts the floods'
passes and host reads exactly, and keeps out of ``torch.export``."""

import collections
import json
import os
import threading

import numpy as np
import pytest
import torch

from uwcv_tpu_torch.ops.morphology import connected_components, fill_holes
from uwcv_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_SPLIT = os.path.join(REPO, "tests", "data", "gate_split")


def _tiny_cfg():
    from uwcv_tpu_torch.config import Config

    cfg = Config()
    m = cfg.model
    m.depth, m.fpn_channels, m.box_fc_dim, m.dtype = 26, 32, 32, "float32"
    m.rpn_pre_nms_topk_test, m.rpn_post_nms_topk_test = 50, 40
    m.rpn_pre_nms_topk_train, m.rpn_post_nms_topk_train = 100, 50
    m.detections_per_image, m.roi_score_thresh_test = 10, 0.0
    cfg.input.test_short_edge = cfg.input.test_max_size = 96
    cfg.input.pad_size_test = (128, 128)
    cfg.input.train_size = (64, 64)
    return cfg


def _line(k: int) -> torch.Tensor:
    """A 1×k horizontal line in the middle row of a [3, k + 2] mask."""
    mask = torch.zeros(3, k + 2, dtype=torch.bool)
    mask[1, 1:k + 1] = True
    return mask


def _flat(out) -> list:
    """Every tensor of a nested output, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _flat(x)]
    return []


def _tiny_models(device: str, out_dir: str):
    """The tiny trainer with a staged batch of 2 at 64×64, and the tiny
    predictor with a staged batch of 2: → (trainer, batch, predictor, its
    ``_run`` arguments)."""
    from chip_smoke import seeded_flax_params
    from uwcv_tpu_torch.data.loader import TrainLoader
    from uwcv_tpu_torch.data.superannotate import get_superannotate_dicts
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.engine.trainer import Trainer

    cfg = _tiny_cfg()
    cfg.output_dir = out_dir
    tr = Trainer(cfg, device=device)
    loader = TrainLoader(get_superannotate_dicts(
        os.path.join(GATE_SPLIT, "Test")), cfg)
    staged = loader.device_dataset(device)
    idx = torch.from_numpy(next(loader.index_batches()).astype(np.int64))
    batch = {k: v.index_select(0, idx.to(device)) for k, v in staged.items()}
    pred = Predictor(cfg, seeded_flax_params(cfg.model, 0), device=device)
    rng = np.random.default_rng(0)
    ops, _ = pred.stage_batch([rng.integers(0, 256, (120, 100, 3),
                                            dtype=np.uint8)
                               for _ in range(2)])
    return tr, batch, pred, ops


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One CPU ``train_step`` (64×64, batch 2) and one ``Predictor._run``
    (128×128 canvas, batch 2), each with recording off and on, from the
    same state: → {"train": (off, on, record), "predict": (off, on,
    record)}."""
    from uwcv_tpu_torch.engine.trainer import step_generator

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        tr, batch, pred, ops = _tiny_models(
            "cpu", str(tmp_path_factory.mktemp("trace")))

        def step():
            tr.init_state()
            m = tr.train_step(batch, step_generator(0, 0, tr.device))
            return [t.clone() for t in _flat(m)] + [
                p.detach().clone() for p in tr.model.parameters()]

        train_off = step()
        with trace.recording() as train_rec:
            train_on = step()

        predict_off = _flat(pred._run(*ops))
        with trace.recording() as predict_rec:
            predict_on = _flat(pred._run(*ops))
    finally:
        torch.use_deterministic_algorithms(prev)
    return {"train": (train_off, train_on, train_rec),
            "predict": (predict_off, predict_on, predict_rec)}


def test_off_records_nothing_and_calls_nothing(monkeypatch):
    def refuse(*_args, **_kwargs):
        raise AssertionError("called with recording off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(trace.time, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    before = (len(trace.PROFILED.spans), dict(trace.PROFILED.counters))
    ctx = trace.span("a", device="cpu")
    assert ctx is trace.span("b")          # one shared no-op context
    with ctx:
        trace.count("c", 3)
    fill_holes(_line(4))
    connected_components(_line(4))
    assert (len(trace.PROFILED.spans), dict(trace.PROFILED.counters)) \
        == before


@pytest.mark.parametrize("path", ["train", "predict"])
def test_recording_changes_no_output(runs, path):
    off, on, _ = runs[path]
    assert len(off) == len(on) > 0
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("path, top, children", [
    ("train", "train_step", ("forward", "augment", "backward")),
    ("predict", "predict", ("mask tail", "host sync"))])
def test_spans_nest_under_one_trace(runs, path, top, children):
    rec = runs[path][2]
    (root,) = rec.named(top)
    assert root.parent is None
    assert root.end_ns > root.start_ns
    for name in children:
        got = rec.named(name)
        assert got, name
        for s in got:
            p = s
            while p.parent is not None:
                p = p.parent
            assert p is root and s.trace == root.trace
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    for s in rec.named("host sync"):
        assert s.parent.name == "mask tail"
    for s in rec.named("augment"):
        assert s.parent.name == "forward"
    # the CPU has no CUDA events: every span is host-only
    assert rec.device_ms() == {}


@pytest.mark.parametrize("k", [1, 2, 5, 9])
def test_flood_passes_counted_exactly(k):
    """A 1×k line labels its 8-connected component in k − 1 changing
    passes and one that changes nothing; an empty (k + 2)-square mask's
    background floods in from its border in ceil(k / 2) changing passes
    and one more.  Each loop reads its condition once more than it runs:
    a ``host sync`` span each."""
    with trace.recording() as rec:
        labels = connected_components(_line(k))
    assert labels[1, 1:k + 1].tolist() == [k + 4] * k
    assert rec.counters == {"flood passes.components": k}
    assert rec.calls() == {"host sync": k + 1}
    with trace.recording() as rec:
        filled = fill_holes(torch.zeros(k + 2, k + 2, dtype=torch.bool))
    assert not filled.any()
    passes = -(-k // 2) + 1
    assert rec.counters == {"flood passes.fill_holes": passes}
    assert rec.calls() == {"host sync": passes + 1}


def test_a_hole_fills_in_one_pass():
    """A ring's inside is a hole; the background outside it is the border
    alone, so its flood changes nothing in its first pass."""
    mask = torch.zeros(5, 5, dtype=torch.bool)
    mask[1:4, 1:4] = True
    mask[2, 2] = False
    with trace.recording() as rec:
        filled = fill_holes(mask)
    assert filled[1:4, 1:4].all() and filled.sum() == 9
    assert rec.counters == {"flood passes.fill_holes": 1}
    assert rec.calls() == {"host sync": 2}


def test_nothing_recorded_while_exporting(monkeypatch):
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    with trace.recording() as rec:
        with trace.span("a"):
            trace.count("b")
    assert len(rec.spans) == 0 and rec.counters == {}


def test_threads_keep_their_own_parents():
    both_open = threading.Barrier(2, timeout=30)

    def work(i):
        with trace.span(f"outer {i}"):
            both_open.wait()
            with trace.span(f"inner {i}"):
                both_open.wait()

    with trace.recording() as rec:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for i in range(2):
        (outer,) = rec.named(f"outer {i}")
        (inner,) = rec.named(f"inner {i}")
        assert outer.parent is None
        assert inner.parent is outer and inner.trace == outer.trace
    assert rec.named("outer 0")[0].trace != rec.named("outer 1")[0].trace


def test_spans_under_the_profiler_land_on_its_timeline():
    """Outside any ``recording()`` block a profiler window records into
    ``PROFILED``, and each span is a ``user_annotation`` of the profile
    unless it is made with ``annotate=False``."""
    from torch.profiler import ProfilerActivity, profile

    trace.PROFILED.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(8).sum()
            with trace.span("quiet", annotate=False):
                torch.ones(8).sum()
            trace.count("n", 2)
    names = {e.name for e in prof.events()}
    assert {"outer", "inner"} <= names and "quiet" not in names
    assert [s.name for s in trace.PROFILED.spans] == ["outer", "inner",
                                                      "quiet"]
    assert trace.PROFILED.counters == {"n": 2}
    trace.PROFILED.clear()
    with trace.span("after"):
        pass
    assert len(trace.PROFILED.spans) == 0


@pytest.mark.cuda
def test_spans_agree_with_their_annotations_on_the_card(tmp_path):
    """On the card, under a CPU + CUDA profile, each annotated span of a
    tiny model's train steps and predictions lasts on the host what its
    ``user_annotation`` lasts on the profiler's clock, within 5 % or
    50 µs; the floods' ``host sync`` spans are recorded but not
    annotated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' device side")
    from torch.profiler import ProfilerActivity, profile

    from uwcv_tpu_torch.engine.trainer import step_generator

    tr, batch, pred, ops = _tiny_models("cuda", str(tmp_path))
    tr.init_state()
    for i in range(2):      # builds the kernels, picks the cuDNN algorithms
        tr.train_step(batch, step_generator(0, i, tr.device))
        pred._run(*ops)
    torch.cuda.synchronize()
    trace.PROFILED.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            tr.train_step(batch, step_generator(1, i, tr.device))
            pred._run(*ops)
        torch.cuda.synchronize()
    spans = list(trace.PROFILED.spans)
    trace.PROFILED.clear()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    annotated = collections.defaultdict(list)
    for e in sorted((e for e in events if e.get("cat") == "user_annotation"),
                    key=lambda e: float(e["ts"])):
        annotated[e["name"]].append(float(e["dur"]))
    host = collections.defaultdict(list)
    for s in spans:
        host[s.name].append((s.end_ns - s.start_ns) * 1e-3)
    assert host.pop("host sync") and "host sync" not in annotated
    assert set(host) == {"train_step", "forward", "augment", "backward",
                         "predict", "mask tail"}
    for name, durs in host.items():
        assert len(durs) == len(annotated[name]) == 3, name
        for mine, theirs in zip(durs, annotated[name]):
            assert abs(mine - theirs) <= max(0.05 * theirs, 50.0), \
                (name, mine, theirs)
