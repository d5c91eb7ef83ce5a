"""Traffic kind ``predict_cell``: batches of seeded micrographs staged
on the card once, then one caller that sends a batch into the predictor's
device program (``Predictor._run``) and waits for its outputs, cycling
through the staged batches for the window."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness import common, flops, judge, micrographs, recorders
from benchmark.harness import trace as tr
from benchmark.harness import weights as W
from benchmark.reference import maskrcnn as R


def port_config(conf: dict):
    from uwcv_tpu_torch.config import Config

    return Config.from_dict(conf["config"])


def draw_batches(traffic: dict, seed: int):
    rng = np.random.default_rng(seed)
    n, b = traffic["batches"], traffic["batch"]
    return [[micrographs.draw(rng, tuple(traffic["image_hw"]),
                              traffic["instances"])[0] for _ in range(b)]
            for _ in range(n)]


def build(conf: dict, seed: int, device):
    """The predictor with the seeded weights, and the weights."""
    from uwcv_tpu_torch.engine.predictor import Predictor

    cfg = port_config(conf)
    w = W.make(conf["config"]["model"], conf["init"], seed, device)
    return Predictor(cfg, W.to_numpy(w), device=device), w


def outputs(run_out, proposals) -> Dict:
    """The program's outputs of one batch in ``judge_predict``'s layout."""
    dets, packed, keep = run_out
    valid = dets.valid & keep
    return {"proposals": proposals, "boxes": dets.boxes.float(),
            "scores": dets.scores.float(), "classes": dets.classes,
            "det_valid": dets.valid, "valid": valid,
            "masks": judge.unpack(packed)}


def run(ctx: Dict, args, t_start: float) -> Dict:
    conf, traffic = ctx["config"], ctx["traffic"]
    dev = torch.device(getattr(args, "device", "cuda"))
    pred, w = build(conf, args.seed, dev)
    raw = draw_batches(traffic, args.seed)
    staged = [pred.stage_batch([np.repeat(im[..., None], 3, -1) for im in b])
              for b in raw]
    store, last = {}, {}
    with recorders.proposals(store):
        # every staged batch once: builds the kernels and warms every shape
        for i, (ops, _) in enumerate(staged):
            pred._run(*ops)
        common.sync(dev)
        setup_s = time.perf_counter() - t_start
        if args.trace:
            per_layer = traced_window(pred, staged, conf, traffic, ctx)
            n_batches, latencies, window = 0, [], None
        else:
            n_batches, latencies = 0, []
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < args.seconds:
                i = n_batches % len(staged)
                latency, out = timed_call(pred, staged[i][0], dev)
                latencies.append(latency)
                last[i] = (out, store["last"])
                n_batches += 1
            window = time.perf_counter() - t0
    if args.trace:
        # the traced window's last pass over the batches is the one judged
        last = per_layer.pop("_last")
    device = common.device_block(1, per_layer.get("_trace")
                                 if args.trace else None, dev)
    judged = {i: outputs(*last[i]) for i in sorted(last)}
    del pred, staged, store, last
    torch.cuda.empty_cache()
    acc: Dict = {}
    net = R.Net(w, conf["config"]["model"]["depth"],
                conf["config"]["model"]["num_classes"])
    for i, out in judged.items():
        judge.judge_predict(net, raw[i], out, conf["config"], acc)
    numbers = {k: acc[k] for k in judge.PREDICT_NUMBERS}
    judge.log_diagnostics(acc)
    common.log(f"checked {len(judged)} batches: {acc['proposals']} valid "
               f"proposals, {acc['detections']} valid detections, "
               f"{acc['mask_px']} mask pixels, {acc['xor']} differing of "
               f"{acc['union']} in the union")
    b = traffic["batch"]
    if args.trace:
        metrics = per_layer["metrics"]
        result = {"attempted": per_layer["batches"], "failed": 0}
    else:
        lat = np.asarray(latencies)
        common.log(f"{n_batches} batches in {window:.3f} s; latency "
                   f"median {np.median(lat):.4f} ms, p95 "
                   f"{np.percentile(lat, 95):.4f} ms")
        metrics = {
            "predict_ms_per_img": {"value": window * 1e3 / (n_batches * b),
                                   "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        result = {"attempted": n_batches, "failed": 0}
    result.update({"metrics": metrics, "device": device})
    if args.trace:
        result["breakdown"] = per_layer["breakdown"]
    return {"result": result, "numbers": numbers,
            "limits": conf["limits"]["predict"]}


def timed_call(pred, ops, dev):
    """One batch into the device program, timed on the card from the call
    to the completion of its outputs (CUDA events; the host clock on the
    CPU).  → (ms, outputs)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = pred._run(*ops)
        return (time.perf_counter() - t0) * 1e3, out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = pred._run(*ops)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def traced_window(pred, staged, conf, traffic, ctx) -> Dict:
    """The traced run: ``traffic["traced_batches"]`` batches under the
    profiler with the model's CUDA-event marks and the pooler recorder;
    then each per-layer metric's reader."""
    store = {}
    calls, marks, last = [], [], {}
    n = traffic["traced_batches"]

    def window():
        with recorders.proposals(store), recorders.pooler_calls(calls):
            for k in range(n):
                i = k % len(staged)
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                pred.model.marks = []
                out = pred._run(*staged[i][0])
                marks.append([("start", start)] + pred.model.marks)
                last[i] = (out, store["last"])
                torch.cuda.synchronize()
        pred.model.marks = None

    trace = tr.traced(window, micrographs.workdir("trace"))
    m = conf["config"]["model"]
    canvas = tuple(staged[0][0][0].shape[1:3])
    fl = sum(flops.forward(m, canvas, int(out[1]["valid"][j].sum()),
                           int((out[0][0].valid[j] & out[0][2][j]).sum()))
             for k in range(n) for out in [last[k % len(staged)]]
             for j in range(out[0][0].valid.shape[0]))
    # a batch from its call to its last mark, where its outputs are done
    latencies = [run[0][1].elapsed_time(run[-1][1]) for run in marks]
    rctx = {"trace": trace, "marks": tr.stage_ms(marks), "flops": fl,
            "latencies": latencies,
            "pooler_calls": calls, "model": m, "batches": n,
            "power": common.power_limit()}
    common.log(f"card: {rctx['power']}")
    metrics = {}
    for spec in common.metric_names(ctx["spec"], ctx["workload"]["name"],
                                    "per_layer"):
        value = common.reader(spec["name"])(rctx)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return {"metrics": metrics, "batches": n, "_trace": trace, "_last": last,
            "breakdown": {"device_ops": trace["device_ops"],
                          "idle_gaps": trace["idle_gaps"]}}
