"""Readings that set the limits of the correctness check (not part of a
benchmark run).

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 \
        [--program] [--quant fp8] [--seconds 2]

For each seed: with ``--quant`` the control, the plain reference computed
in that precision put in the program's place and judged as the program is
(its numbers must fail the limits); with ``--program`` a run of the cell
(set-up, a short window, the check) in this one process.  One JSON line a
seed: {"seed", "what", "numbers"}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import common  # noqa: E402


def predict_control(ctx, seed: int, quant: str, device):
    from benchmark.harness import judge, predict_cell
    from benchmark.harness import weights as W
    from benchmark.reference import maskrcnn as R

    conf, traffic = ctx["config"], ctx["traffic"]
    m = conf["config"]["model"]
    w = W.make(m, conf["init"], seed, device)
    net_q = R.Net(w, m["depth"], m["num_classes"], quant)
    net = R.Net(w, m["depth"], m["num_classes"])
    acc = {}
    for raw in predict_cell.draw_batches(traffic, seed):
        out = judge.program_like(net_q, raw, conf["config"], device)
        judge.judge_predict(net, raw, out, conf["config"], acc)
    judge.log_diagnostics(acc)
    return {k: acc[k] for k in judge.PREDICT_NUMBERS}


def train_control(ctx, seed: int, quant: str, device):
    import numpy as np

    from benchmark.harness import judge, micrographs, train_cell
    from benchmark.harness import weights as W

    conf, traffic = ctx["config"], ctx["traffic"]
    rng = np.random.default_rng(seed)
    raw = [micrographs.draw(rng, tuple(traffic["image_hw"]),
                            traffic["instances"])
           for _ in range(traffic["images"])]
    # the loader's first epoch, and its padded gt capacity
    order = np.random.default_rng(seed).permutation(traffic["images"])
    b = traffic["batch"]
    rows = [order[k * b:(k + 1) * b] for k in range(train_cell.CHECK_STEPS)]
    most = max(len(a) for _, a in raw)
    n_max = min(conf["config"]["input"]["max_gt_instances"],
                max(8, -(-most // 8) * 8))
    w = W.make(conf["config"]["model"], conf["init"], seed, device)
    batches = [train_cell.reference_batch(raw, r, conf["config"], n_max,
                                          device) for r in rows]
    prog = judge.control_train(w, batches, conf["config"], seed, quant)
    got = judge.judge_train(w, batches, conf["config"], seed, prog)
    common.log(f"loss gaps by term {got['term_gaps']}")
    return {k: got[k] for k in judge.TRAIN_NUMBERS}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--quant")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    ctx = common.cell(args.workload)
    kind = ctx["traffic"]["kind"]
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.program:
            out = common.driver(kind).run(ctx, types.SimpleNamespace(
                seed=seed, seconds=args.seconds, trace=0), t0)
            numbers, what = out["numbers"], "program"
        else:
            fn = train_control if kind == "train_cell" else \
                predict_control
            numbers, what = fn(ctx, seed, args.quant, dev), args.quant
        print(json.dumps({"seed": seed, "what": what, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
