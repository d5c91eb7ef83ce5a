"""The port's CLI (port of ``uwcv_tpu/cli/main.py``).

    python -m uwcv_tpu_torch.cli.main train   — fine-tune on a SuperAnnotate split
    python -m uwcv_tpu_torch.cli.main infer   — folder inference → RLE CSV + measurements
    python -m uwcv_tpu_torch.cli.main measure — the same, with distribution plots
    python -m uwcv_tpu_torch.cli.main eval    — COCO mAP on a labelled split
    python -m uwcv_tpu_torch.cli.main serve   — watch a folder, answer in JSON
    python -m uwcv_tpu_torch.cli.main hpo     — hyperparameter search, one trial per GPU
    python -m uwcv_tpu_torch.cli.main synth   — write the synthetic demo dataset

(``uwcv-torch`` once the package is installed.)  Every config knob is a
dotted override, ``-o postprocess.paste_chunk=10``.  ``--device`` is
``cuda`` unless ``--device cpu`` is given; without a card ``cuda`` raises.
``synth`` needs no device.  ``export`` comes with a later slice.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from uwcv_tpu_torch.config import Config, get_config


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("-o", "--override", action="append", default=[],
                   metavar="KEY=VALUE", help="config override (repeatable)")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--weights", default=None,
                   help=".npz or torch .pth")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")


def _build_cfg(args) -> Config:
    cfg = get_config(args.override)
    if args.output_dir:
        cfg.output_dir = args.output_dir
    if args.weights:
        cfg.weights = args.weights
    return cfg


def _predictor(cfg: Config, device: str):
    from uwcv_tpu_torch.engine.predictor import load_predictor
    from uwcv_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)            # raises before any work
    if not cfg.weights:
        default = os.path.join(cfg.output_dir, "model_final.npz")
        if os.path.exists(default):
            cfg.weights = default
    return load_predictor(cfg, device=dev)


def _load_dataset(cfg: Config, split: str, data_dir: Optional[str]):
    from uwcv_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_superannotate,
    )

    name = (cfg.data.train_dataset if split == "Train"
            else cfg.data.test_dataset)
    root = data_dir or os.path.join(cfg.data.dataset_root, split)
    if name not in DatasetCatalog.list():
        register_superannotate(name, root, classes_csv=cfg.data.classes_csv)
    return DatasetCatalog.get(name)


def cmd_train(args) -> int:
    cfg = _build_cfg(args)
    from uwcv_tpu_torch.data.loader import TrainLoader
    from uwcv_tpu_torch.engine.trainer import Trainer

    trainer = Trainer(cfg, device=args.device)      # raises before any work
    dicts = _load_dataset(cfg, "Train", args.data_dir)
    print(f"train dataset: {len(dicts)} images, output: {cfg.output_dir}")
    trainer.resume_or_load(resume=args.resume)
    loader = TrainLoader(dicts, cfg, seed=cfg.solver.seed)
    # a resumed run picks the index stream up where the checkpoint left it
    loader.skip(trainer.step)
    dd = loader.device_dataset(trainer.device)
    if dd is not None:
        # a fine-tune-sized dataset on the device: a step ships its [B]
        # index vector only
        trainer.fit(loader.index_batches(), device_dataset=dd)
    else:
        loader.start()
        try:
            trainer.fit(iter(loader))
        finally:
            loader.stop()
    print(f"done: {os.path.join(cfg.output_dir, 'model_final.npz')}")
    return 0


def cmd_infer(args) -> int:
    cfg = _build_cfg(args)
    from uwcv_tpu_torch.data.classes import ClassRegistry
    from uwcv_tpu_torch.engine.batch_inference import (
        run_batch_inference,
        save_union_masks,
        save_visualizations,
    )

    predictor = _predictor(cfg, args.device)
    registry = ClassRegistry.load(cfg.data.classes_csv)
    result = run_batch_inference(
        cfg, predictor, image_dir=args.image_dir,
        batch_size=args.batch_size, registry=registry,
        with_measurements=not args.no_measure, with_plots=args.plots)
    if args.visualize:
        save_visualizations(result["predictions"], registry,
                            os.path.join(cfg.output_dir, "viz"))
        save_union_masks(result["predictions"],
                         os.path.join(cfg.output_dir, "viz"))
    print(f"wrote {result['csv']} ({result['num_images']} images)")
    return 0


def cmd_measure(args) -> int:
    # the same flow with the measurements and their plots on
    args.no_measure = False
    args.plots = True
    return cmd_infer(args)


def cmd_eval(args) -> int:
    cfg = _build_cfg(args)
    from uwcv_tpu_torch.eval.coco_eval import evaluate_split

    predictor = _predictor(cfg, args.device)
    dicts = _load_dataset(cfg, "Test", args.data_dir)
    results = evaluate_split(cfg, dicts, predictor=predictor)
    print(json.dumps(results, indent=2))
    path = os.path.join(cfg.output_dir, "coco_metrics.json")
    os.makedirs(cfg.output_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {path}")
    return 0


def cmd_serve(args) -> int:
    cfg = _build_cfg(args)
    from uwcv_tpu_torch.engine.serve import serve_forever

    predictor = _predictor(cfg, args.device)
    n = serve_forever(cfg, predictor, args.watch_dir,
                      args.out_dir or os.path.join(cfg.output_dir, "served"),
                      batch_size=args.batch_size, poll_s=args.poll,
                      once=args.once)
    print(f"served {n} images")
    return 0


def cmd_hpo(args) -> int:
    cfg = _build_cfg(args)
    from uwcv_tpu_torch.hpo.study import run_reference_hpo

    best = run_reference_hpo(cfg, n_trials=args.trials,
                             data_dir=args.data_dir,
                             max_iter=args.trial_iters, device=args.device)
    print(json.dumps(best, indent=2, default=str))
    return 0


def cmd_synth(args) -> int:
    from uwcv_tpu_torch.data.synthetic import generate_dataset

    paths = generate_dataset(args.root, num_train=args.train,
                             num_test=args.test, num_inference=args.infer,
                             image_size=(args.size, args.size))
    print(json.dumps(paths, indent=2))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="uwcv-torch",
        description="uwcv fine-tuning and folder inference on an NVIDIA GPU "
                    "(PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="fine-tune Mask R-CNN")
    _add_common(p)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("infer", help="batch inference over a folder")
    _add_common(p)
    p.add_argument("--image-dir", default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--no-measure", action="store_true")
    p.add_argument("--plots", action="store_true")
    p.add_argument("--visualize", action="store_true")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("measure", help="measurement sweep over a folder")
    _add_common(p)
    p.add_argument("--image-dir", default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--visualize", action="store_true")
    p.set_defaults(fn=cmd_measure)

    p = sub.add_parser("eval", help="COCO mAP on a labeled dataset")
    _add_common(p)
    p.add_argument("--data-dir", default=None)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("serve", help="watch a folder, serve inference "
                                     "results as JSON")
    _add_common(p)
    p.add_argument("--watch-dir", required=True)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--poll", type=float, default=1.0)
    p.add_argument("--once", action="store_true",
                   help="drain the current backlog and exit")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("hpo", help="hyperparameter search")
    _add_common(p)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--trials", type=int, default=8)
    p.add_argument("--trial-iters", type=int, default=100)
    p.set_defaults(fn=cmd_hpo)

    p = sub.add_parser("synth", help="generate the synthetic demo dataset")
    p.add_argument("--root", default="./DATASET")
    p.add_argument("--train", type=int, default=6)
    p.add_argument("--test", type=int, default=2)
    p.add_argument("--infer", type=int, default=2)
    p.add_argument("--size", type=int, default=256)
    p.set_defaults(fn=cmd_synth)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
