"""The port's CLI (port of ``uwcv_tpu/cli/main.py``).

    python -m uwcv_tpu_torch.cli.main train   — fine-tune on a SuperAnnotate split
    python -m uwcv_tpu_torch.cli.main infer   — folder inference → RLE CSV + measurements
    python -m uwcv_tpu_torch.cli.main measure — the same, with distribution plots
    python -m uwcv_tpu_torch.cli.main eval    — COCO mAP on a labelled split
    python -m uwcv_tpu_torch.cli.main serve   — watch a folder, answer in JSON
                                              (from weights or an exported program)
    python -m uwcv_tpu_torch.cli.main export  — save the inference program, weights
                                              included, to one .pt2 file for serve
    python -m uwcv_tpu_torch.cli.main hpo     — hyperparameter search, one trial per GPU
    python -m uwcv_tpu_torch.cli.main synth   — write the synthetic demo dataset

(``uwcv-torch`` once the package is installed.)  Every config knob is a
dotted override, ``-o postprocess.paste_chunk=10``.  ``--device`` is
``cuda`` unless ``--device cpu`` is given; without a card ``cuda`` raises.
``synth`` needs no device.  An ``export``ed program serves on the device
type it was exported for.
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
    """Train over every visible card, as the JAX verb does: under
    ``torchrun`` this process is one rank of the group; launched alone on
    a host with several cards and a data axis of -1
    (``parallel.mesh_shape``), it starts one worker per card.  On the CPU,
    ``-o parallel.num_processes=N`` starts N gloo workers.  A model axis
    (``parallel.mesh_shape = d,m``) splits each image's height over the m
    ranks of a data row: d·m workers, rank r at data index r // m."""
    cfg = _build_cfg(args)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        cfg.parallel.multi_host = True          # a rank under torchrun
        return _train(cfg, args)
    world = _local_world(cfg, args.device)
    if world == 1:
        return _train(cfg, args)
    from uwcv_tpu_torch.parallel.mesh import spawn_ranks

    if args.device != "cpu":
        # every rank would run nvcc: build once here
        from uwcv_tpu_torch import kernels

        kernels.build()
    par = cfg.parallel
    par.multi_host, par.num_processes = True, world
    if not par.coordinator_address:
        par.coordinator_address = f"127.0.0.1:{_free_port()}"
    spawn_ranks(_train_worker, world, args=(cfg, args))
    return 0


def _local_world(cfg: Config, device: str) -> int:
    """The processes ``train`` starts when launched alone: one per device
    of the (d, m) mesh (``parallel.mesh_shape``; d = -1 takes every card
    divided by m; a named card, ``cuda:1``, is one), or
    ``parallel.num_processes`` on the CPU."""
    from uwcv_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return max(1, cfg.parallel.num_processes)
    if dev.index is not None:
        return 1
    import torch

    d, m = cfg.parallel.mesh_shape
    m, n = max(m, 1), torch.cuda.device_count()
    if d == -1:
        d = n // m
    if d < 1 or d * m > n:
        raise ValueError(f"parallel.mesh_shape {tuple(cfg.parallel.mesh_shape)}"
                         f" asks for {max(d, 1) * m} cards, {n} visible")
    return d * m


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_worker(rank: int, cfg: Config, args) -> None:
    cfg.parallel.process_id = rank
    _train(cfg, args)


def _train(cfg: Config, args) -> int:
    """One process of ``train``: joins the process group when
    ``parallel.multi_host`` is set, then trains its share."""
    import torch

    from uwcv_tpu_torch.data.loader import TrainLoader
    from uwcv_tpu_torch.engine.trainer import Trainer
    from uwcv_tpu_torch.parallel.mesh import (
        initialize_multi_host,
        local_rank,
    )
    from uwcv_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)            # raises before any work
    if cfg.parallel.multi_host:
        if dev.type == "cuda":
            dev = torch.device("cuda", local_rank(cfg.parallel))
        initialize_multi_host(cfg.parallel, dev)
    try:
        trainer = Trainer(cfg, device=dev)
        say = print if trainer.is_writer else (lambda *_: None)
        dicts = _load_dataset(cfg, "Train", args.data_dir)
        ranks = trainer.group.size if trainer.group else 1
        say(f"train dataset: {len(dicts)} images, output: {cfg.output_dir}"
            + (f", {ranks} ranks" if ranks > 1 else "")
            + (f" as a {trainer.ranks}×{trainer.model_axis.size} mesh"
               if trainer.model_axis else ""))
        trainer.resume_or_load(resume=args.resume)
        loader = TrainLoader(dicts, cfg, seed=cfg.solver.seed,
                             process_index=trainer.rank,
                             process_count=trainer.ranks)
        # a resumed run picks the index stream up where the checkpoint
        # left it
        loader.skip(trainer.step)
        dd = loader.device_dataset(trainer.device)
        if dd is not None:
            # a fine-tune-sized dataset on the device: a step ships its
            # [B] index vector only
            trainer.fit(loader.index_batches(), device_dataset=dd,
                        log_fn=say)
        else:
            loader.start()
            try:
                trainer.fit(iter(loader), log_fn=say)
            finally:
                loader.stop()
        say(f"done: {os.path.join(cfg.output_dir, 'model_final.npz')}")
    finally:
        if cfg.parallel.multi_host:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
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
    from uwcv_tpu_torch.engine.predictor import Predictor
    from uwcv_tpu_torch.engine.serve import serve_forever

    if args.artifact:
        predictor = Predictor.from_exported(cfg, args.artifact,
                                            device=args.device)
    else:
        predictor = _predictor(cfg, args.device)
    n = serve_forever(cfg, predictor, args.watch_dir,
                      args.out_dir or os.path.join(cfg.output_dir, "served"),
                      batch_size=args.batch_size, poll_s=args.poll,
                      once=args.once)
    print(f"served {n} images")
    return 0


def cmd_export(args) -> int:
    cfg = _build_cfg(args)
    from uwcv_tpu_torch.engine.export import export_predictor

    predictor = _predictor(cfg, args.device)
    path = export_predictor(predictor, args.path, batch_size=args.batch_size)
    mb = os.path.getsize(path) / 1e6
    print(f"wrote {path} ({mb:.1f} MB, batch {args.batch_size})")
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
                                     "results as JSON (from weights or an "
                                     "exported program)")
    _add_common(p)
    p.add_argument("--watch-dir", required=True)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--artifact", default=None,
                   help="exported program from `export`")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--poll", type=float, default=1.0)
    p.add_argument("--once", action="store_true",
                   help="drain the current backlog and exit")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("export", help="save the inference program, weights "
                                      "included, to one .pt2 file for serve")
    _add_common(p)
    p.add_argument("--path", default="./output/predictor.pt2")
    p.add_argument("--batch-size", type=int, default=8)
    p.set_defaults(fn=cmd_export)

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
