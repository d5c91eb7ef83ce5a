"""A cell at a size the CPU runs in seconds: the configuration's file with
a depth-26 trunk, thin FPN and box head, float32, and small images."""

from __future__ import annotations

import copy
import types

from benchmark.harness import common

TRAIN = "r101-finetune-800-b16"
PREDICT = "r50-predict-resident-b8"


def ctx(workload: str, dtype: str = "float32") -> dict:
    c = copy.deepcopy(common.cell(workload))
    m = c["config"]["config"]["model"]
    c["config"]["init"]["cls_std"] = 1.0
    m.update(depth=26, fpn_channels=32, box_fc_dim=64, dtype=dtype,
             rpn_pre_nms_topk_train=200, rpn_post_nms_topk_train=100,
             rpn_pre_nms_topk_test=100, rpn_post_nms_topk_test=100,
             detections_per_image=10, nms_candidates_test=128)
    inp = c["config"]["config"]["input"]
    inp.update(train_size=[128, 128], test_short_edge=128, test_max_size=192,
               pad_size_test=[192, 192])
    t = c["traffic"]
    t.update(image_hw=[160, 200], instances={"pores": [2, 4],
                                             "throats": [2, 4],
                                             "walls": [1, 2]})
    if t["kind"] == "train_cell":
        t.update(images=8, batch=2, warmup_steps=1)
    else:
        t.update(batches=2, batch=2)
    return c


def args(seed: int = 7, seconds: float = 0.5, device: str = "cpu"):
    return types.SimpleNamespace(seed=seed, seconds=seconds, trace=0,
                                 device=device)
