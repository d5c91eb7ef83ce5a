"""LR schedule: Detectron2's WarmupMultiStepLR (port of
``uwcv_tpu/engine/lr_schedule.py``).  Computed in float32, as the JAX
schedule is, so both give the same learning rate at every step."""

from __future__ import annotations

from typing import Callable

import numpy as np

from uwcv_tpu_torch.config import SolverConfig


def warmup_multistep(cfg: SolverConfig) -> Callable[[int], float]:
    """step → lr.  Linear warmup from warmup_factor·base_lr to base_lr over
    warmup_iters, then ×gamma at each milestone in cfg.steps."""
    f32 = np.float32
    base, wf, gamma = f32(cfg.base_lr), f32(cfg.warmup_factor), f32(cfg.gamma)
    wi = max(cfg.warmup_iters, 1)
    steps = sorted(cfg.steps)

    def schedule(count: int) -> float:
        t = min(f32(count) / f32(wi), f32(1.0))
        lr = base * (wf * (f32(1.0) - t) + t)
        if steps:
            lr = lr * gamma ** f32(sum(count >= s for s in steps))
        return float(f32(lr))

    return schedule
