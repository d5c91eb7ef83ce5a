"""Training checkpoints and the final weights (the port's own format).

- ``ckpt_<step>.pt`` (``torch.save``): the f32 master parameters, the
  optimizer's momentum traces and the step, for exact resume;
- ``model_final.npz``: the trained parameters in the JAX package's flat
  Flax layout (``weights.params_to_flax``), f32, with the Trainer's
  ``config.json`` beside it.  The port's ``Predictor`` (``load_predictor``)
  reads it, and so does the JAX package's ``load_params_npz``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

_CKPT_RE = re.compile(r"ckpt_(\d+)\.pt$")


def save_checkpoint(output_dir: str, state: Dict, step: int) -> str:
    """Write ``state`` (tensors on any device) as ``ckpt_<step>.pt``,
    atomically (a temporary file, then a rename)."""
    path = os.path.abspath(os.path.join(output_dir, f"ckpt_{step:07d}.pt"))
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(output_dir: str) -> Optional[str]:
    if not os.path.isdir(output_dir):
        return None
    best, best_step = None, -1
    for entry in os.listdir(output_dir):
        m = _CKPT_RE.match(entry)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(output_dir, entry), int(m.group(1))
    return os.path.abspath(best) if best else None


def load_checkpoint(path: str, device="cpu") -> Dict:
    return torch.load(path, map_location=device, weights_only=True)


def save_params_npz(path: str, flat: Dict[str, np.ndarray]) -> str:
    """Flat Flax params → one uncompressed ``.npz`` (f32), atomically."""
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **{k: np.asarray(v, np.float32) for k, v in flat.items()})
    os.replace(tmp, path)
    return path
