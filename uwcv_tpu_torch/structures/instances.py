"""Host-side padded Instances (port of ``uwcv_tpu/structures/instances.py``).

Every field has a static leading capacity ``N`` plus a ``valid`` bool mask,
so the measurement/report layers consume the same struct as the JAX
package's.  Here it is a plain numpy dataclass: the predictor builds it on
the host after the device → host pull.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Instances:
    """Padded instance set.

    boxes   : [N, 4] float  XYXY_ABS in original-image coordinates
    scores  : [N]    float
    classes : [N]    int32
    valid   : [N]    bool    — padding mask; invalid rows are all-zero
    masks   : [N, H, W] (optional) bool full-image masks
    image_size : (H, W) the true (resized) image extent
    """

    boxes: np.ndarray
    scores: np.ndarray
    classes: np.ndarray
    valid: np.ndarray
    masks: Optional[np.ndarray] = None
    image_size: Tuple[int, int] = (0, 0)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Strip padding; returns dense numpy arrays."""
        valid = np.asarray(self.valid)
        out = {
            "boxes": np.asarray(self.boxes)[valid],
            "scores": np.asarray(self.scores)[valid],
            "classes": np.asarray(self.classes)[valid],
        }
        if self.masks is not None:
            h, w = self.image_size
            masks = np.asarray(self.masks)[valid]
            if (masks.ndim == 3 and h and w and masks.shape[1] >= h
                    and masks.shape[2] >= w):
                masks = masks[:, :h, :w]
            out["masks"] = masks
        return out
