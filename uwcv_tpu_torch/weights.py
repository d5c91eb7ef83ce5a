"""Carry Flax parameters of the JAX package into the port's modules.

The input is the flat ``/``-joined Flax path → array dict that
``uwcv_tpu/engine/checkpoint.py::save_params_npz`` writes (and that
``tree_flatten_with_path`` gives for live params), e.g.
``params/backbone/res2_block0/conv1/kernel``.  The port's module tree uses
the same names, so each leaf maps by name:

- Conv ``kernel`` HWIO → ``weight`` OIHW;
- Dense ``kernel`` [in, out] → Linear ``weight`` [out, in] (``fc1`` stays
  HWC-flattened: the port keeps pooled features NHWC);
- ConvTranspose ``kernel`` → the inverse of ``checkpoint.py::_deconv``:
  flip H and W, then IOHW;
- FrozenBN ``frozen_bn_scale`` / ``frozen_bn_bias`` → buffers ``scale`` /
  ``bias``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from uwcv_tpu_torch.config import ModelConfig


def _torch_name(parts) -> tuple:
    """Flax path parts (without the "params" root) → (torch name, kind)."""
    mod, leaf = ".".join(parts[:-1]), parts[-1]
    if leaf == "kernel":
        return f"{mod}.weight", "kernel"
    if leaf == "bias":
        return f"{mod}.bias", "bias"
    if leaf == "frozen_bn_scale":
        return f"{mod}.scale", "bn"
    if leaf == "frozen_bn_bias":
        return f"{mod}.bias", "bn"
    raise KeyError(f"unknown Flax leaf {'/'.join(parts)}")


def params_from_flax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat Flax params → a state dict for ``models.rcnn.MaskRCNN`` (f32)."""
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        name, kind = _torch_name(parts)
        a = np.asarray(arr, dtype=np.float32)
        if kind == "kernel":
            if a.ndim == 4 and parts[-2] == "deconv":
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)     # → IOHW
            elif a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)                 # HWIO → OIHW
            elif a.ndim == 2:
                a = a.T                                     # [in,out] → [out,in]
            else:
                raise ValueError(f"{key}: unexpected kernel rank {a.ndim}")
        out[name] = torch.tensor(np.ascontiguousarray(a))
    return out


def flax_leaf_names(model: nn.Module) -> Dict[str, str]:
    """Each Flax leaf path of ``model`` (``params/...``) → the name of its
    tensor in the model's state dict (a parameter, or a FrozenBN buffer)."""
    from uwcv_tpu_torch.models.resnet import FrozenBN

    out = {}
    for mod_name, mod in model.named_modules():
        path = "params/" + mod_name.replace(".", "/")
        pre = f"{mod_name}." if mod_name else ""
        if isinstance(mod, FrozenBN):
            out[f"{path}/frozen_bn_scale"] = pre + "scale"
            out[f"{path}/frozen_bn_bias"] = pre + "bias"
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            out[f"{path}/kernel"] = pre + "weight"
            if mod.bias is not None:
                out[f"{path}/bias"] = pre + "bias"
    return out


def to_flax_layout(path: str, a: np.ndarray) -> np.ndarray:
    """A tensor of the port's layout → the Flax leaf ``path``'s layout
    (a view; the inverse of ``params_from_flax``'s transposes)."""
    if not path.endswith("/kernel"):
        return a
    if a.ndim == 4 and path.split("/")[-2] == "deconv":
        return a.transpose(2, 3, 0, 1)[::-1, ::-1]          # IOHW → flipped HWIO
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)                      # OIHW → HWIO
    return a.T                                              # [out,in] → [in,out]


def params_to_flax(model: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_flax``: a model's parameters and
    FrozenBN buffers → flat ``params/...`` Flax params (f32 numpy), the
    layout ``save_params_npz`` writes and ``load_params_npz`` reads."""
    sd = model.state_dict()
    return {path: np.ascontiguousarray(to_flax_layout(
        path, sd[name].detach().float().cpu().numpy()))
        for path, name in flax_leaf_names(model).items()}


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Load a ``save_params_npz`` file (e.g. ``assets/gate/gate_ckpt.npz``)
    → flat Flax params."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def flax_param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The flat Flax param tree of ``cfg``'s model: ``params/...`` path →
    shape, derived from the port's module tree (the inverse of
    ``params_from_flax``).  Seeded weights for a model the repo has no
    checkpoint of are made in this layout."""
    from uwcv_tpu_torch.models.rcnn import MaskRCNN

    with torch.device("meta"):
        model = MaskRCNN(cfg)
    sd = model.state_dict()
    # zero-size stand-ins: only the shape goes through the transposes
    return {path: to_flax_layout(path, np.broadcast_to(
        np.zeros((), np.uint8), tuple(sd[name].shape))).shape
        for path, name in flax_leaf_names(model).items()}
