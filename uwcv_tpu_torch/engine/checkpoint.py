"""Training checkpoints and the final weights (the port's own format).

- ``ckpt_<step>.pt`` (``torch.save``): the f32 master parameters, the
  optimizer's momentum traces and the step, for exact resume;
- ``model_final.npz``: the trained parameters in the JAX package's flat
  Flax layout (``weights.params_to_flax``), f32, with the Trainer's
  ``config.json`` beside it.  The port's ``Predictor`` (``load_predictor``)
  reads it, and so does the JAX package's ``load_params_npz``.

``load_weights`` also maps a torch ``.pth`` state dict (Detectron2 or
torchvision naming) onto the flat Flax params, folding BatchNorm running
stats into FrozenBN and transposing conv (OIHW → HWIO) and linear
kernels, with the JAX package's matching rules.
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


# ---------------------------------------------------------------------------
# torch state-dict import (port of uwcv_tpu/engine/checkpoint.py:117-299)
# ---------------------------------------------------------------------------

def load_weights(path: str, model: torch.nn.Module,
                 cfg) -> Dict[str, np.ndarray]:
    """Flat Flax params from a ``save_params_npz`` ``.npz`` or, for any
    other file, from a torch state dict mapped onto ``model``'s current
    params (``import_torch_weights``; leaves it does not match keep their
    value).  ``cfg`` is the ``ModelConfig``."""
    from uwcv_tpu_torch.weights import load_npz, params_to_flax

    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: uwcv_tpu_torch does not read orbax "
            f"checkpoints; write the params to an .npz with "
            f"uwcv_tpu/engine/checkpoint.py::save_params_npz")
    if path.endswith(".npz"):
        return load_npz(path)
    return import_torch_weights(path, params_to_flax(model), cfg)


def _torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    # a Detectron2 checkpoint holds non-tensor entries beside "model"
    payload = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(payload, dict) and "model" in payload:
        payload = payload["model"]
    if isinstance(payload, dict) and "state_dict" in payload:
        payload = payload["state_dict"]
    out = {}
    for k, v in payload.items():
        try:
            out[k] = v.detach().cpu().numpy()
        except AttributeError:
            out[k] = np.asarray(v)
    return out


def _fold_bn(sd: Dict[str, np.ndarray], prefix: str, eps: float = 1e-5):
    """BN running stats → (scale, bias) for FrozenBN."""
    gamma = sd[f"{prefix}.weight"]
    beta = sd[f"{prefix}.bias"]
    mean = sd.get(f"{prefix}.running_mean", np.zeros_like(gamma))
    var = sd.get(f"{prefix}.running_var", np.ones_like(gamma))
    scale = gamma / np.sqrt(var + eps)
    bias = beta - mean * scale
    return scale.astype(np.float32), bias.astype(np.float32)


def _conv(sd, key):
    # torch OIHW → Flax HWIO
    return np.transpose(sd[key], (2, 3, 1, 0)).astype(np.float32)


def _deconv(sd, key):
    # torch ConvTranspose2d IOHW → Flax HWIO, flipped in H and W (torch's
    # transposed conv is the gradient of conv; lax.conv_transpose is not)
    return np.ascontiguousarray(
        np.transpose(sd[key], (2, 3, 0, 1))[::-1, ::-1]).astype(np.float32)


def _linear(sd, key):
    return np.transpose(sd[key]).astype(np.float32)


def _linear_chw(sd, key, pool: int = 7):
    """torch Linear over a CHW-flattened pooled feature → HWC-flattened."""
    wt = sd[key]                                     # [out, C*P*P]
    out_dim, in_dim = wt.shape
    c = in_dim // (pool * pool)
    w = wt.reshape(out_dim, c, pool, pool).transpose(0, 2, 3, 1)
    return w.reshape(out_dim, in_dim).T.astype(np.float32)


def torchvision_resnet_mapping(depth: int) -> Dict[str, list]:
    """Flax param path → candidate (torch key prefix, kind) list, in the
    torchvision (``layer1.0.conv1``, ``bn1``, ``downsample.{0,1}``) and
    Detectron2 (``res2.0.conv1``, BN at ``<conv>.norm``, ``shortcut``)
    namings.  The first candidate whose ``.weight`` is in the state dict
    wins."""
    from uwcv_tpu_torch.models.resnet import STAGE_BLOCKS

    mapping: Dict[str, list] = {
        "backbone/stem_conv": [("conv1", "conv"), ("stem.conv1", "conv")],
        "backbone/stem_bn": [("bn1", "bn"), ("stem.conv1.norm", "bn")],
    }
    for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
        for b in range(n_blocks):
            ours = f"backbone/res{stage + 2}_block{b}"
            tv = f"layer{stage + 1}.{b}"
            d2 = f"res{stage + 2}.{b}"
            for i in (1, 2, 3):
                mapping[f"{ours}/conv{i}"] = [
                    (f"{tv}.conv{i}", "conv"), (f"{d2}.conv{i}", "conv")]
                mapping[f"{ours}/bn{i}"] = [
                    (f"{tv}.bn{i}", "bn"), (f"{d2}.conv{i}.norm", "bn")]
            if b == 0:
                mapping[f"{ours}/shortcut_conv"] = [
                    (f"{tv}.downsample.0", "conv"), (f"{d2}.shortcut", "conv")]
                mapping[f"{ours}/shortcut_bn"] = [
                    (f"{tv}.downsample.1", "bn"), (f"{d2}.shortcut.norm", "bn")]
    return mapping


def full_model_mapping(depth: int) -> Dict[str, list]:
    """The trunk's mapping plus FPN, RPN and heads (Detectron2 naming)."""
    mapping = torchvision_resnet_mapping(depth)
    for i in range(2, 6):
        mapping[f"fpn/lateral_c{i}"] = [(f"backbone.fpn_lateral{i}", "conv")]
        mapping[f"fpn/output_p{i}"] = [(f"backbone.fpn_output{i}", "conv")]
    mapping["rpn_head/rpn_conv"] = [
        ("proposal_generator.rpn_head.conv", "conv")]
    mapping["rpn_head/objectness"] = [
        ("proposal_generator.rpn_head.objectness_logits", "conv")]
    mapping["rpn_head/anchor_deltas"] = [
        ("proposal_generator.rpn_head.anchor_deltas", "conv")]
    # fc1 takes the flattened 7x7xC pool: torch flattens (C,H,W), the port
    # (H,W,C)
    mapping["box_head/fc1"] = [("roi_heads.box_head.fc1", "linear_chw")]
    mapping["box_head/fc2"] = [("roi_heads.box_head.fc2", "linear")]
    mapping["box_head/cls_score"] = [
        ("roi_heads.box_predictor.cls_score", "linear")]
    mapping["box_head/bbox_pred"] = [
        ("roi_heads.box_predictor.bbox_pred", "linear")]
    for i in range(1, 5):
        mapping[f"mask_head/mask_fcn{i}"] = [
            (f"roi_heads.mask_head.mask_fcn{i}", "conv")]
    mapping["mask_head/deconv"] = [("roi_heads.mask_head.deconv", "deconv")]
    mapping["mask_head/predictor"] = [
        ("roi_heads.mask_head.predictor", "conv")]
    return mapping


_KERNELS = {"conv": _conv, "deconv": _deconv, "linear": _linear,
            "linear_chw": _linear_chw}


def _mapped_leaf(sd: Dict[str, np.ndarray], mapping: Dict[str, list],
                 joined: str) -> Optional[np.ndarray]:
    """The value for Flax leaf ``joined`` from ``sd``, or None.  The first
    mapping key that is a substring of the leaf's path decides, even when
    none of its candidates is in ``sd``."""
    is_kernel = joined.endswith("kernel")
    is_bias = joined.endswith("bias") and "frozen_bn" not in joined
    for ours, candidates in mapping.items():
        if ours not in joined:
            continue
        for theirs, kind in candidates:
            if f"{theirs}.weight" not in sd:
                continue
            if kind == "bn":
                scale, bias = _fold_bn(sd, theirs)
                return scale if joined.endswith("scale") else bias
            if is_kernel:
                return _KERNELS[kind](sd, f"{theirs}.weight")
            if is_bias and f"{theirs}.bias" in sd:
                return sd[f"{theirs}.bias"].astype(np.float32)
            return None
        return None
    return None


def import_torch_weights(path: str, target_flat: Dict[str, np.ndarray],
                         cfg) -> Dict[str, np.ndarray]:
    """Map a torch state dict (Detectron2 or torchvision naming; a
    ``model`` or ``state_dict`` entry is unwrapped) onto the flat Flax
    params ``target_flat``.  Leaves that match nothing, or whose mapped
    shape differs, keep their target values; zero matches raise."""
    sd = {}
    for k, v in _torch_state_dict(path).items():
        for pre in ("module.", "backbone.bottom_up.", "backbone.body."):
            if k.startswith(pre):
                k = k[len(pre):]
        sd[k] = v
    mapping = full_model_mapping(cfg.depth)
    out, n_loaded = {}, 0
    for joined, leaf in target_flat.items():
        leaf = np.asarray(leaf)
        new = _mapped_leaf(sd, mapping, joined)
        if new is not None and new.shape == leaf.shape:
            out[joined] = new.astype(leaf.dtype)
            n_loaded += 1
        else:
            out[joined] = leaf
    if n_loaded == 0:
        raise ValueError(
            f"no weights matched between {path} and the target params")
    return out
