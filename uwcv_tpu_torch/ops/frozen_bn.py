"""The trunk's conv epilogue: FrozenBN, the optional residual and the
ReLU in one op (no file of the JAX package: there XLA fuses
``uwcv_tpu/models/resnet.py``'s FrozenBN, add and ReLU into the conv).

``frozen_bn_act`` computes ``relu(x·scale + bias + r′)`` per channel of an
NCHW activation, where the residual ``r′`` is absent, ``residual`` as it
is, or ``residual·residual_scale + residual_bias`` (a projection
shortcut's own FrozenBN).  Every FrozenBN of the trunk is followed by a
ReLU, so the op always applies it.  Where no gradient has
to flow through it (grad mode off, or neither ``x`` nor ``residual``
requires grad: inference, and a trainer's frozen stages) it calls the op
``uwcv::frozen_bn_act``, which on a CUDA tensor launches
``csrc/frozen_bn.cu`` (one channels-last pass, bit-identical to the
chain) and on the CPU runs the chain.  Where a gradient flows it runs the
chain ``frozen_bn_act_reference`` under autograd: the op has no backward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from uwcv_tpu_torch import kernels
from uwcv_tpu_torch.utils import trace

# the kernel's 32-bit index of 16-byte vectors
FROZEN_BN_MAX_VECTORS = 2 ** 31 - 1


def _affine(x, scale, bias):
    return x * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)


def frozen_bn_act_reference(x, scale, bias, residual=None,
                            residual_scale=None, residual_bias=None):
    """Plain PyTorch version of ``frozen_bn_act``: the trunk's chain of
    broadcast multiply and add, the residual add and the ReLU, each op
    rounding to the tensor's dtype."""
    y = _affine(x, scale, bias)
    if residual is not None:
        if residual_scale is not None:
            residual = _affine(residual, residual_scale, residual_bias)
        y = y + residual
    return F.relu(y)


def frozen_bn_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  residual: Optional[torch.Tensor] = None,
                  residual_scale: Optional[torch.Tensor] = None,
                  residual_bias: Optional[torch.Tensor] = None):
    """``relu(x·scale + bias + r′)`` per channel: x [N, C, H, W] (a conv's
    output), scale and bias [C] in x's dtype; ``residual`` [N, C, H, W] or
    None; ``residual_scale`` and ``residual_bias`` [C] (the residual's own
    FrozenBN) or None.

    Calls the op ``uwcv::frozen_bn_act`` where no gradient flows through
    it, so ``torch.export`` records it; the chain runs where one does.
    The recorder's counters ``frozen_bn.fused`` and ``frozen_bn.plain``
    count the calls of each route (on a card each op call is one launch,
    on the CPU the op runs the chain).  On a card the op
    takes channels-last float32 or bfloat16 with C % 8 == 0, or raises.
    Row shards of the model axis (``parallel/spatial.py::Shards``) take
    it part by part."""
    if has_torch_function((x, residual)):
        return handle_torch_function(
            frozen_bn_act, (x, residual), x, scale, bias, residual,
            residual_scale, residual_bias)
    if torch.is_grad_enabled() and (
            x.requires_grad or (residual is not None
                                and residual.requires_grad)):
        trace.count("frozen_bn.plain")
        return frozen_bn_act_reference(x, scale, bias, residual,
                                       residual_scale, residual_bias)
    trace.count("frozen_bn.fused")
    return torch.ops.uwcv.frozen_bn_act(x, scale, bias, residual,
                                        residual_scale, residual_bias)


frozen_bn_act.launches = 0   # kernel launches, counted by the op

torch.library.define(
    "uwcv::frozen_bn_act",
    "(Tensor x, Tensor scale, Tensor bias, Tensor? residual, "
    "Tensor? residual_scale, Tensor? residual_bias) -> Tensor")


def _check(x, scale, bias, residual, residual_scale, residual_bias):
    """Raise unless the kernel takes these inputs → the kernel's residual
    mode: 0 none, 1 as it is, 2 under its own affine."""
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be [N,C,H,W] float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    c = x.shape[1]
    if c % 8 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"x must be channels-last with C % 8 == 0, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    mode = 0
    if residual is not None:
        if residual.shape != x.shape or not residual.is_contiguous(
                memory_format=torch.channels_last):
            raise ValueError(f"residual must be channels-last "
                             f"{tuple(x.shape)}, got {tuple(residual.shape)} "
                             f"strides {residual.stride()}")
        mode = 1
        if (residual_scale is None) != (residual_bias is None):
            raise ValueError("residual_scale and residual_bias come together")
        if residual_scale is not None:
            mode = 2
    elif residual_scale is not None or residual_bias is not None:
        raise ValueError("residual_scale and residual_bias need a residual")
    params = [scale, bias] + ([residual_scale, residual_bias]
                              if mode == 2 else [])
    for t in [residual] + params:
        if t is not None and (t.dtype != x.dtype or t.device != x.device):
            raise ValueError(f"every input must be {x.dtype} on {x.device}, "
                             f"got {t.dtype} on {t.device}")
    for t in params:
        if t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"scale and bias must be contiguous [{c}], got "
                             f"{tuple(t.shape)}")
    for t in [x, residual, *params]:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("every input must be 16-byte aligned")
    return mode


@torch.library.impl("uwcv::frozen_bn_act", "default")
def _frozen_bn_act_op(x, scale, bias, residual, residual_scale,
                      residual_bias):
    if x.device.type == "cpu":
        return frozen_bn_act_reference(x, scale, bias, residual,
                                       residual_scale, residual_bias)
    mode = _check(x, scale, bias, residual, residual_scale, residual_bias)
    per_vector = 16 // x.element_size()
    n_vec = x.numel() // per_vector
    if n_vec > FROZEN_BN_MAX_VECTORS:
        raise ValueError(f"frozen_bn_act takes at most "
                         f"{FROZEN_BN_MAX_VECTORS} 16-byte vectors, got "
                         f"{n_vec}")
    # x's own strides: channels-last, as the chain's output keeps them
    out = torch.empty_like(x)
    if n_vec == 0:
        return out
    ptr = lambda t: 0 if t is None else t.data_ptr()
    lib = kernels.library("frozen_bn")
    dev = x.device
    with torch.cuda.device(dev):
        rc = lib.uwcv_frozen_bn_act(
            x.data_ptr(), ptr(residual), scale.data_ptr(), bias.data_ptr(),
            ptr(residual_scale), ptr(residual_bias), out.data_ptr(), n_vec,
            x.shape[1] // per_vector, mode, int(x.dtype == torch.bfloat16),
            kernels.stream_ptr(dev))
    kernels.check(rc, "frozen_bn_act")
    kernels.count_launch(frozen_bn_act)
    return out


@torch.library.register_fake("uwcv::frozen_bn_act")
def _(x, scale, bias, residual, residual_scale, residual_bias):
    return torch.empty_like(x)
