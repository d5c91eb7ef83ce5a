"""The model axis of the trunk: row shards, halo exchange and the gather of
the FPN levels (no file of the JAX package: there XLA's SPMD partitioner
splits the convs of ``spatial_image_sharding``'s height-sharded images).

An image's height is split over the m devices of its data row
(``parallel/mesh.py::height_shards``; every interior boundary on a
multiple of 64 rows).  Each conv or pool whose window is taller than one
row first takes halo rows from its neighbours: output row o reads input
rows ``s·o − p … s·o − p + k − 1``, so a shard needs ``top = p`` rows of
the shard above and ``bottom = max(k − p − s, 0)`` of the shard below.
The global top and bottom edges get no halo; there the op pads as the
unsharded op does (zeros for a conv, −inf for the max-pool), and an
interior boundary is never padded.  Everything else in the trunk is
row-local.  After the trunk ``gather_rows`` puts each level back together.

One halo rule serves two routes, through a communicator ``axis``:

- a process group (``mesh.py::ModelAxis``): one rank per device, each
  holding one shard as a plain tensor (training, one process per device);
- one process (``DeviceRow``): the m shards of a data row as ``Shards``,
  part j on the row's device j, with halo rows moved by copies
  (``Predictor(mesh=...)``).

A communicator has ``size`` (m), ``local`` (the model indices held here),
``swap`` (point-to-point messages keyed (src, dst)) and ``gather``.  The
halo exchange and the gather are autograd functions: the halo's backward
sends the halo rows' gradients back and adds them into their owners'
rows; the gather's keeps each shard's rows of the gradient and sums
nothing (every rank of a row runs the same heads on the same levels).
Nothing falls back: a shard shorter than its halo raises, and so does a
failed collective.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from uwcv_tpu_torch.utils.device import resolve_device


class Shards:
    """The row shards of one activation in a ``DeviceRow``: ``parts[j]``
    on the row's device j.  Torch functions, tensor methods, ``+``, ``*``
    and indexing map over the parts, with any plain tensor argument (a
    weight, a FrozenBN affine) copied to the part's device, so the trunk's
    row-local code runs on them unchanged."""

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = list(parts)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        first = next(a for a in (*args, *kwargs.values())
                     if isinstance(a, Shards))

        def part(a, j, dev):
            if isinstance(a, Shards):
                return a.parts[j]
            if isinstance(a, torch.Tensor):
                return a.to(dev, non_blocking=True)
            if isinstance(a, (list, tuple)):
                return type(a)(part(v, j, dev) for v in a)
            return a

        return Shards(
            func(*part(args, j, p.device),
                 **{k: part(v, j, p.device) for k, v in kwargs.items()})
            for j, p in enumerate(first.parts))

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        method = getattr(torch.Tensor, name)
        return lambda *a, **k: Shards.__torch_function__(
            method, (), (self,) + a, k)

    def __add__(self, other):
        return torch.add(self, other)

    def __mul__(self, other):
        return torch.mul(self, other)

    def __getitem__(self, idx):
        return Shards(p[idx] for p in self.parts)


class DeviceRow:
    """The in-process communicator of one data row: its m devices, each
    holding one shard (``Shards``); halo rows and the gathered levels move
    between them by copies.  The gathered levels land on the first
    device, which runs the heads."""

    def __init__(self, devices: Sequence):
        self.devices = [resolve_device(d) for d in devices]
        self.size = len(self.devices)
        self.local = list(range(self.size))

    def swap(self, msgs: Dict[Tuple[int, int], torch.Tensor],
             want: Dict[Tuple[int, int], Tuple[tuple, torch.Tensor]]
             ) -> Dict[Tuple[int, int], torch.Tensor]:
        return {key: msgs[key].to(like.device)
                for key, (_, like) in want.items()}

    def gather(self, parts: Sequence[torch.Tensor], heights: Sequence[int]
               ) -> torch.Tensor:
        dev = parts[0].device
        return torch.cat([p.to(dev) for p in parts], 2)


def _parts(x) -> List[torch.Tensor]:
    return x.parts if isinstance(x, Shards) else [x]


def _like(x, parts):
    return Shards(parts) if isinstance(x, Shards) else parts[0]


def _memory_format(x: torch.Tensor):
    return (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


def _rows_like(x: torch.Tensor, n: int) -> tuple:
    return (x.shape[0], x.shape[1], n, x.shape[3])


def _stack_rows(above, x, below) -> torch.Tensor:
    """[above; x; below] along the rows, in x's memory format."""
    if above is None and below is None:
        return x
    t = 0 if above is None else above.shape[2]
    b = 0 if below is None else below.shape[2]
    h = x.shape[2]
    out = torch.empty(_rows_like(x, t + h + b), dtype=x.dtype,
                      device=x.device, memory_format=_memory_format(x))
    if above is not None:
        out[:, :, :t] = above
    out[:, :, t:t + h] = x
    if below is not None:
        out[:, :, t + h:] = below
    return out


class _Halo(torch.autograd.Function):
    """Forward: each local shard j sends its first ``bottom`` rows to
    j − 1 and its last ``top`` rows to j + 1, and is extended by what it
    receives.  Backward: the gradients of the halo rows go back to their
    owners and are added into their rows."""

    @staticmethod
    def forward(ctx, axis, top: int, bottom: int, *parts):
        m = axis.size
        ctx.axis, ctx.top, ctx.bottom = axis, top, bottom
        ctx.heights = [p.shape[2] for p in parts]
        msgs, want = {}, {}
        for j, x in zip(axis.local, parts):
            h = x.shape[2]
            need = max(top if j < m - 1 else 0, bottom if j > 0 else 0)
            if h < need:
                raise ValueError(
                    f"shard {j} of {m} has {h} rows, fewer than the halo of "
                    f"{top} above / {bottom} below its neighbours take")
            if j > 0 and bottom:
                msgs[(j, j - 1)] = x[:, :, :bottom]
            if j < m - 1 and top:
                msgs[(j, j + 1)] = x[:, :, h - top:]
            if j > 0 and top:
                want[(j - 1, j)] = (_rows_like(x, top), x)
            if j < m - 1 and bottom:
                want[(j + 1, j)] = (_rows_like(x, bottom), x)
        got = axis.swap(msgs, want)
        return tuple(_stack_rows(got.get((j - 1, j)), x, got.get((j + 1, j)))
                     for j, x in zip(axis.local, parts))

    @staticmethod
    def backward(ctx, *grads):
        axis, top, bottom = ctx.axis, ctx.top, ctx.bottom
        m = axis.size
        msgs, want = {}, {}
        for j, g, h in zip(axis.local, grads, ctx.heights):
            t = top if j > 0 else 0
            if j > 0 and top:
                msgs[(j, j - 1)] = g[:, :, :top]
            if j < m - 1 and bottom:
                msgs[(j, j + 1)] = g[:, :, t + h:]
            if j < m - 1 and top:
                want[(j + 1, j)] = (_rows_like(g, top), g)
            if j > 0 and bottom:
                want[(j - 1, j)] = (_rows_like(g, bottom), g)
        got = axis.swap(msgs, want)
        out = []
        for j, g, h in zip(axis.local, grads, ctx.heights):
            t = top if j > 0 else 0
            gx = g[:, :, t:t + h].clone(memory_format=_memory_format(g))
            if (j + 1, j) in got:
                gx[:, :, h - top:] += got[(j + 1, j)]
            if (j - 1, j) in got:
                gx[:, :, :bottom] += got[(j - 1, j)]
            out.append(gx)
        return (None, None, None, *out)


def halo_exchange(x, top: int, bottom: int, axis):
    """This process's shard(s) ``x`` [B, C, h, W] (a tensor, or ``Shards``
    in a ``DeviceRow``) extended by ``top`` rows of the shard above and
    ``bottom`` rows of the shard below; the first shard gets no rows above
    and the last none below."""
    if not (top or bottom):
        return x
    return _like(x, list(_Halo.apply(axis, top, bottom, *_parts(x))))


def _each(x, axis, fn: Callable) -> object:
    """``fn(part, model index)`` over the local shards."""
    return _like(x, [fn(p, j) for j, p in zip(axis.local, _parts(x))])


def _halo_then_pad(x, k: int, s: int, p: int, axis, value: float):
    """The halo of a (k, s, p) window over the rows, then the global edges
    padded with ``p`` rows of ``value``, in the shard's memory format (a
    shard that took no halo rows comes back from the exchange as a view
    whose strides ``F.pad`` would read as contiguous at batch 1)."""
    x = halo_exchange(x, p, max(k - p - s, 0), axis)
    last = axis.size - 1

    def pad(t, j):
        edge = lambda here: t.new_full(_rows_like(t, p), value) \
            if here and p else None
        return _stack_rows(edge(j == 0), t, edge(j == last))

    return _each(x, axis, pad)


def spatial_conv2d(x, conv: nn.Conv2d, axis=None):
    """``conv`` on row shards: the halo, the global edges zero-padded, then
    the conv with height padding 0 and its own width padding.  Without an
    ``axis`` it is ``conv(x)``."""
    if axis is None:
        return conv(x)
    (k, _), (s, _), (p, pw) = conv.kernel_size, conv.stride, conv.padding
    x = _halo_then_pad(x, k, s, p, axis, 0.0)
    return _each(x, axis, lambda t, j: F.conv2d(
        t, conv.weight.to(t.device, non_blocking=True),
        None if conv.bias is None
        else conv.bias.to(t.device, non_blocking=True),
        conv.stride, (0, pw), conv.dilation, conv.groups))


def spatial_max_pool2d(x, kernel: int, stride: int, padding: int,
                       axis=None):
    """``F.max_pool2d(x, kernel, stride, padding)`` on row shards: the
    halo, the global edges padded with −inf, then the pool with height
    padding 0."""
    if axis is None:
        return F.max_pool2d(x, kernel, stride=stride, padding=padding)
    x = _halo_then_pad(x, kernel, stride, padding, axis, float("-inf"))
    return _each(x, axis, lambda t, j: F.max_pool2d(
        t, kernel, stride=stride, padding=(0, padding)))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, heights, *parts):
        ctx.axis, ctx.heights = axis, list(heights)
        ctx.devices = [p.device for p in parts]
        whole = axis.gather(parts, heights)
        return whole.contiguous(memory_format=_memory_format(parts[0]))

    @staticmethod
    def backward(ctx, g):
        starts = [sum(ctx.heights[:j]) for j in range(len(ctx.heights))]
        return (None, None, *[
            g[:, :, starts[j]:starts[j] + ctx.heights[j]].to(dev)
            for j, dev in zip(ctx.axis.local, ctx.devices)])


def gather_rows(x, axis, heights: Sequence[int]) -> torch.Tensor:
    """The whole [B, C, sum(heights), W] level from its row shards
    (shard j has ``heights[j]`` rows): on every rank of a process group, on
    the first device of a ``DeviceRow``.  Its backward hands each shard its
    rows of the gradient."""
    return _Gather.apply(axis, tuple(heights), *_parts(x))


def level_heights(rows: Sequence[Tuple[int, int]], stride: int) -> List[int]:
    """The rows of each shard at a level of ``stride`` (a power of two up
    to 64) of the image rows ``rows`` (``mesh.height_shards``)."""
    return [-(-b // stride) - a // stride for a, b in rows]


def shard_rows(images: torch.Tensor, axis, rows: Sequence[Tuple[int, int]],
               fn: Callable = lambda t: t):
    """``fn`` of this process's rows of ``images`` [B, H, W, C]: a tensor
    (process group), or ``Shards`` on the row's devices (``DeviceRow``)."""
    parts = [fn(images[:, rows[j][0]:rows[j][1]].to(
        axis.devices[i] if isinstance(axis, DeviceRow) else images.device))
        for i, j in enumerate(axis.local)]
    return Shards(parts) if isinstance(axis, DeviceRow) else parts[0]
