"""Device mesh and data parallelism (port of ``uwcv_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``(data, model)`` mesh and lets XLA
emit the gradient ``psum``.  Here the two kinds of data parallelism are
explicit:

- **training** runs one process per device (``torchrun``, or the ``train``
  verb's own workers); ``initialize_multi_host`` joins the process group,
  ``TrainLoader(process_index, process_count)`` gives each rank its slice
  of the global batch (rank-major, as ``jax.make_array_from_process_local_data``
  assembles it), and ``DataAxis`` sums over the ranks: the loss
  denominators in ``MaskRCNN.forward_train``, the gradients, the logged
  losses;
- **inference** runs one process over a ``Mesh`` of devices:
  ``Predictor(mesh=...)`` holds a replica per device and gives each its
  contiguous slice of the batch (``shard_batch``).

``spawn_ranks`` starts the ranks of a group from one driver process (the
``train`` verb's workers, an HPO trial over a group of devices) and stops
them all when one fails or the group outlives its deadline.

The model axis (spatial sharding, ``spatial_image_sharding``) is not
ported: a mesh with a model axis above 1 raises.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import time
from typing import (
    Callable,
    Dict,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Union,
)

import numpy as np
import torch
import torch.distributed as dist

from uwcv_tpu_torch.config import ParallelConfig
from uwcv_tpu_torch.utils.device import resolve_device


def initialize_multi_host(cfg: Optional[ParallelConfig] = None,
                          device: Optional[Union[str, torch.device]] = None,
                          backend: Optional[str] = None) -> bool:
    """``torch.distributed.init_process_group`` wiring.

    Joins the group when ``cfg.multi_host`` is set: NCCL for a CUDA
    ``device`` (the default device is ``cuda``), gloo for the CPU, unless
    ``backend`` names one (two ranks sharing one card need gloo: NCCL
    refuses them).  Rank and world size come from ``cfg.process_id`` /
    ``cfg.num_processes``, or, where those are unset, from the ``RANK`` /
    ``WORLD_SIZE`` that ``torchrun`` sets; ``cfg.coordinator_address`` is
    ``host:port`` (a ``tcp://`` address), a URL of its own (``file://...``),
    or empty for torchrun's ``env://``.  ``cfg.init_timeout_s`` bounds the
    rendezvous and every collective.  A CUDA ``device`` becomes the rank's
    current device.  Idempotent: an initialized group is kept.  Returns
    True when the run has more than one process."""
    cfg = cfg or ParallelConfig()
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if not cfg.multi_host:
        return False
    dev = resolve_device(device)
    env = os.environ
    rank = cfg.process_id if cfg.process_id >= 0 else int(env.get("RANK", 0))
    world = (cfg.num_processes if cfg.num_processes > 1
             else int(env.get("WORLD_SIZE", 1)))
    addr = cfg.coordinator_address
    init = addr if "://" in addr else (f"tcp://{addr}" if addr else "env://")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=cfg.init_timeout_s))
    return world > 1


def local_rank(cfg: Optional[ParallelConfig] = None) -> int:
    """This process's index among the processes of its host, which picks
    its card: torchrun's ``LOCAL_RANK``, else the rank (one host), from
    ``cfg.process_id`` or ``RANK``."""
    env = os.environ
    if "LOCAL_RANK" in env:
        return int(env["LOCAL_RANK"])
    cfg = cfg or ParallelConfig()
    return cfg.process_id if cfg.process_id >= 0 else int(env.get("RANK", 0))


class DataAxis:
    """The data axis across the processes of the group: this rank, the
    rank count, and sums over them.

    A rank's share of a global quantity is summed with ``all_reduce_sum``
    (in place, every rank gets the same bits).  The gloo backend sums CUDA
    tensors through a pinned host copy."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = dist.get_backend()

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.backend == "gloo" and t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            dist.all_reduce(host)
            t.copy_(host)
        else:
            dist.all_reduce(t)
        return t

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0
                   ) -> None:
        """Overwrite ``tensors`` with rank ``src``'s, one flat buffer per
        dtype."""
        groups: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            groups.setdefault(t.dtype, []).append(t)
        for group in groups.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            if self.backend == "gloo" and flat.is_cuda:
                host = flat.cpu()
                dist.broadcast(host, src)
                flat.copy_(host)
            else:
                dist.broadcast(flat, src)
            with torch.no_grad():
                for t, part in zip(group, flat.split([t.numel()
                                                      for t in group])):
                    t.copy_(part.view_as(t))

    def barrier(self) -> None:
        dist.barrier()


def spawn_ranks(fn: Callable, nprocs: int, args: tuple = (),
                timeout: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes and wait for
    them all.  A rank that raises or exits non-zero raises here a
    ``RuntimeError`` naming the rank and its error (the rank's traceback
    chained); ranks still running after ``timeout`` seconds raise a
    ``TimeoutError``.  Either way every rank of the group is stopped before
    this returns.  ``spawn``, not ``fork``: the caller may hold CUDA
    contexts and threads."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            wait = 5.0 if deadline is None else min(
                5.0, max(deadline - time.monotonic(), 0.0))
            try:
                if ctx.join(timeout=wait):
                    return
            except mp.ProcessRaisedException as e:
                lines = [line for line in e.msg.splitlines() if line.strip()]
                raise RuntimeError(f"rank {e.error_index} of {nprocs} failed: "
                                   f"{lines[-1]}") from e
            except mp.ProcessExitedException as e:
                raise RuntimeError(f"rank {e.error_index} of {nprocs} exited "
                                   f"with code {e.exit_code}") from e
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


def masters_digest(model: torch.nn.Module) -> str:
    """sha256 of every parameter and buffer of ``model``: the ranks of a
    data-parallel run must agree on it bit for bit."""
    h = hashlib.sha256()
    for t in model.state_dict().values():
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def data_axis() -> Optional[DataAxis]:
    """The process group's data axis, or None in a one-process run."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return DataAxis()
    return None


class Mesh(NamedTuple):
    """A ``(data, model)`` grid of devices, as ``jax.sharding.Mesh``."""
    devices: np.ndarray              # [d, m] of torch.device
    axis_names: tuple

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def build_mesh(cfg: Optional[ParallelConfig] = None,
               devices: Optional[Sequence] = None) -> Mesh:
    """``cfg.mesh_shape`` over ``devices`` (default: every local CUDA
    device; ``-1`` on the data axis takes them all).  An explicit list is
    taken as given, repeats included.  A model axis above 1 raises."""
    cfg = cfg or ParallelConfig()
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    d, m = cfg.mesh_shape
    m = max(m, 1)
    if m > 1:
        raise NotImplementedError(
            f"mesh_shape {tuple(cfg.mesh_shape)}: a model axis (spatial "
            f"sharding, mesh.spatial_image_sharding) is on ROADMAP.md's "
            f"list of what is not ported")
    if d == -1:
        d = len(devices) // m
    if d < 1 or d * m > len(devices):
        raise ValueError(f"mesh_shape {tuple(cfg.mesh_shape)} needs "
                         f"{d * m} devices, {len(devices)} given")
    arr = np.empty(d * m, dtype=object)
    arr[:] = devices[:d * m]
    return Mesh(arr.reshape(d, m), (cfg.data_axis, cfg.model_axis))


def batch_sharding(mesh: Mesh, batch_size: int) -> List[slice]:
    """The rows of a batch each device of the data axis holds: contiguous
    slices in device order.  The batch must tile the data axis."""
    d = mesh.devices.shape[0]
    if batch_size % d:
        raise ValueError(f"batch {batch_size} does not tile the data axis "
                         f"of {d} devices")
    b = batch_size // d
    return [slice(i * b, (i + 1) * b) for i in range(d)]


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to a card through pinned memory, so the
    copy does not hold the host."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh
                ) -> List[Dict[str, torch.Tensor]]:
    """A host batch split over the data axis: device i gets its
    ``batch_sharding`` rows."""
    n = len(next(iter(batch.values())))
    return [{k: to_device(v[s], torch.device(dev)) for k, v in batch.items()}
            for s, dev in zip(batch_sharding(mesh, n), mesh.devices[:, 0])]


def replicate(tree, mesh: Mesh) -> list:
    """One copy of a module or a tensor tree (dict, list, tuple) on each
    device of the data axis."""
    import copy

    def put(x, dev):
        if isinstance(x, torch.nn.Module):
            return copy.deepcopy(x).to(dev)
        if isinstance(x, torch.Tensor):
            return x.to(dev, copy=True)
        if isinstance(x, dict):
            return {k: put(v, dev) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v, dev) for v in x)
        return x

    return [put(tree, dev) for dev in mesh.devices[:, 0]]
