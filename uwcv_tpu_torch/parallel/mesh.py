"""Device mesh and data parallelism (port of ``uwcv_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``(data, model)`` mesh and lets XLA
emit the gradient ``psum``.  Here the two kinds of data parallelism are
explicit:

- **training** runs one process per device (``torchrun``, or the ``train``
  verb's own workers); ``initialize_multi_host`` joins the process group,
  ``TrainLoader(process_index, process_count)`` gives each data row its
  slice of the global batch (rank-major, as
  ``jax.make_array_from_process_local_data`` assembles it), and
  ``DataAxis`` sums over the rows: the loss denominators in
  ``MaskRCNN.forward_train``, the gradients, the logged losses;
- **inference** runs one process over a ``Mesh`` of devices:
  ``Predictor(mesh=...)`` holds a replica on the first device of each data
  row and gives each row its contiguous slice of the batch
  (``shard_batch``).

The model axis (``spatial_image_sharding``'s height over the model axis)
splits each image's height over the m devices of its data row
(``height_shards``): the trunk runs on row shards with halo rows
exchanged (``parallel/spatial.py``) and the FPN levels are gathered
before the heads.  In a process group of d·m ranks, rank r sits at data
index ``r // m`` and model index ``r % m`` (JAX's ``reshape(d, m)``
order); ``mesh_axes`` gives each rank its ``DataAxis`` and ``ModelAxis``
over sub-groups of their own.  In one process a row's devices exchange
halos with copies (``spatial.DeviceRow``).

``spawn_ranks`` starts the ranks of a group from one driver process (the
``train`` verb's workers, an HPO trial over a group of devices) and stops
them all when one fails or the group outlives its deadline.
"""

from __future__ import annotations

import contextlib
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
    Tuple,
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
    """Sums and broadcasts over the processes of ``group`` (default: the
    whole process group): this rank's index there, their count, and sums
    over them.

    A rank's share of a global quantity is summed with ``all_reduce_sum``
    (in place, every rank gets the same bits).  The gloo backend sums CUDA
    tensors through a pinned host copy."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        # broadcasts come from the group's first rank, named globally
        self._src = 0 if group is None else dist.get_global_rank(group, 0)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.backend == "gloo" and t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite ``tensors`` with the group's first rank's, one flat
        buffer per dtype."""
        groups: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            groups.setdefault(t.dtype, []).append(t)
        for group in groups.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            if self.backend == "gloo" and flat.is_cuda:
                host = flat.cpu()
                dist.broadcast(host, self._src, group=self.group)
                flat.copy_(host)
            else:
                dist.broadcast(flat, self._src, group=self.group)
            with torch.no_grad():
                for t, part in zip(group, flat.split([t.numel()
                                                      for t in group])):
                    t.copy_(part.view_as(t))

    def barrier(self) -> None:
        dist.barrier(group=self.group)


class ModelAxis:
    """The model axis of this rank's data row: the ``size`` ranks
    ``ranks`` (global, in model order) of ``group``, of which this is
    model index ``rank``, holding the row shard ``height_shards`` gives
    it.  The communicator of ``parallel/spatial.py``'s process-group
    route: ``swap`` moves halo rows between neighbours with one
    ``batch_isend_irecv``, ``gather`` all-gathers a level's shards.  The
    gloo backend moves CUDA tensors through host copies (two ranks sharing
    one card need gloo: NCCL refuses them)."""

    def __init__(self, group, ranks: Sequence[int]):
        self.group = group
        self.ranks = list(ranks)
        self.rank = self.ranks.index(dist.get_rank())
        self.size = len(self.ranks)
        self.local = [self.rank]          # the model indices held here
        self._staged = dist.get_backend(group) == "gloo"
        # (name, start, end) CUDA events around each halo swap and level
        # gather, recorded while a caller sets a list here
        self.spans: Optional[list] = None
        # a first collective with every rank of the group, before any
        # point-to-point call
        dist.barrier(group=group)

    @contextlib.contextmanager
    def _span(self, name: str, like: torch.Tensor):
        if self.spans is None or not like.is_cuda:
            yield
            return
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        yield
        b.record()
        self.spans.append((name, a, b))

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self._staged and t.is_cuda else t

    def _buffer(self, shape, like: torch.Tensor) -> torch.Tensor:
        dev = "cpu" if self._staged else like.device
        return torch.empty(shape, dtype=like.dtype, device=dev)

    def swap(self, msgs: Dict[Tuple[int, int], torch.Tensor],
             want: Dict[Tuple[int, int], Tuple[tuple, torch.Tensor]]
             ) -> Dict[Tuple[int, int], torch.Tensor]:
        """Send ``msgs[(this, dst)]`` to model index ``dst``; receive for
        each ``want[(src, this)] = (shape, like)`` a tensor of ``shape``
        from ``src``, on ``like``'s device in its dtype.  → the received
        tensors by (src, this)."""
        if not (msgs or want):
            return {}
        ops, got = [], {}
        first = (next(iter(msgs.values())) if msgs
                 else next(iter(want.values()))[1])
        with self._span("halo", first):
            for (_, dst), t in msgs.items():
                ops.append(dist.P2POp(dist.isend, self._out(t),
                                      self.ranks[dst], self.group))
            for key, (shape, like) in want.items():
                got[key] = self._buffer(shape, like)
                ops.append(dist.P2POp(dist.irecv, got[key],
                                      self.ranks[key[0]], self.group))
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            return {key: got[key].to(like.device)
                    for key, (_, like) in want.items()}

    def gather(self, parts: Sequence[torch.Tensor], heights: Sequence[int]
               ) -> torch.Tensor:
        """[B, C, heights[j], W] shard j of every rank → the
        [B, C, sum(heights), W] whole on every rank: one all-gather of the
        shards padded to the tallest."""
        (x,) = parts
        with self._span("gather", x):
            pad = max(heights) - x.shape[2]
            send = self._out(torch.nn.functional.pad(x, (0, 0, 0, pad)))
            bufs = [torch.empty_like(send) for _ in range(self.size)]
            dist.all_gather(bufs, send, group=self.group)
            whole = torch.cat([b[:, :, :h] for b, h in zip(bufs, heights)],
                              2)
            return whole.to(x.device)


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


def mesh_axes(model: int = 1) -> Tuple[Optional[DataAxis],
                                        Optional[DataAxis],
                                        Optional[ModelAxis]]:
    """The process group as a (world // ``model``, ``model``) mesh: →
    (every process, this rank's data axis, its model axis).  Rank r sits
    at data index ``r // model`` and model index ``r % model``; the data
    axis is the sub-group of the ranks at this model index, the model axis
    that of this data row.  Each is None where it holds one rank; all three
    are None in a one-process run.  Every rank must call this, in the same
    order: each creates every sub-group (``torch.distributed.new_group``).
    A model axis above 1 needs a process group whose size it divides."""
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        if model > 1:
            raise ValueError(f"a model axis of {model} runs one process "
                             f"per device: join a process group of "
                             f"{model} or more ranks first")
        return None, None, None
    world, r = dist.get_world_size(), dist.get_rank()
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"{world} ranks of the process group")
    everyone = DataAxis()
    if model == 1:
        return everyone, everyone, None
    d = world // model
    rows = [list(range(i * model, (i + 1) * model)) for i in range(d)]
    row_groups = [dist.new_group(ranks) for ranks in rows]
    data = None
    if d > 1:
        col_groups = [dist.new_group(list(range(j, world, model)))
                      for j in range(model)]
        data = DataAxis(col_groups[r % model])
    return everyone, data, ModelAxis(row_groups[r // model],
                                     rows[r // model])


class Mesh(NamedTuple):
    """A ``(data, model)`` grid of devices, as ``jax.sharding.Mesh``."""
    devices: np.ndarray              # [d, m] of torch.device
    axis_names: tuple

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def build_mesh(cfg: Optional[ParallelConfig] = None,
               devices: Optional[Sequence] = None) -> Mesh:
    """``cfg.mesh_shape`` = (d, m) over ``devices`` (default: every local
    CUDA device), as JAX builds it: ``d = -1`` takes ``len(devices) //
    m``, and the first d·m devices fill the mesh row-major, so data row i
    holds devices ``i·m … i·m + m − 1``.  An explicit list is taken as
    given, repeats included (``["cuda:0", "cuda:0"]`` puts two entries on
    one card)."""
    cfg = cfg or ParallelConfig()
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    d, m = cfg.mesh_shape
    m = max(m, 1)
    if d == -1:
        d = len(devices) // m
    if d < 1 or d * m > len(devices):
        raise ValueError(f"mesh_shape {tuple(cfg.mesh_shape)} needs "
                         f"{max(d, 1) * m} devices, {len(devices)} given")
    arr = np.empty(d * m, dtype=object)
    arr[:] = devices[:d * m]
    return Mesh(arr.reshape(d, m), (cfg.data_axis, cfg.model_axis))


# every interior shard boundary is a multiple of this many image rows, the
# stride of p6: each FPN level's shard is then rows [a/s, b/s) and
# p6 = p5[::2] stays local
SHARD_ROWS = 64


def height_shards(height: int, m: int) -> List[Tuple[int, int]]:
    """The image rows [a_j, b_j) that model index j of ``m`` holds: whole
    blocks of ``SHARD_ROWS`` rows (the last block partial) dealt out as
    evenly as they go, the first shards taking one more; the last shard
    takes the remainder (800 rows over 2: 448 + 352).  Raises where a
    shard would be empty (``height < 64·(m − 1) + 1``)."""
    blocks = -(-height // SHARD_ROWS)
    if m < 1 or blocks < m:
        raise ValueError(f"an image of {height} rows cannot be split over a "
                         f"model axis of {m}: each shard needs rows of its "
                         f"own, so at least {SHARD_ROWS * (m - 1) + 1}")
    rows, a = [], 0
    for j in range(m):
        n = blocks // m + (j < blocks % m)
        b = min(a + n * SHARD_ROWS, height)
        rows.append((a, b))
        a = b
    return rows


def batch_sharding(mesh: Mesh, batch_size: int) -> List[slice]:
    """The rows of a batch each data row of the mesh holds: contiguous
    slices in row order.  The batch must tile the data axis."""
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
    """A host batch split over the data axis: the first device of data
    row i gets its ``batch_sharding`` rows."""
    n = len(next(iter(batch.values())))
    return [{k: to_device(v[s], torch.device(dev)) for k, v in batch.items()}
            for s, dev in zip(batch_sharding(mesh, n), mesh.devices[:, 0])]


def replicate(tree, mesh: Mesh) -> list:
    """One copy of a module or a tensor tree (dict, list, tuple) on the
    first device of each data row."""
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
