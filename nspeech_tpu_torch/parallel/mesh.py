"""Device meshes and process groups: port of ``nspeech_tpu/parallel/mesh.py``.

JAX puts every form of parallelism on one ``jax.sharding.Mesh`` and lets
GSPMD insert the collectives. The port has two forms, and each entry
point uses one of them:

- :class:`Mesh` (:func:`make_mesh`): a grid of ``torch.device`` in ONE
  process, with a ``data`` axis and a ``model`` axis (carried, as in JAX,
  and unused). Serving uses it (``Synthesizer(mesh=...)``,
  ``--data-parallel``): :func:`replicate` puts the weights once on each
  device of :func:`replicated`, :func:`shard_batch` cuts a request batch
  into one shard per device (:func:`batch_sharding`), and one thread per
  device decodes its rows.
- A process group (:func:`init_distributed`, the counterpart of
  ``initialize_multihost``): one process per card under ``torchrun``,
  NCCL on ``cuda`` and gloo on the CPU. Training uses it
  (``train/loop.py`` and ``train/runner.py`` with a :class:`DataParallel`;
  the trainers' CLIs under ``torchrun``), and so do the time- and
  length-sharded forms (``parallel/timeshard.py``,
  ``parallel/lengthshard.py``). :func:`shard_batch` with a
  :class:`DataParallel` gives this rank its rows of a global batch.
  With ``model_parallel=M`` the processes form a (data D x model M)
  grid, as JAX's ``make_mesh`` lays devices out: each rank has a
  :class:`DataParallel` over its model column and a
  :class:`TensorParallel` over its data row (``parallel/tensor.py``).
"""

from __future__ import annotations

import os
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nspeech_tpu_torch.ops.layers import tree_to

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """Devices of one process on a grid [data, model] (a device may repeat:
    ``[torch.device("cpu")] * 8`` is an 8-way CPU mesh)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))


def make_mesh(devices: Optional[Sequence] = None, model_parallel: int = 1,
              axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """Mesh of shape (n_devices // model_parallel, model_parallel); every
    visible card by default."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices= (for example "
                               "[torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n // model_parallel, model_parallel), axis_names)


def local_mesh(device) -> Mesh:
    """The mesh of ``--data-parallel`` serving: every card for ``cuda``,
    the one CPU device for ``cpu``."""
    device = torch.device(device)
    return make_mesh(None if device.type == "cuda" else [device])


class DataParallel(NamedTuple):
    """This process's place in a data-parallel process group: rank
    ``rank`` of ``world``, training on ``device``; it holds rows
    ``rank * n:(rank + 1) * n`` of a global batch of ``world * n`` rows.
    ``group`` None is the default process group."""
    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows."""
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)


class TensorParallel(NamedTuple):
    """This process's place on the ``model`` axis: rank ``rank`` of the
    ``world`` ranks that share one data shard, training on ``device``,
    each holding its slice of the sharded weights
    (``parallel/tensor.py``). ``group`` is their process group."""
    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None


def distributed_env() -> bool:
    """Whether this process was started by ``torchrun`` (or another
    launcher that sets ``RANK`` and ``WORLD_SIZE``)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_distributed(device="cuda", rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     model_parallel: Optional[int] = None):
    """Join (or create) the default process group and return this
    process's :class:`DataParallel`. ``rank``, ``world_size`` and the
    device index default to ``torchrun``'s ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK``; ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``), or pass ``tcp://127.0.0.1:<port>``. NCCL on
    ``cuda`` (the process trains on ``cuda:LOCAL_RANK``), gloo on the
    CPU; a group that already exists is joined as it is, whatever its
    backend.

    With ``model_parallel=M`` returns ``(dp, tp)`` on a (data D x model
    M) grid of the ``D * M`` ranks, laid out as JAX's ``make_mesh`` lays
    out devices: rank ``d * M + m`` is data shard ``d``, model rank
    ``m``. ``dp`` (rank d of D) is over the ranks of model column m,
    ``tp`` (:class:`TensorParallel`, rank m of M) over those of data row
    d; every rank creates every group, in one order."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kwargs = {"device_id": device} if device.type == "cuda" else {}
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=init_method or "env://",
                                rank=rank, world_size=world, **kwargs)
    if model_parallel is None:
        return DataParallel(rank, world, device)
    m_world = model_parallel
    if world % m_world:
        raise ValueError(f"{world} ranks not divisible by model_parallel={m_world}")
    grid = np.arange(world).reshape(world // m_world, m_world)
    d, m = divmod(rank, m_world)
    data_groups = [dist.new_group(grid[:, j].tolist()) for j in range(m_world)]
    model_groups = [dist.new_group(row.tolist()) for row in grid]
    return (DataParallel(d, world // m_world, device, data_groups[m]),
            TensorParallel(m, m_world, device, model_groups[d]))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> Optional[DataParallel]:
    """JAX's signature over :func:`init_distributed`: joins the group of
    ``num_processes`` at ``coordinator_address`` (``host:port``). None,
    and nothing done, for a single-process run."""
    if num_processes is None or num_processes <= 1:
        return None
    return init_distributed(
        device, rank=process_id, world_size=num_processes,
        init_method=(f"tcp://{coordinator_address}" if coordinator_address
                     else None))


def replicated(mesh: Mesh) -> List[torch.device]:
    """The devices that hold a replica: one per shard of the data axis
    (the first device of each row; the ``model`` axis is unused)."""
    return list(mesh.devices[:, 0])


def batch_sharding(mesh: Mesh, rows: int) -> List[Tuple[torch.device, slice]]:
    """Where the rows of a batch of ``rows`` go: (device, rows) per shard
    of the data axis. ``rows`` must divide by the axis."""
    n = mesh.shape[DATA_AXIS]
    if rows % n:
        raise ValueError(f"{rows} rows do not divide over {n} data shards")
    per = rows // n
    return [(d, slice(i * per, (i + 1) * per))
            for i, d in enumerate(replicated(mesh))]


def _take(x, rows: slice, device):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x[rows].to(device)
    return np.asarray(x)[rows]


def shard_batch(batch, mesh):
    """A batch (a NamedTuple of arrays or tensors with the batch axis
    first) split over ``mesh``: for a :class:`Mesh`, one batch per data
    shard, its tensors on that shard's device; for a
    :class:`DataParallel`, this rank's rows (host arrays stay on the
    host)."""
    rows = len(next(x for x in batch if x is not None))
    if isinstance(mesh, DataParallel):
        if rows % mesh.world:
            raise ValueError(f"{rows} rows do not divide over {mesh.world} ranks")
        return type(batch)(*(_take(x, mesh.rows(rows), mesh.device)
                             for x in batch))
    return [type(batch)(*(_take(x, sl, d) for x in batch))
            for d, sl in batch_sharding(mesh, rows)]


def replicate(tree, mesh: Mesh) -> list:
    """A tree of tensors, once on each device of :func:`replicated`."""
    return [tree_to(tree, d) for d in replicated(mesh)]


class ShardReduction:
    """The one collective of a batch decoded by one thread per device
    (``Synthesizer(mesh=...)``): :meth:`all` takes shard ``i``'s flags
    (had every row stopped, one per decoder step) and returns their AND
    over every shard, once each shard has given its own. JAX's sharded
    ``while_loop`` gets this all-finished reduction from GSPMD."""

    def __init__(self, shards: int):
        self._barrier = threading.Barrier(shards)
        self._flags: list = [None] * shards

    def all(self, i: int, flags: torch.Tensor) -> np.ndarray:
        self._flags[i] = flags.cpu().numpy()
        self._barrier.wait()
        out = np.logical_and.reduce(self._flags)
        self._barrier.wait()    # every shard has read before the next round
        return out

    def abort(self) -> None:
        """Release the other shards (with ``BrokenBarrierError``) when one
        fails."""
        self._barrier.abort()
