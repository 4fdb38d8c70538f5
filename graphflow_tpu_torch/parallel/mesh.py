"""Process groups named like a device mesh, and the launcher of a world of
ranks (counterpart of ``graphflow_tpu/parallel/mesh.py``).

Under JAX a mesh names the axes of one SPMD program's devices.  Here each
device is driven by a process (a rank), and a mesh is the set of
``torch.distributed`` process groups that slice the ranks along its axes.
Axis conventions, as in the JAX package:

  "host"  -- across hosts (slow network); only gradient sums cross it
  "data"  -- batch (graph-level) data parallelism; gradients are summed
  "graph" -- partitioned-graph parallelism (vertices of the padded batch
             sharded over ranks, halo exchange for the boundaries)

Ranks lie on the mesh in row-major order of its axes (``make_mesh``), as
the JAX package reshapes its device list, so a leading "host" axis
(``make_hybrid_mesh``) keeps the trailing axes inside one host when ranks
are numbered host by host.

:func:`run_ranks` starts a world of ranks on this machine: spawned
processes, a ``file://`` rendezvous in a temporary directory, one card per
rank over NCCL where there are enough cards, else every rank on the first
card over gloo, and the CPU only when the caller asks for it.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
import tempfile
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, **kwargs) -> int:
    """Join the default process group and return the world size.

    Arguments default to the standard ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` variables (``init_method="env://"``).  A
    single-process launch (none of them set, no arguments) is a no-op that
    returns 1; a second call returns the size of the group already joined.
    ``backend`` defaults to NCCL with a card per rank, else gloo.
    ``kwargs`` go to ``torch.distributed.init_process_group`` (e.g.
    ``timeout``)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if (init_method is None and world_size is None
            and "MASTER_ADDR" not in os.environ):
        return 1
    world_size = int(os.environ["WORLD_SIZE"] if world_size is None
                     else world_size)
    rank = int(os.environ["RANK"] if rank is None else rank)
    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= world_size else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)
    return world_size


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass
class Mesh:
    """This rank's view of a mesh of ranks.

    ``ranks`` is the grid of global ranks, shape ``shape`` over
    ``axis_names``; ``coords`` this rank's index on each axis.  For every
    non-empty set of axes the mesh holds the group of the ranks that share
    this rank's coordinates on the other axes (``group``), or None where
    no process group was joined (a single process)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    ranks: np.ndarray
    rank: int
    coords: Dict[str, int]
    _groups: Dict[Tuple[str, ...], object]

    def size(self, axes: Axes) -> int:
        """Ranks in one slice along ``axes`` (a name or a tuple)."""
        return int(np.prod([self.shape[self.axis_names.index(a)]
                            for a in _axes(axes)]))

    def index(self, axes: Axes) -> int:
        """This rank's place in its slice along ``axes``, row-major."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[self.axis_names.index(a)] + self.coords[a]
        return i

    def group(self, axes: Axes):
        """The process group of this rank's slice along ``axes``."""
        return self._groups[self._key(axes)]

    def slice_ranks(self, axes: Axes) -> Tuple[int, ...]:
        """Global ranks of this rank's slice along ``axes``, row-major, so
        that ``slice_ranks(axes)[index(axes)] == rank``."""
        axes = _axes(axes)
        sub = self.ranks[tuple(slice(None) if a in axes else self.coords[a]
                               for a in self.axis_names)]
        order = [a for a in self.axis_names if a in axes]
        sub = np.transpose(sub, [order.index(a) for a in axes])
        return tuple(int(r) for r in sub.reshape(-1))

    def _key(self, axes: Axes) -> Tuple[str, ...]:
        axes = _axes(axes)
        unknown = set(axes) - set(self.axis_names)
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} on a mesh of {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)


def make_mesh(axis_shapes: Optional[Dict[str, int]] = None) -> Mesh:
    """A mesh from {axis_name: size} over every rank of the default group
    (default: one "data" axis over all of them), ranks in row-major order.
    Every rank must call it, with the same axes, at the same point of its
    program: each group is made by ``dist.new_group``, which all ranks
    join.  Without a process group the world is this one process."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if axis_shapes is None:
        axis_shapes = {"data": world}
    names, shape = tuple(axis_shapes), tuple(axis_shapes.values())
    if int(np.prod(shape)) != world:
        raise ValueError(f"a mesh of {dict(axis_shapes)} needs "
                         f"{int(np.prod(shape))} ranks; the world has "
                         f"{world}")
    ranks = np.arange(world).reshape(shape)
    coords = dict(zip(names, (int(c) for c in
                              np.argwhere(ranks == rank)[0])))
    mesh = Mesh(names, shape, ranks, rank, coords, {})
    # Every subset of axes, every slice of it: the same calls on every
    # rank, in the same order.
    for n in range(1, len(names) + 1):
        for axes in itertools.combinations(names, n):
            rest = [a for a in names if a not in axes]
            mine = None
            for fixed in itertools.product(
                    *[range(axis_shapes[a]) for a in rest]):
                view = dataclasses.replace(
                    mesh, coords={**coords, **dict(zip(rest, fixed))})
                members = sorted(view.slice_ranks(axes))
                group = (dist.new_group(members) if dist.is_initialized()
                         else None)
                if rank in members:
                    mine = group
            mesh._groups[axes] = mine
    return mesh


def make_hybrid_mesh(dcn_axes: Dict[str, int],
                     ici_axes: Dict[str, int]) -> Mesh:
    """A host x card mesh: the axes across hosts (``dcn_axes``) lead, so
    that, with ranks numbered host by host, a slice along the trailing
    axes (``ici_axes``) never leaves its host."""
    if set(dcn_axes) & set(ici_axes):
        raise ValueError(f"axes {set(dcn_axes) & set(ici_axes)} given as "
                         f"both host and card axes")
    return make_mesh({**dcn_axes, **ici_axes})


def data_sharding(mesh: Mesh, batch_size: int, axis: Axes = "data") -> slice:
    """This rank's share of a stacked batch's leading axis, sharded over
    ``axis`` (a name or a tuple of names): equal contiguous blocks in the
    order of :meth:`Mesh.index`."""
    n = mesh.size(axis)
    if batch_size % n:
        raise ValueError(f"a batch of {batch_size} does not split over "
                         f"{n} ranks of {axis}")
    k = batch_size // n
    i = mesh.index(axis)
    return slice(i * k, (i + 1) * k)


@torch.no_grad()
def replicated(mesh: Mesh, tensors: Sequence[torch.Tensor]):
    """Make ``tensors`` equal on every rank of the mesh: each is
    overwritten in place by the first rank's copy.  Returns them."""
    group = mesh.group(mesh.axis_names)
    if group is not None:
        src = int(mesh.ranks.reshape(-1)[0])
        for t in tensors:
            dist.broadcast(t, src, group=group)
    return tensors


# -- a world of ranks on this machine ----------------------------------------

def placement(world_size: int, device=None) -> Tuple[str, Tuple[str, ...]]:
    """(backend, each rank's device) for ``world_size`` ranks on this
    machine: the CPU over gloo when ``device="cpu"``; else a card per rank
    over NCCL where there are as many cards as ranks, or every rank on the
    first card over gloo (NCCL refuses two ranks on one card).  Without a
    card and without ``device="cpu"`` this raises: no rank lands on the
    CPU unasked."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo", ("cpu",) * world_size
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: ranks run on the GPU unless the "
                           "caller passes device=\"cpu\"")
    cards = torch.cuda.device_count()
    if cards >= world_size:
        return "nccl", tuple(f"cuda:{r}" for r in range(world_size))
    return "gloo", ("cuda:0",) * world_size


def _rank_main(rank, fn, world_size, backend, devices, workdir, threads,
               args):
    torch.set_num_threads(threads)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_distributed(backend, f"file://{workdir}/rendezvous", world_size,
                     rank, timeout=datetime.timedelta(seconds=300))
    try:
        out = fn(rank, device, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, args: tuple = (), device=None,
              verbose: bool = False) -> list:
    """Run ``fn(rank, device, *args)`` in ``world_size`` spawned processes
    that have joined one default process group, and return each rank's
    result, in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path) and the
    result goes back through ``torch.save``.  Where the ranks run follows
    :func:`placement`; ``verbose`` prints it.  On the card the models'
    kernels are built here first (``runtime/cuda_build.py:MODEL_KERNELS``),
    so that the ranks only load them.  A rank that raises makes this
    raise, with its traceback, once the others are stopped; a collective
    that waits longer than 300 s raises in its rank."""
    import torch.multiprocessing as mp

    backend, devices = placement(world_size, device)
    if devices[0].startswith("cuda"):
        from graphflow_tpu_torch.runtime.cuda_build import build_libraries
        build_libraries()
    if verbose:
        print(f"run_ranks: {world_size} ranks on {', '.join(devices)} over "
              f"{backend}", flush=True)
    # The caller's CPU threads, shared out among the ranks.
    threads = max(1, torch.get_num_threads() // world_size)
    with tempfile.TemporaryDirectory() as workdir:
        mp.start_processes(_rank_main, nprocs=world_size, join=True,
                           start_method="spawn",
                           args=(fn, world_size, backend, devices, workdir,
                                 threads, tuple(args)))
        # The results are the ranks' own files, written by this function.
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
