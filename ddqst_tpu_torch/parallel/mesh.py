"""Process meshes for data- and tensor-parallel training.

The port's counterpart of ``ddqst_tpu/parallel/mesh.py``. JAX's mesh is one
process that sees every device. Here every rank is a process of its own,
started by ``torchrun`` (``python -m torch.distributed.run``) or
``torch.multiprocessing``, and every rank runs the same entry point with the
same seed. A :class:`Mesh` lays the world's ranks out as JAX lays its devices
out, rank ``i`` at ``(i // model, i % model)`` of a ``data x model`` grid, and
holds this rank's two process groups: ``data_group``, the ranks of its model
column (gradients are averaged over it), and ``model_group``, the ranks of
its data row (the transformer's tensor-parallel reduces).

- ``init_distributed`` joins the world from ``torchrun``'s environment or
  from explicit arguments; a no-op returning False for one process.
- ``make_mesh`` builds the mesh over the whole world (a one-process world
  it joins itself).
- ``shard_data`` / ``gather_data``: this data rank's rows of a leading axis,
  and their inverse. A JAX array is logically whole and a rank here holds
  only its slice, so ``gather_data`` is the counterpart of reading a sharded
  ``jax.Array``.
- ``replicate`` broadcasts tensors or a module's state from the mesh's rank
  0.

The backend is chosen once, when the world is joined, and printed: NCCL
when every rank of the host has a card of its own, gloo on the CPU or when
ranks share a card (NCCL refuses two ranks on one device). A failed
collective raises; nothing retries on another backend. The collectives used
are ``all_reduce`` and ``broadcast`` only, the two that gloo offers for CUDA
tensors.

JAX's ``data_sharding`` / ``replicated_sharding`` are ``NamedSharding``
objects of a single-controller mesh and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist
from torch import nn

from ddqst_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

_TORCHRUN_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def choose_backend(device: torch.device, world_size: int) -> str:
    """NCCL for CUDA when each of the host's ranks has a card of its own,
    gloo otherwise. The host's rank count is ``LOCAL_WORLD_SIZE`` (set by
    ``torchrun``), else the world's."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if device.type == "cuda" and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _join(init_method: str, world_size: int, rank: int, backend: str) -> None:
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    if rank == 0:
        print(f"torch.distributed: {world_size} rank(s), backend {backend}",
              flush=True)


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Join the world of processes; returns True when this process is in a
    world of several (or one that ``torchrun`` configured).

    As JAX's: ``num_processes=1``, or nothing configured (no arguments and
    no ``MASTER_ADDR`` / ``WORLD_SIZE`` / ``RANK`` from ``torchrun``), is a
    no-op that returns False, so entry points may call it unconditionally.
    ``coordinator_address`` is ``host:port``; arguments left None come from
    the environment. ``backend`` None takes :func:`choose_backend` for the
    entry points' default device, CUDA when there is one.
    """
    if num_processes == 1:
        return False
    if (coordinator_address is None and num_processes is None
            and process_id is None
            and not all(os.environ.get(v) for v in _TORCHRUN_ENV)):
        return False
    world = (num_processes if num_processes is not None
             else int(os.environ["WORLD_SIZE"]))
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    if backend is None:
        default = "cuda" if torch.cuda.is_available() else "cpu"
        backend = choose_backend(torch.device(default), world)
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    _join(init, world, rank, backend)
    return True


def free_port() -> int:
    """A free TCP port on localhost (the OS's pick) for a world's
    rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a ``data x model`` grid of ranks.

    ``shape`` is ``{"data": d, "model": m}`` (JAX's ``Mesh.shape``),
    ``coords`` this rank's ``(data index, model index)``; ``data_ranks`` /
    ``model_ranks`` are the world ranks of ``data_group`` (by data index)
    and ``model_group`` (by model index).
    """

    shape: dict
    rank: int
    coords: tuple
    data_group: object
    model_group: object
    data_ranks: tuple
    model_ranks: tuple
    device: torch.device
    backend: str


def make_mesh(data: int = -1, model: int = 1,
              device: str | torch.device | None = None) -> Mesh:
    """A ``data x model`` mesh over every rank of the world.

    ``data=-1`` takes ``world // model``. Raises ``ValueError`` unless
    ``data * model`` is the world's size: JAX may leave devices out of a
    mesh, but a rank outside it would have nothing to run. ``device``
    defaults to CUDA, on card ``local_rank % device_count`` (``LOCAL_RANK``
    from ``torchrun``, else the rank), which becomes the process's current
    card; the CPU only when asked. Outside a world, a ``1 x 1`` mesh joins a
    one-process world on a free localhost port.
    """
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if data == -1:
        data = world // model
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f"mesh {data}x{model} does not cover the world's "
                         f"{world} rank(s)")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        resolve_device(dev)  # raises without CUDA
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        _join(f"tcp://localhost:{free_port()}", 1, 0,
              choose_backend(dev, 1))
    backend = str(dist.get_backend())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the world runs NCCL, which takes no CPU tensors; "
                         "join it with backend='gloo' for a CPU mesh")
    # Every rank creates every group, in the same order.
    rows = [tuple(i * model + j for j in range(model)) for i in range(data)]
    cols = [tuple(i * model + j for i in range(data)) for j in range(model)]
    row_groups = [dist.new_group(list(r)) for r in rows]
    col_groups = [dist.new_group(list(c)) for c in cols]
    i, j = divmod(rank, model)
    return Mesh(shape={DATA_AXIS: data, MODEL_AXIS: model}, rank=rank,
                coords=(i, j), data_group=col_groups[j],
                model_group=row_groups[i], data_ranks=cols[j],
                model_ranks=rows[i], device=dev, backend=backend)


def mesh_device(mesh: Mesh | None,
                device: str | torch.device | None = None) -> torch.device:
    """The device a call runs on: ``device`` (default CUDA) without a mesh;
    with one the mesh's device, which ``device`` may name but not
    contradict."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def split(t: torch.Tensor, dim: int, index: int, parts: int) -> torch.Tensor:
    """Part ``index`` of ``parts`` equal parts of ``t`` along ``dim``;
    raises ``ValueError`` on an uneven split."""
    if t.shape[dim] % parts:
        raise ValueError(f"dimension {dim} of size {t.shape[dim]} does not "
                         f"split into {parts} equal parts")
    size = t.shape[dim] // parts
    return t.narrow(dim, index * size, size)


def gather(t: torch.Tensor, dim: int, ranks: tuple, group) -> torch.Tensor:
    """The inverse of :func:`split` over ``group`` (world ``ranks`` in part
    order): every rank broadcasts its part, so each gets the same bits."""
    me = dist.get_rank()
    t = t.contiguous()
    parts = [t if r == me else torch.empty_like(t) for r in ranks]
    for r, part in zip(ranks, parts):
        dist.broadcast(part, src=r, group=group)
    return torch.cat(parts, dim)


def shard_data(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """This data rank's rows of ``t``'s leading axis (on the mesh's
    device); raises ``ValueError`` unless the axis splits evenly."""
    return split(t.to(mesh.device), 0, mesh.coords[0], mesh.shape[DATA_AXIS])


def gather_data(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which every data rank holds ``t``, its rows."""
    return gather(t.to(mesh.device), 0, mesh.data_ranks, mesh.data_group)


def replicate(mesh: Mesh, x: nn.Module | torch.Tensor):
    """Broadcast from the mesh's rank 0: a module's parameters and buffers,
    in place (returns the module), or a tensor (returns it on the mesh's
    device)."""
    if isinstance(x, nn.Module):
        for t in list(x.parameters()) + list(x.buffers()):
            dist.broadcast(t.data, src=0)
        return x
    t = x.to(mesh.device).contiguous()
    dist.broadcast(t, src=0)
    return t


def all_reduce_mean(tensors: list[torch.Tensor], group, size: int) -> None:
    """Replace each tensor by its mean over ``group`` (``size`` ranks), in
    place, through one all-reduce of their flattened concatenation."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(size)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
