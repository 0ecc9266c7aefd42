"""Multi-process runtime on torch.distributed.

The reference is a single-process program; the JAX package scales the
calibration over processes with ``jax.distributed``, and this module is its
counterpart:

- ``initialize()`` joins the process group (``init_process_group`` over
  TCP, with a timeout so a lost peer ends the run instead of hanging it)
  and picks the collectives' backend;
- ``global_mesh()`` gives each process one shard on its own device,
  ``cuda:(rank % device_count)``;
- ``all_reduce_sum()`` sums the partial normal equations over processes
  and ``agree()`` hands every rank rank 0's host decision, so all ranks
  take the same branch.

Backend: NCCL when this rank's device is a CUDA card that no other rank on
the host uses; gloo on the CPU, or when ranks share a card (NCCL refuses
two ranks on one GPU).  Gloo exchanges host memory: a CUDA tensor is
copied to pinned host memory, reduced there and copied back, explicitly
below.  The state and the solve stay on the card.

Launch (one command per process):

  python -m vicalib_tpu_torch.cli ... -coordinator_address host0:1234 \\
      -num_processes 2 -process_id $RANK

The process group is process-wide state (torch.distributed's own); this
module records the backend chosen for it.
"""
from __future__ import annotations

import datetime
import logging
import socket

import torch
import torch.distributed as dist

from .. import obs

log = logging.getLogger("vicalib_tpu_torch.dist")

# every collective and the group's start give up after this many seconds
TIMEOUT_S = 300.0

# the group the partial systems are summed over and its backend, set by
# initialize() (None: torch.distributed's default group)
_COMM = {"group": None, "backend": None}


def choose_backend(device_type: str, placements) -> str:
    """"nccl" when this process's device is CUDA and no two processes share
    a card, else "gloo".  ``placements``: (host, device index) of every
    rank, the same list on every rank."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if len(set(placements)) == len(placements) else "gloo"


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device="cuda") -> torch.device:
    """Join the process group and return this process's device.

    The group starts on gloo (it works on every device); the ranks then
    exchange where they run and, where choose_backend says so, the sums go
    over a second, NCCL group."""
    from ..device import resolve_device

    dtype = resolve_device(device).type
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group(
        "gloo", init_method="tcp://%s" % coordinator_address,
        world_size=num_processes, rank=process_id, timeout=timeout)
    local = local_device(dtype)
    if local.type == "cuda":
        torch.cuda.set_device(local)
    placements = [None] * num_processes
    dist.all_gather_object(placements,
                           (socket.gethostname(), local.index))
    backend = choose_backend(dtype, [tuple(p) for p in placements])
    group = None
    if backend == "nccl":
        group = dist.new_group(backend="nccl", timeout=timeout)
    _COMM.update(group=group, backend=backend)
    log.info("distributed runtime up: process %d/%d on %s, %s collectives",
             process_id, num_processes, local, backend)
    return local


def shutdown():
    """Leave the process group (a no-op when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _COMM.update(group=None, backend=None)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes outputs and logs."""
    return rank() == 0


def group():
    return _COMM["group"]


def backend():
    return _COMM["backend"] if dist.is_initialized() else None


def local_device(device_type: str) -> torch.device:
    """This process's device: ``cuda:(rank % device_count)`` or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank() % torch.cuda.device_count())
    return torch.device(device_type)


def global_mesh(device="cuda"):
    """One shard per process, each on that process's device."""
    from .mesh import make_mesh

    return make_mesh(world_size(), device=device)


def global_shard(mesh, a):
    """This process's rows of a host-replicated (n_shards, ...) array, one
    per local shard, each on its shard's device.  Every process passes the
    same full array."""
    if a.shape[0] != mesh.n_shards:
        raise ValueError("leading axis %d is not the mesh's %d shards"
                         % (a.shape[0], mesh.n_shards))
    return [torch.as_tensor(a[i]).to(d)
            for i, d in zip(mesh.shard_ids, mesh.devices)]


def global_replicated(mesh, a):
    """A host-consistent value on this process's first shard device."""
    return torch.as_tensor(a).to(mesh.devices[0])


def _comm_tensor(mesh, t):
    """The tensor handed to the backend: gloo exchanges host memory, so a
    CUDA tensor is staged through pinned host memory."""
    if mesh.backend == "gloo" and t.is_cuda:
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=True).copy_(t)
    return t


def all_reduce_sum(mesh, tensors):
    """Sum same-dtype tensors over the processes of ``mesh`` with one
    all-reduce of their concatenation; returns the sums, on the tensors'
    device."""
    if mesh.world_size == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    with obs.span("vicalib.dist.collective"):
        buf = _comm_tensor(mesh, flat)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
        if buf is not flat:
            flat = buf.to(flat.device)
    obs.count("vicalib.dist.collective_bytes",
              flat.numel() * flat.element_size())
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def agree(mesh, flag: bool) -> bool:
    """Rank 0's value of a host decision, on every rank."""
    if mesh.world_size == 1:
        return flag
    with obs.span("vicalib.dist.collective"):
        dev = mesh.devices[0] if mesh.backend == "nccl" else "cpu"
        t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
        dist.broadcast(t, src=0, group=mesh.group)
    obs.count("vicalib.dist.collective_bytes", 4)
    return bool(t.item())
