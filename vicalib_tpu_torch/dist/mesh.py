"""The shards of a multi-device calibration and where they sit.

Observations and IMU factors are split into ``n_shards`` contiguous shards
(dist/sharded.py); each process holds some of them, each on a device.  A
single process with ``-n_shards N`` holds all N, shard i on
``cuda:(i % torch.cuda.device_count())`` (so on one card all of them on
``cuda:0``), or all on the CPU.  In a multi-process run
(dist/multihost.py) each process holds a contiguous block of the shards on
its own device.  The JAX package's ``make_mesh(N)`` keeps
``min(N, devices)`` devices instead; here N shards always exist, several to
a device where devices are fewer.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

SHARD_AXIS = "shard"

log = logging.getLogger("vicalib_tpu_torch.dist")


@dataclasses.dataclass
class Mesh:
    """This process's shards of a sharded solve.

    ``devices[j]`` holds global shard ``shard_ids[j]``; ``n_shards`` counts
    the shards of every process.  ``group`` is the process group the
    partial systems are summed over (None in a single process)."""
    devices: tuple
    shard_ids: tuple
    n_shards: int
    rank: int = 0
    world_size: int = 1
    group: object = None
    backend: str = None

    def describe(self) -> str:
        return "process %d/%d holds shards %s of %d on %s%s" % (
            self.rank, self.world_size, list(self.shard_ids), self.n_shards,
            [str(d) for d in self.devices],
            "" if self.backend is None else ", %s collectives" % self.backend)


def _shard_device(device_type: str, i: int) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", i % torch.cuda.device_count())
    return torch.device(device_type)


def make_mesh(n_devices: int | None = None, devices=None,
              device="cuda") -> Mesh:
    """The shards of this process.

    ``n_devices`` shards in all (default: one per CUDA device, one on the
    CPU, or one per process when torch.distributed runs); ``devices``
    places them explicitly (single process).  ``device`` is the device
    type the shards go to when ``devices`` is not given."""
    from . import multihost

    dtype = torch.device(device).type
    rank, world = multihost.rank(), multihost.world_size()
    if world > 1:
        n = n_devices or world
        if devices is not None or n % world:
            raise ValueError(
                "%d processes need a shard count that divides over them "
                "(got %s)" % (world, n))
        per = n // world
        ids = tuple(range(rank * per, (rank + 1) * per))
        local = multihost.local_device(dtype)
        mesh = Mesh(devices=(local,) * per, shard_ids=ids, n_shards=n,
                    rank=rank, world_size=world, group=multihost.group(),
                    backend=multihost.backend())
    else:
        if devices is None:
            n = n_devices or (torch.cuda.device_count() if dtype == "cuda"
                              else 1)
            devices = [_shard_device(dtype, i) for i in range(n)]
        devices = tuple(torch.device(d) for d in devices)
        mesh = Mesh(devices=devices, shard_ids=tuple(range(len(devices))),
                    n_shards=len(devices))
    log.info("mesh: %s", mesh.describe())
    return mesh


def pad_to_multiple(a: np.ndarray, k: int, axis=0, pad_value=0):
    """Pad axis length to a multiple of k (for even sharding)."""
    n = a.shape[axis]
    rem = (-n) % k
    if rem == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, rem)
    return np.pad(a, widths, constant_values=pad_value)
