# Copyright (c) 2026
# MIT License
"""The (tile, azim) mesh of shard slots (counterpart of
:mod:`horayzon_tpu.parallel.mesh`, which builds a ``jax.sharding.Mesh``).

A :class:`Mesh` is an (n_tile, n_azim) array of shard *slots*: slot
``(t, a)`` sweeps the inner rows of tile ``t`` and the azimuths of azimuth
shard ``a``.  Each slot holds a ``torch.device`` and the rank of the
process that runs it.  One device may fill several slots: its shards then
run in turn on it, which is how one H100 runs a (4, 2) mesh, and how the
CPU tests run the reference's 8-device meshes on
``[torch.device("cpu")] * 8`` (the port's stand-in for the reference's
virtual devices, ``tests/conftest.py``'s forced 8 CPU devices).

Without a ``torch.distributed`` process group one process runs every slot.
With one, the slots go to the ranks row-major over the tile axis, as the
reference lays hosts out (``horayzon_tpu/parallel/distributed.py:58-59``):
each rank holds ``len(devices)`` consecutive slots, which must be whole
rows of the mesh, so the azim axis stays within a process (the sharded
entries sum the z_org cotangent over a tile's azimuth shards in order there).
"""

import numpy as np
import torch
import torch.distributed as dist

AXIS_TILE = "tile"
AXIS_AZIM = "azim"


class Mesh:
    """Slots of a sharded run: ``devices`` and ``ranks``, (n_tile, n_azim)
    object and int arrays; ``shape`` maps :data:`AXIS_TILE` and
    :data:`AXIS_AZIM` to their sizes as a ``jax.sharding.Mesh``'s does;
    ``rank`` and ``world`` are this process's rank and the number of
    processes (0 and 1 without a process group)."""

    def __init__(self, devices, ranks, rank=0, world=1):
        self.devices = devices
        self.ranks = ranks
        self.rank, self.world = rank, world
        self.shape = {AXIS_TILE: devices.shape[0], AXIS_AZIM: devices.shape[1]}

    def local_slots(self):
        """``(t, a, device)`` of this process's slots, row-major."""
        n_tile, n_azim = self.devices.shape
        return [(t, a, self.devices[t, a]) for t in range(n_tile)
                for a in range(n_azim) if self.ranks[t, a] == self.rank]

    def local_tiles(self):
        """The tiles whose slots this process runs, in order."""
        return sorted({t for t, _, _ in self.local_slots()})

    @property
    def device(self):
        """This process's first slot's device: where results are returned."""
        return self.local_slots()[0][2]


def cuda_devices():
    """Every local CUDA device."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_tile=None, n_azim=1, devices=None):
    """A (tile, azim) mesh over this process's ``devices`` (default: every
    local CUDA device), times the processes of the ``torch.distributed``
    group if there is one.  ``n_tile`` defaults to the slot count over
    ``n_azim``.  ``devices`` may repeat a device: its slots run in turn."""
    if devices is None:
        devices = cuda_devices()
        if not devices:
            raise ValueError("no CUDA device: pass devices (e.g. "
                             "[torch.device('cpu')] * 8)")
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    grouped = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    world = dist.get_world_size() if grouped else 1
    per = len(devices)
    n_slot = per * world
    if n_tile is None:
        if n_slot % n_azim != 0:
            raise ValueError("slot count not divisible by n_azim")
        n_tile = n_slot // n_azim
    if n_tile * n_azim != n_slot:
        raise ValueError(f"mesh {n_tile}x{n_azim} != {n_slot} slots "
                         f"({world} processes x {per} devices)")
    if per % n_azim != 0:
        raise ValueError(f"each process must hold whole rows of the mesh: "
                         f"{per} slots per process for n_azim {n_azim}")
    dev = np.empty((n_tile, n_azim), dtype=object)
    ranks = np.empty((n_tile, n_azim), dtype=np.int64)
    for k in range(n_slot):
        t, a = divmod(k, n_azim)
        ranks[t, a] = k // per
        # another rank's slot holds that rank's device of the same index
        dev[t, a] = devices[k % per]
    return Mesh(dev, ranks, rank, world)
