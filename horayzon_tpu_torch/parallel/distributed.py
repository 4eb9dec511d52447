# Copyright (c) 2026
# MIT License
"""Multi-process start-up and the collectives of the sharded entries
(counterpart of :mod:`horayzon_tpu.parallel.distributed`).

The reference connects processes with JAX's distributed runtime and lets
``shard_map`` move data; here :func:`init_distributed` starts a
``torch.distributed`` process group (``tcp://`` rendezvous) and builds the
(tile, azim) mesh of :mod:`.mesh`, whose tile axis spans the processes.
Two-process recipe::

    # process 0 and process 1 (same command, HZT_PROCESS_ID 0 and 1)
    HZT_COORDINATOR=10.0.0.1:8476 HZT_NUM_PROCESSES=2 HZT_PROCESS_ID=0 \\
        python sweep.py

where the script calls::

    from horayzon_tpu_torch import parallel
    mesh = parallel.init_distributed(n_azim=4)
    hori = parallel.horizon_sweep_fused_sharded(mesh, z, ...)

The reference's ``_on_tpu_pod`` (auto-detection of a TPU pod's
coordinator) is TPU-only and has no counterpart: without the three
variables (or arguments) no process group is started.

What ``shard_map`` did implicitly, the two collectives below do, and
nothing else moves between processes: :func:`assemble_rows` gathers the
shards' outputs to their global rows on every process, :func:`all_reduce`
sums the replay's fixed-point words (and takes the maximum of its level
maxima).  With the ``gloo`` backend a CUDA tensor goes through host memory
(gloo reduces and gathers host buffers); with ``nccl`` it stays on the
card.
"""

import os

import torch
import torch.distributed as dist

from horayzon_tpu_torch.parallel import mesh as _mesh


def init_distributed(n_tile=None, n_azim=1, *, coordinator_address=None,
                     num_processes=None, process_id=None,
                     local_device_ids=None, devices=None, backend=None):
    """Start the process group (if configured and not started yet) and
    build the global (tile, azim) mesh.

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` default to ``HZT_COORDINATOR``, ``HZT_NUM_PROCESSES``
    and ``HZT_PROCESS_ID``; with none of the first two set, no group is
    started and the mesh is this process's alone, as the reference leaves
    a single process untouched.  ``devices``: this process's slot devices
    (default: every local CUDA device, or those of ``local_device_ids``).
    ``backend``: ``"nccl"`` by default for CUDA devices, ``"gloo"`` for the
    CPU; a failed ``init_process_group`` raises, and no other backend is
    tried.  Returns the :class:`.mesh.Mesh`."""
    coordinator_address = coordinator_address or os.environ.get(
        "HZT_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("HZT_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("HZT_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if devices is None:
        devices = _mesh.cuda_devices()
        if local_device_ids is not None:
            devices = [torch.device("cuda", i) for i in local_device_ids]
    devices = [torch.device(d) for d in devices]
    explicit = bool(coordinator_address or num_processes)
    if explicit and not dist.is_initialized():
        if not (coordinator_address and num_processes
                and process_id is not None):
            raise ValueError("a process group needs the coordinator address, "
                             "the number of processes and this process's id")
        if backend is None:
            backend = ("nccl" if devices and devices[0].type == "cuda"
                       else "gloo")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
    return _mesh.make_mesh(n_tile=n_tile, n_azim=n_azim, devices=devices)


def _via_host(t):
    """Whether ``t`` crosses the process group through host memory."""
    return t.is_cuda and dist.get_backend() == "gloo"


def all_reduce(t, mesh, op="sum"):
    """``t`` reduced over the processes of ``mesh`` (in place; ``op``
    ``"sum"`` or ``"max"``); ``t`` itself with one process."""
    if mesh.world == 1:
        return t
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if _via_host(t):
        host = t.cpu()
        dist.all_reduce(host, rop)
        t.copy_(host)
    else:
        dist.all_reduce(t, rop)
    return t


def assemble_rows(local, mesh, dim):
    """The whole run's tensor from this process's block ``local`` (its
    tiles' rows, consecutive along ``dim``): the blocks of all processes in
    rank order, concatenated along ``dim``, on every process.  Every
    process holds as many tiles, so the blocks have one shape."""
    if mesh.world == 1:
        return local
    local = local.contiguous()
    send = local.cpu() if _via_host(local) else local
    parts = [torch.empty_like(send) for _ in range(mesh.world)]
    dist.all_gather(parts, send)
    return torch.cat(parts, dim=dim).to(local.device)
