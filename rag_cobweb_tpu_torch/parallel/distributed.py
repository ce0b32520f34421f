"""Process-group start-up and meshes for the multi-device port (port of
``rag_cobweb_tpu/parallel/distributed.py``).

The JAX package runs one controller over every device of a host; the port
runs one process (a rank) per device, SPMD: every rank calls the same
facade with the same host arguments, keeps only its own shard and
returns the merged result.

  * ``initialize()`` starts ``torch.distributed`` (a no-op when no
    coordinator is configured, as the JAX version is): NCCL between
    cards, gloo on the host;
  * ``forest_mesh`` is the sharded forest's ``DeviceMesh``: 1-D
    ``("shard",)`` over the ranks of one host, ``("replica", "shard")``
    of shape (hosts, ranks a host) across hosts, so that the candidate
    merge over ``shard`` stays within a host and only merged candidates
    cross hosts;
  * a facade reads its process group from the mesh by axis name
    (``mesh.get_group(axis)``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def launch_config(coordinator_address: Optional[str] = None,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None, env=None):
    """(init_method, world size, rank) of this process, or None when no
    coordinator is configured.  Explicit arguments win; otherwise the
    JAX package's contract (``JAX_COORDINATOR_ADDRESS`` = host:port,
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``, falling back to SLURM's
    ``SLURM_NTASKS`` / ``SLURM_PROCID``), then torchrun's (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), so the same launch scripts
    start either package."""
    env = os.environ if env is None else env

    def _int(*names):
        for n in names:
            if env.get(n):
                return int(env[n])
        return None

    addr = coordinator_address or env.get("JAX_COORDINATOR_ADDRESS")
    if addr is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if addr is None and num_processes is None:
        return None
    if addr is None:
        raise ValueError("num_processes given but no coordinator address "
                         "(JAX_COORDINATOR_ADDRESS or MASTER_ADDR/PORT)")
    if num_processes is None:
        num_processes = _int("JAX_NUM_PROCESSES", "SLURM_NTASKS",
                             "WORLD_SIZE")
    if process_id is None:
        process_id = _int("JAX_PROCESS_ID", "SLURM_PROCID", "RANK")
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator {addr} but no world size or rank in "
                         "the arguments or the environment")
    return f"tcp://{addr}", num_processes, process_id


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               backend: Optional[str] = None,
               init_method: Optional[str] = None) -> bool:
    """Start the default process group; False (nothing done) on a single
    process with no coordinator configured (``launch_config``), True when
    a group runs.  ``device="cuda"`` selects this rank's card,
    ``LOCAL_RANK`` (else the rank) modulo the cards, so ranks beyond the
    cards share them, and the backend ``nccl``; ``device="cpu"`` the
    backend ``gloo``.  ``backend``
    overrides the choice (gloo for several ranks on one card, which NCCL
    refuses); ``init_method`` (a ``file://`` or ``tcp://`` URL) with
    ``num_processes`` and ``process_id`` bypasses the environment."""
    if dist.is_initialized():
        return True
    if init_method is None:
        cfg = launch_config(coordinator_address, num_processes, process_id)
        if cfg is None:
            return False
        init_method, num_processes, process_id = cfg
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def _mesh_device_type() -> str:
    """The DeviceMesh device type of the default group's backend: a gloo
    group (the host, or several ranks on one card) is a "cpu" mesh."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "shard") -> DeviceMesh:
    """1-D mesh over the first ``n_devices`` ranks (all by default) of the
    started process group (the JAX package keeps it in
    ``parallel/forest.py``, and so does the port's namespace)."""
    n = n_devices or dist.get_world_size()
    return DeviceMesh(_mesh_device_type(), list(range(n)),
                      mesh_dim_names=(axis_name,))


def forest_mesh(shards_per_host: Optional[int] = None,
                shard_axis: str = "shard",
                replica_axis: str = "replica") -> DeviceMesh:
    """Mesh for the sharded forest over the started process group.  One
    host (``LOCAL_WORLD_SIZE``, as torchrun sets it, unset or equal to the
    world size): a 1-D ``(shard_axis,)`` mesh over the first
    ``shards_per_host`` ranks.  Several hosts: ``(replica_axis,
    shard_axis)`` of shape (hosts, ranks a host), the first
    ``shards_per_host`` ranks of each host."""
    world = dist.get_world_size()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE") or world)
    n_hosts = max(1, world // max(n_local, 1))
    shards = shards_per_host or n_local
    dev = _mesh_device_type()
    if n_hosts == 1:
        return DeviceMesh(dev, list(range(shards)),
                          mesh_dim_names=(shard_axis,))
    grid = torch.arange(world).view(n_hosts, n_local)[:, :shards]
    return DeviceMesh(dev, grid, mesh_dim_names=(replica_axis, shard_axis))


def local_shard_count(mesh: DeviceMesh, shard_axis: str = "shard") -> int:
    return mesh.size(mesh.mesh_dim_names.index(shard_axis))


def axis_group(mesh: DeviceMesh, axis: str):
    """(process group, this rank's index along ``axis``, its size)."""
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)
