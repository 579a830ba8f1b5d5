"""Process-group set-up and the global mesh.

Counterpart of hipt_abmil_atec23_tpu/parallel/multihost.py on
``torch.distributed``. Each process drives one device; the process group
carries the collectives (NCCL between CUDA devices, gloo between CPU
processes).

Layout rule, as in the JAX package: put the outer, rarely communicating
axis across hosts. ``global_mesh(host_axis=...)`` gives a 2-D (host, axis)
mesh whose leading axis spans hosts and whose trailing axis spans each
host's local ranks (torchrun numbers ranks host by host).
"""
from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from hipt_abmil_atec23_tpu_torch.device import resolve_device


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *, device,
                   init_method: Optional[str] = None) -> int:
    """Join (or create) the default process group; returns the world size.

    The backend follows ``device``: NCCL for a CUDA device, gloo for the
    CPU. An index-less ``"cuda"`` resolves to the launcher's LOCAL_RANK
    (``device.resolve_device``), and that card becomes this process's
    current device before any group or mesh exists, so each rank's NCCL
    communicator sits on its own card. Under a launcher (RANK and
    WORLD_SIZE set, no arguments) the group takes its rank and size from
    the environment and rendezvouses through ``env://``, or through
    ``init_method`` (e.g. ``file://`` a store path) where given. Otherwise
    it rendezvouses through ``init_method`` or ``tcp://coordinator_address``
    with ``num_processes`` ranks, this one ``process_id``. With no
    arguments and no launcher it forms a group of one (on a free localhost
    port without ``init_method``): the sharded forward always needs a
    group. An existing group is kept."""
    device = resolve_device(device)
    if dist.is_initialized():
        return dist.get_world_size()
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if coordinator_address is None and num_processes is None and launched:
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
        init_method = init_method or "env://"
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if init_method is None:
        if coordinator_address is None:
            if world > 1:
                raise ValueError("init_multihost: more than one process "
                                 "needs a coordinator_address (host:port)")
            coordinator_address = f"localhost:{_free_port()}"
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return world


def global_mesh(axis_name: str = "fold", *, host_axis: Optional[str] = None,
                n_hosts: Optional[int] = None):
    """A mesh over every rank of the default group, on the group's device
    type (CUDA under NCCL, CPU under gloo).

    - default: one ``axis_name`` axis over every rank;
    - ``host_axis``: a 2-D (host, axis) mesh. ``n_hosts`` defaults to the
      world size over torchrun's LOCAL_WORLD_SIZE (one host when that is
      unset); giving it simulates a host split on one machine.
    """
    from hipt_abmil_atec23_tpu_torch.parallel.mesh import make_mesh

    world = dist.get_world_size()
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if host_axis is None:
        return make_mesh([(axis_name, world)], device_type)
    hosts = n_hosts or world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % hosts:
        raise ValueError(f"{world} devices do not split over {hosts} hosts")
    return make_mesh([(host_axis, hosts), (axis_name, world // hosts)],
                     device_type)
