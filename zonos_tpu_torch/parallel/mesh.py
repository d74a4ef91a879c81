"""Process meshes over ``torch.distributed`` (zonos_tpu/parallel/mesh.py).

The JAX package runs one controller over a mesh of devices.  The port runs
one process per device (SPMD): every process calls the same entry points
with the same arguments, holds its own shard of each sharded weight, and
meets the others in the collectives of ``ops/tp.py``, which also reads
the mesh's axes (``mesh_shape``, ``axis_size``, ``axis_group``, ...).

Axis convention, as JAX's:

- ``"data"``: utterance-batch data parallelism (each data rank runs its own
  rows, the results are gathered);
- ``"model"``: tensor parallelism of the backbone's projections and the heads
  (Megatron layout, ``parallel/sharding.py``).

A rank's coordinates are ``rank = data * n_model + model``, the layout of
JAX's ``reshape(n_data, n_model)``.  The backend is NCCL for CUDA devices
and gloo for the CPU; gloo also carries CUDA tensors where two processes
share one card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from zonos_tpu_torch.ops.tp import AXES


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None) -> None:
    """Join the world of processes (a no-op for a world of 1 or a world
    already joined): ``init_process_group`` from the arguments, else from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  ``backend``: NCCL where a card is present, else gloo."""
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device: str | torch.device | None = None) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the world of processes;
    ``n_data * n_model`` must be the world size (``n_data`` None: the world
    size over ``n_model``).  ``device`` is this process's device, given
    explicitly (two ranks may share one card): a CUDA device becomes the
    current one.  Outside a world, a 1x1 mesh joins a world of one process
    in place (NCCL on a CUDA ``device``, else gloo)."""
    device = None if device is None else torch.device(device)
    if not dist.is_initialized():
        if (n_data or 1) * n_model != 1:
            raise RuntimeError(f"a {n_data}x{n_model} mesh needs a world of processes: launch "
                               "with torchrun, or call initialize_multihost first")
        backend = "nccl" if device is not None and device.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"{n_data}x{n_model} != {n} processes")
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.arange(n).reshape(n_data, n_model), mesh_dim_names=AXES)

