"""Device mesh construction and axis conventions (counterpart of
facedet_tpu/parallel/mesh.py).

The workload has two parallel axes:

  * ``dp``   — data parallelism over the image stream and over training
               batches;
  * ``tile`` — spatial parallelism over the SAHI tile batch of one image;
               doubles as the FSDP axis of the parameters in training.

Where the JAX package builds a ``jax.sharding.Mesh`` over the local devices
of one process, the port builds a ``torch.distributed`` ``DeviceMesh`` over
the ranks of a process group: one process per device, each running the same
program (``torchrun --nproc-per-node N``). The group must exist before the
mesh is made; nothing here starts one. Rank ``r`` sits at
``(r // tile, r % tile)``, the row-major order of ``init_device_mesh``.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["create_mesh", "mesh_shape_for", "DeviceMesh"]


def mesh_shape_for(n_devices: int, prefer_tile: int = 2) -> tuple[int, int]:
    """Factor n devices into (dp, tile); tile gets ``prefer_tile`` when it
    divides evenly, else everything goes to dp."""
    if n_devices % prefer_tile == 0 and n_devices > 1:
        return n_devices // prefer_tile, prefer_tile
    return n_devices, 1


def create_mesh(
    n_devices: int | None = None,
    axis_names: tuple[str, str] = ("dp", "tile"),
    shape: tuple[int, int] | None = None,
) -> DeviceMesh:
    """A 2-D ``DeviceMesh`` over every rank of the initialised process group,
    of the devices its backend drives: ``cuda`` under NCCL, ``cpu`` under
    gloo. Raises
    when no group is initialised and when ``n_devices`` (default: the world
    size) or the product of ``shape`` is not the world size: every rank of
    the group is a device of the mesh."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs an initialised torch.distributed process group "
            "(torchrun, or dist.init_process_group with a rank and a world size)"
        )
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"requested {n_devices} devices, the process group has {world} ranks")
    if shape is None:
        shape = mesh_shape_for(n_devices)
    if shape[0] * shape[1] != n_devices:
        raise ValueError(f"mesh shape {shape} does not hold {n_devices} devices")
    device_type = "cuda" if "nccl" in dist.get_backend() else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))
