"""Sharding plans: FSDP-style parameter sharding, batch / tile / staged
sharding, and the tile-sharded detector forward (counterpart of
facedet_tpu/parallel/sharding.py).

A JAX ``NamedSharding(mesh, P(...))`` becomes a list of DTensor placements,
one per mesh dimension of the 2-D ``(dp, tile)`` mesh:

  * ``replicated``      P()              -> [Replicate(), Replicate()]
  * ``batch_sharding``  P("dp", ...)     -> Shard(0) on ``dp``
  * ``tile_sharding``   P("tile", ...)   -> Shard(0) on ``tile``
  * ``staged_sharding`` P(None, "dp", ...) -> Shard(1) on ``dp``

XLA inserts the collectives a sharding implies; here the program does: each
rank takes its own contiguous share of a global array (``local_shard``, no
communication) and the tile forward all-gathers its per-tile detections
itself (``shard_tile_batch_forward``).

Hazard: the FSDP plan must pick the same physical axis as JAX's. JAX ranks
the dimensions of an HWIO conv kernel (a Dense kernel ``[in, out]``), the
port holds OIHW (``[out, in]``): for equal sizes the stable sort breaks the
tie on another axis, so a 3x3x64x64 kernel that JAX shards on I would be
sharded on O by a plan ranked in the port's layout. ``fsdp_param_shardings``
therefore ranks the flax layout (``from_jax``'s transposes undone) and maps
the chosen dimension back.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from facedet_tpu_torch.core.detections import Detections

__all__ = [
    "fsdp_param_shardings",
    "batch_sharding",
    "tile_sharding",
    "staged_sharding",
    "replicated",
    "local_shard",
    "shard_tile_batch_forward",
]


def replicated(mesh: DeviceMesh) -> list:
    return [Replicate()] * mesh.ndim


def _shard_on(mesh: DeviceMesh, axis: str, dim: int) -> list:
    placements = replicated(mesh)
    placements[mesh.mesh_dim_names.index(axis)] = Shard(dim)
    return placements


def batch_sharding(mesh: DeviceMesh, ndim: int, axis: str = "dp") -> list:
    """Shard dim 0 over the data axis, replicate the rest."""
    return _shard_on(mesh, axis, 0)


def tile_sharding(mesh: DeviceMesh, ndim: int, axis: str = "tile") -> list:
    """Shard dim 0 (the tile axis of a [T, 3, S, S] batch) over ``axis``."""
    return _shard_on(mesh, axis, 0)


def staged_sharding(mesh: DeviceMesh, ndim: int, axis: str = "dp") -> list:
    """Shard dim 1 (the batch axis of staged [N, B, ...] datasets) over
    ``axis``; the stage axis replicates, so every rank walks the same
    round-robin schedule."""
    return _shard_on(mesh, axis, 1)


def local_shard(x: torch.Tensor, mesh: DeviceMesh, placements: list) -> torch.Tensor:
    """This rank's contiguous share of the global tensor ``x`` under
    ``placements`` (each ``Shard(d)`` splits dim ``d`` evenly over its mesh
    dimension, in coordinate order). Every rank holds the whole ``x``; no
    communication."""
    for mesh_dim, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(mesh_dim)
            if x.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of size {x.shape[p.dim]} does not split over {n} ranks")
            x = x.chunk(n, dim=p.dim)[mesh.get_local_rank(mesh_dim)]
    return x


def _flax_dims(ndim: int) -> tuple[int, ...]:
    """For a port parameter of rank ``ndim``: the port dimension of each
    dimension of its flax leaf (``from_jax``: HWIO -> OIHW, [in, out] ->
    [out, in]; vectors as they are)."""
    if ndim == 4:
        return (2, 3, 1, 0)
    if ndim == 2:
        return (1, 0)
    return tuple(range(ndim))


def fsdp_param_shardings(
    module_or_params: Union[nn.Module, dict],
    mesh: DeviceMesh,
    axis: str = "tile",
    min_size: int = 2**14,
) -> dict[str, list]:
    """FSDP-style plan, per parameter name: ``Shard(d)`` on ``axis`` for the
    largest evenly divisible dimension of a tensor of at least ``min_size``
    elements, ranked as JAX ranks the flax leaf (module docstring); small
    tensors, and every tensor when ``axis`` has one rank, replicate."""
    params = (
        dict(module_or_params.named_parameters())
        if isinstance(module_or_params, nn.Module)
        else dict(module_or_params)
    )
    ax_size = mesh.size(mesh.mesh_dim_names.index(axis))

    def spec(x: torch.Tensor) -> list:
        if ax_size <= 1 or x.dim() == 0 or x.numel() < min_size:
            return replicated(mesh)
        dims = _flax_dims(x.dim())
        flax_shape = [x.shape[d] for d in dims]
        for j in sorted(range(x.dim()), key=lambda j: -flax_shape[j]):
            if flax_shape[j] % ax_size == 0:
                return _shard_on(mesh, axis, dims[j])
        return replicated(mesh)

    return {name: spec(p) for name, p in params.items()}


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """All ranks' equal [n, ...] blocks of ``x``, concatenated in group-rank
    order. bool travels as uint8."""
    world = dist.get_world_size(group)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    out = torch.empty((world * src.shape[0], *src.shape[1:]), dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src.contiguous(), group=group)
    return out.bool() if x.dtype == torch.bool else out


def shard_tile_batch_forward(forward_fn: Callable, mesh: DeviceMesh, tile_axis: str = "tile") -> Callable:
    """Wrap a per-tile-batch forward (tiles [T, 3, S, S] -> ``Detections``
    with leading dim T) so that each rank of ``tile_axis`` runs it on its own
    contiguous share of the tiles; the fixed-shape per-tile detections are
    all-gathered over the tile group, so every rank returns the whole
    [T, ...] result (replicated for the global merge). A tile count that does
    not divide is padded with zero tiles, whose rows are dropped after the
    gather."""
    group = mesh.get_group(tile_axis)
    n = mesh.size(mesh.mesh_dim_names.index(tile_axis))
    rank = mesh.get_local_rank(tile_axis)

    def sharded(tiles: torch.Tensor, *args) -> Detections:
        t = tiles.shape[0]
        per = math.ceil(t / n)
        if per * n != t:
            tiles = torch.cat([tiles, tiles.new_zeros((per * n - t, *tiles.shape[1:]))])
        det = forward_fn(tiles[rank * per : (rank + 1) * per], *args)
        return det.map(lambda x: _gather_rows(x, group)[:t])

    return sharded
