"""Device meshes, batch slicing and FSDP.

Counterpart of the JAX package's parallel/mesh.py (make_mesh :18,
batch_sharding :62, replicated_sharding :67, shard_params_fsdp :71). JAX runs
one program over a global batch whose rows XLA places on the devices; here
every rank runs the program on its own contiguous block of the global batch
(:func:`local_rows`), and :func:`gather_rows` puts the blocks back together.
A sharded run computes what the unsharded run computes when every random
draw is made for the GLOBAL batch and sliced, as JAX's partitionable
threefry makes it: inside :func:`batch_rows`, the port's samplers, its loss
and its evaluators draw through :func:`draw_rows`, which does exactly that.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# (index, count) of this rank's block of every batch drawn inside batch_rows;
# the counterpart of JAX's ambient mesh, scoped by the context manager
_ROWS: contextvars.ContextVar[Optional[Tuple[int, int]]] = \
    contextvars.ContextVar("dadiff_batch_rows", default=None)


def make_mesh(axes: Optional[Dict[str, int]] = None):
    """A named ``DeviceMesh`` over every rank of the default process group
    (mesh.py:18-59). ``axes`` maps names to sizes (``{'dp': world}`` by
    default), with at most one ``-1`` wildcard; the sizes must multiply to
    the world size. The mesh's devices are cards under NCCL and the CPU
    under gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: launch with torchrun and call "
            "parallel.distributed.initialize_distributed() first")
    n = dist.get_world_size()
    axes = {"dp": n} if axes is None else dict(axes)
    names, sizes = list(axes), list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one -1 wildcard axis size is allowed")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(names))


def axis_rank(mesh, axis: str = "dp") -> Tuple[int, int]:
    """(this rank's index along ``axis``, the axis size); (0, 1) without a
    mesh or when the mesh has no such axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0, 1
    sub = mesh[axis]
    return sub.get_local_rank(), sub.size()


def _rows_of(n: int, count: int) -> int:
    if n % count:
        raise ValueError(f"batch of {n} rows does not divide over {count} "
                         "ranks")
    return n // count


def local_rows(x, mesh, axis: str = "dp", dim: int = 0):
    """This rank's contiguous block of ``x`` along ``dim`` (a tensor, an
    array, or a tuple, NamedTuple, list or dict of them); ``x`` itself
    without a mesh. A batch the axis does not divide is refused, as in JAX."""
    index, count = axis_rank(mesh, axis)
    if count == 1:
        return x
    return _map(x, lambda a: _block(a, index, count, dim))


def _block(a, index: int, count: int, dim: int):
    n = _rows_of(a.shape[dim], count)
    if torch.is_tensor(a):
        return a.narrow(dim, index * n, n)
    return np.take(a, np.arange(index * n, (index + 1) * n), axis=dim)


def gather_rows(x, mesh, axis: str = "dp", dim: int = 0):
    """The inverse of :func:`local_rows`: every rank's block of each tensor,
    concatenated along ``dim`` in rank order, on every rank."""
    index, count = axis_rank(mesh, axis)
    if count == 1:
        return x
    group = mesh.get_group(axis)

    def gather(t):
        src = t.to(torch.uint8) if t.dtype == torch.bool else t
        parts = [torch.empty_like(src) for _ in range(count)]
        dist.all_gather(parts, src.contiguous(), group=group)
        out = torch.cat(parts, dim=dim)
        return out.to(torch.bool) if t.dtype == torch.bool else out

    return _map(x, gather)


def _map(x, fn):
    if isinstance(x, dict):
        return {k: _map(v, fn) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(v, fn) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_map(v, fn) for v in x)
    if x is None or not hasattr(x, "shape") or len(x.shape) == 0:
        return x
    return fn(x)


@contextlib.contextmanager
def batch_rows(mesh, axis: str = "dp") -> Iterator[None]:
    """Within the block, :func:`draw_rows` draws for the global batch and
    keeps this rank's rows. A no-op without a mesh."""
    index, count = axis_rank(mesh, axis)
    token = _ROWS.set((index, count) if count > 1 else None)
    try:
        yield
    finally:
        _ROWS.reset(token)


def draw_rows(draw: Callable[[int], torch.Tensor], n: int,
              dim: int = 0) -> torch.Tensor:
    """``draw(m)`` makes a draw whose dimension ``dim`` has ``m`` rows. This
    returns ``draw(n)``, or inside :func:`batch_rows` this rank's ``n`` rows
    of ``draw(n * count)``: every rank draws the same global tensor from its
    identically seeded generator and keeps its own block."""
    rows = _ROWS.get()
    if rows is None:
        return draw(n)
    index, count = rows
    return draw(n * count).narrow(dim, index * n, n)


def all_reduce_mean(values: Dict[str, torch.Tensor], mesh,
                    axis: str = "dp") -> Dict[str, torch.Tensor]:
    """The mean over the axis of each 0-dim tensor in ``values``, in one
    collective (every rank must call it at the same point)."""
    _, count = axis_rank(mesh, axis)
    if count == 1 or not values:
        return values
    from dadiff_tpu_torch.parallel.distributed import mesh_device

    names = list(values)
    flat = torch.stack([torch.as_tensor(values[k], dtype=torch.float32,
                                        device=mesh_device(mesh))
                        for k in names])
    dist.all_reduce(flat, group=mesh.get_group(axis))
    flat = flat / count
    return {k: flat[i] for i, k in enumerate(names)}


def shard_params_fsdp(module: torch.nn.Module, mesh, axis: str = "dp",
                      min_elements: int = 2 ** 14) -> torch.nn.Module:
    """FSDP2 (``torch.distributed.fsdp.fully_shard``) over ``axis``
    (mesh.py:71-91), in place; returns ``module``.

    Which parameters are sharded, and on which dim: EVERY parameter, on dim
    0 (FSDP2's ``Shard(0)``; a rank holds rows ``[r*ceil(n/k), ...)``, the
    last ranks fewer or none). JAX shards each leaf of at least
    ``min_elements`` on its largest dimension the axis divides and
    replicates the smaller leaves; FSDP2 replicates nothing it manages. Here
    ``min_elements`` decides the grouping: each submodule that directly
    holds a parameter of at least ``min_elements`` elements (a conv or a
    linear layer) is its own FSDP unit, all-gathered just before its
    forward and freed after; every other parameter belongs to ``module``'s
    unit. Gradients are reduce-scattered over the axis and averaged.

    With a ``dp`` axis beside ``axis``, the mesh's (dp, axis) sub-mesh is
    hybrid: parameters are sharded over ``axis`` and replicated over dp, and
    gradients are averaged over both, as the JAX train step averages a
    batch sharded over dp."""
    from torch.distributed.fsdp import fully_shard

    names = mesh.mesh_dim_names or ()
    sub = mesh[("dp", axis)] if axis != "dp" and "dp" in names else mesh[axis]
    for child in list(module.modules())[1:]:
        if any(p.numel() >= min_elements
               for p in child.parameters(recurse=False)):
            fully_shard(child, mesh=sub)
    fully_shard(module, mesh=sub)
    return module


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank (a collective); a plain tensor
    as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def full_state_dict(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``state`` with every DTensor (FSDP or tp) replaced by its whole value,
    detached: what a single-device module loads with ``strict=True``. Every
    rank calls it; it gathers."""
    return {k: full_tensor(v.detach()) if torch.is_tensor(v) else v
            for k, v in state.items()}


def place_like(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A whole ``value`` laid out as ``like``: its shards on ``like``'s mesh
    and placements when ``like`` is a DTensor (every rank holds the same
    ``value``), else ``value`` on ``like``'s device."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(like, DTensor):
        return distribute_tensor(value.to(like.device), like.device_mesh,
                                 like.placements)
    return value.to(like.device)
