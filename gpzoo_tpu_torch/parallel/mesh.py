"""Device meshes over ``torch.distributed`` (port of
``gpzoo_tpu/parallel/mesh.py``).

One process drives one rank of the mesh. A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` with named axes: the
minibatch's spot axis is split over ``"data"`` and, optionally, the latent
factors' per-factor state over ``"factor"``. The process group must exist
first (:func:`initialize_distributed`). Where the JAX package leaves the
collectives to XLA's partitioner, the port issues them itself
(:mod:`gpzoo_tpu_torch.parallel.collectives`).

Besides the JAX package's names, the module has the helpers the port's
sharded paths read a mesh with: :func:`axis_sizes`, :func:`axis_size`,
:func:`axis_index`, :func:`axis_group` (one axis or the product of
several, such as ``("hosts", "data")``) and :func:`mesh_device`.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _world_size():
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed() "
                           "(torch.distributed.init_process_group) first")
    return dist.get_world_size()


def create_mesh(axis_sizes: dict, device_type: str = "cuda"):
    """Mesh from ``{"axis": size, ...}`` over every rank of the process
    group; the sizes must multiply to the world size (one size may be -1,
    inferred). Ranks fill the mesh in row-major order. ``device_type`` is
    "cuda" unless the caller asks for "cpu"."""
    world = _world_size()
    names = tuple(axis_sizes)
    sizes = [int(s) for s in axis_sizes.values()]
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh {axis_sizes}: at most one size may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world // known if known else 0
    if math.prod(sizes) != world or min(sizes, default=1) < 1:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs "
                         f"{math.prod(sizes)} ranks, have {world}")
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=names)


def data_parallel_mesh(device_type: str = "cuda"):
    """1-D mesh over every rank with axis ``"data"``: the default layout of
    minibatch-sharded NSF training."""
    return create_mesh({"data": -1}, device_type)


def hybrid_mesh(dcn_axis_sizes: dict, ici_axis_sizes: dict,
                device_type: str = "cuda"):
    """Mesh whose leading (DCN) axes span hosts and whose trailing (ICI)
    axes span each host's local ranks: ranks are numbered contiguously per
    host (as ``torchrun`` does), so each contiguous block of the ICI
    product is one host, and collectives over the ICI axes stay inside a
    host. When ``LOCAL_WORLD_SIZE`` is set, the ICI product must equal it.
    Sizes may use -1 in at most one axis overall."""
    merged = {**dcn_axis_sizes, **ici_axis_sizes}
    if len(merged) != len(dcn_axis_sizes) + len(ici_axis_sizes):
        raise ValueError("dcn and ici axis names must be disjoint")
    local = os.environ.get("LOCAL_WORLD_SIZE")
    ici = list(ici_axis_sizes.values())
    if local is not None and -1 not in ici and math.prod(ici) != int(local):
        raise ValueError(f"ici axes {ici_axis_sizes} hold {math.prod(ici)} "
                         f"ranks, but a host has LOCAL_WORLD_SIZE={local}")
    return create_mesh(merged, device_type)


def initialize_distributed(backend=None, device_type="cuda", **kwargs):
    """``torch.distributed.init_process_group`` with the port's default
    backend: NCCL for ``device_type="cuda"``, gloo for ``"cpu"``; pass
    ``backend="gloo"`` to run gloo over CUDA tensors. There is no fallback:
    a machine with a card gets NCCL unless the caller asks otherwise.
    ``kwargs`` (``init_method``, ``world_size``, ``rank``, ...) pass
    through; nothing is read from a cluster's environment beyond what
    ``init_process_group`` itself reads."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type={device_type!r}: expected 'cuda' or 'cpu'")
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, **kwargs)


def _axes(axes):
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_sizes(mesh) -> dict:
    """``{"axis": size, ...}`` of ``mesh``, as JAX's ``Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, axes) -> int:
    """The number of ranks along one axis or the product of several (1 for
    an axis the mesh does not have)."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in _axes(axes))


def axis_index(mesh, axes) -> int:
    """This rank's coordinate along one axis, or along the row-major product
    of several (the first axis outermost, as JAX's ``P(("hosts",
    "data"))``); 0 for axes the mesh does not have."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for a in _axes(axes):
        index = index * sizes.get(a, 1) + coord.get(a, 0)
    return index


def axis_group(mesh, axes):
    """The process group of this rank's line along one axis or the product
    of several; None when the mesh has none of them. A product's groups are
    made once per mesh, by every rank in the same order, and kept on the
    mesh."""
    axes = tuple(a for a in _axes(axes) if a in mesh.mesh_dim_names)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_gpzoo_groups", {})
    if axes not in cache:
        names = list(mesh.mesh_dim_names)
        ranks = mesh.mesh.permute(
            [names.index(a) for a in names if a not in axes]
            + [names.index(a) for a in axes])
        lines = ranks.reshape(-1, math.prod(ranks.shape[-len(axes):]))
        cache[axes], _ = dist.new_subgroups_by_enumeration(lines.tolist())
    return cache[axes]


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on: the current CUDA device for a
    "cuda" mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
