"""Meshes of ranks (port of ``repro/launch/mesh.py``).

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group, one process a rank.  The engine
shards the round's client axis over the mesh's ``pod`` and ``data`` axes
and treats ``model`` as replicated; the tensor-parallel LM layouts
(``repro_torch.launch.sharding``, ``repro_torch.parallel``) also split
the transformer over ``model``.  On the card the backend is NCCL; a
mesh asked for on the CPU (``device="cpu"``) uses gloo.  A process that
initialised its own default group (gloo, say, for two ranks on one card,
which NCCL refuses) keeps it: ``make_mesh`` only creates a group where
there is none.

A :class:`MeshSpec` names axes and sizes and holds no ranks: the
counterpart of ``jax.sharding.AbstractMesh``.  Every layout function
takes one as well as a ``DeviceMesh``, so layouts of a 256- or 512-rank
mesh are computed in one process.

Processes started by ``torchrun`` find their rank, world size and
rendezvous in the environment; a process started without it (and
without a process group of its own) gets a one-rank group on an
in-process store, so its mesh is 1 x 1.  The JAX package's
``mesh_context`` (activating a mesh for tracing) has no counterpart: a
``DeviceMesh`` is passed explicitly and nothing reads a current one.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from repro_torch.device import resolve_device

__all__ = ["MeshSpec", "make_mesh", "make_host_mesh", "make_engine_mesh",
           "make_production_mesh", "production_shape", "batch_axes",
           "client_axes", "axis_size", "axis_sizes", "client_position",
           "client_group", "axes_group", "axes_position", "axes_place",
           "mesh_device", "release_groups"]

_CLIENT_AXES = ("pod", "data")

# process groups over sets of mesh axes, by the ranks of each group: every
# rank creates every group in the same order, once
_GROUPS: Dict[Tuple[Tuple[int, ...], ...], list] = {}


class MeshSpec:
    """A mesh's axis names and sizes, without ranks (the port's
    ``jax.sharding.AbstractMesh``): ``MeshSpec((16, 16), ("data",
    "model"))``.  ``shape`` maps each name to its size, in axis order."""

    def __init__(self, shape, axis_names):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or min(shape, default=1) < 1:
            raise ValueError(f"MeshSpec: shape {shape} and axes "
                             f"{axis_names} must pair up, sizes >= 1")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __eq__(self, other):
        return (isinstance(other, MeshSpec)
                and tuple(self.shape.items()) == tuple(other.shape.items()))

    def __hash__(self):
        return hash(tuple(self.shape.items()))

    def __repr__(self):
        return f"MeshSpec({tuple(self.shape.values())}, {self.axis_names})"


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _ensure_process_group(device_type: str) -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        dist.init_process_group(_backend(device_type))     # env:// (torchrun)
    else:
        dist.init_process_group(_backend(device_type),
                                store=dist.HashStore(), rank=0,
                                world_size=1)


def _device_type(device) -> str:
    return resolve_device(device).type


def make_mesh(shape, axes, *, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks ``0 ..
    prod(shape) - 1`` in row-major order, on the card unless ``device``
    names another (``"cpu"``: gloo).  Every rank of the default group
    calls it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    device_type = _device_type(device)
    _ensure_process_group(device_type)
    n = 1
    for s in shape:
        n *= int(s)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {tuple(shape)} wants {n} ranks, the process "
                         f"group has {world}")
    if device_type == "cuda":     # this rank's card, before the mesh's groups
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_host_mesh():
    """1 x 1 mesh on the CPU (the smoke paths')."""
    return make_mesh((1, 1), ("data", "model"), device="cpu")


def make_engine_mesh(n_client_shards: int = None, *, device=None):
    """Mesh for the client-parallel engine: ``(n, 1)`` named ``("data",
    "model")``, ``n`` = ``n_client_shards`` or every rank of the process
    group.  On the card (NCCL) unless ``device="cpu"`` (gloo); with no card
    and no CPU asked for it raises ``RuntimeError``.  Raising the rank
    count is the launcher's business (``torchrun --nproc-per-node=N``)."""
    import torch.distributed as dist
    device_type = _device_type(device)
    _ensure_process_group(device_type)
    n = n_client_shards or dist.get_world_size()
    return make_mesh((n, 1), ("data", "model"), device=device_type)


def production_shape(multi_pod: bool = False):
    """``(shape, axes)`` of the production mesh: 16 x 16 named ``("data",
    "model")``, or 2 x 16 x 16 named ``("pod", "data", "model")``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh over ranks ``0 .. 255`` (or ``0 .. 511``) of
    the default group; with fewer ranks :func:`make_mesh` raises
    ``ValueError`` naming the count it wants."""
    shape, axes = production_shape(multi_pod)
    return make_mesh(shape, axes, device=device)


def _check_mesh(mesh):
    """A ``DeviceMesh`` or a :class:`MeshSpec` with named axes."""
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, MeshSpec):
        return
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(repro_torch.launch.mesh.make_engine_mesh), got "
                        f"{type(mesh).__name__}")
    if not mesh.mesh_dim_names:
        raise ValueError("the engine's mesh needs named axes "
                         "(e.g. ('data', 'model'))")


def _check_ranks(mesh):
    """``mesh`` must hold ranks: a ``DeviceMesh``, not a ``MeshSpec``."""
    _check_mesh(mesh)
    if isinstance(mesh, MeshSpec):
        raise TypeError("this needs a DeviceMesh of ranks, got a MeshSpec "
                        "(axis names and sizes only)")


def axis_names(mesh) -> tuple:
    _check_mesh(mesh)
    return (mesh.axis_names if isinstance(mesh, MeshSpec)
            else tuple(mesh.mesh_dim_names))


def axis_sizes(mesh) -> Dict[str, int]:
    """Each axis name of ``mesh`` with its size, in axis order."""
    _check_mesh(mesh)
    if isinstance(mesh, MeshSpec):
        return dict(mesh.shape)
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def mesh_device(mesh) -> torch.device:
    """The device this rank runs on for ``mesh``."""
    _check_ranks(mesh)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_axes(mesh) -> tuple:
    """Mesh axes a batch-like dimension shards over."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def client_axes(mesh) -> tuple:
    """Mesh axes the federated CLIENT axis shards over (major to minor):
    those of ``("pod", "data")`` the mesh has, in that order, which the
    engine's positional client split relies on (a rank's position is its
    row-major index over these axes)."""
    return tuple(a for a in _CLIENT_AXES if a in axis_names(mesh))


def axis_size(mesh, *names) -> int:
    """The product of the sizes of those of ``names`` the mesh has."""
    sizes = axis_sizes(mesh)
    s = 1
    for n in names:
        s *= sizes.get(n, 1)
    return s


def client_position(mesh):
    """``(axes, sizes, position)``: the client axes, their sizes and this
    rank's row-major index over them.  Makes no collective."""
    axes = client_axes(mesh)
    sizes, position = axes_position(mesh, axes)
    return axes, sizes, position


def axes_position(mesh, axes):
    """``(sizes, position)``: the sizes of ``axes`` (present on the mesh,
    major to minor) and this rank's row-major index over them.  Makes no
    collective."""
    _check_ranks(mesh)
    names = mesh.mesh_dim_names
    sizes = tuple(mesh.size(names.index(a)) for a in axes)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    position = 0
    for a, s in zip(axes, sizes):
        position = position * s + coord[names.index(a)]
    return sizes, position


def axes_place(mesh, axes):
    """``(group, size, position)`` over those of ``axes`` the mesh has:
    :func:`axes_group` (None where they hold one rank), the product of
    their sizes and :func:`axes_position`'s index, what
    ``repro_torch.parallel.ModelParallel`` asks of a mesh."""
    axes = tuple(a for a in axes if a in axis_names(mesh))
    if not axes:
        return None, 1, 0
    sizes, position = axes_position(mesh, axes)
    n = 1
    for s in sizes:
        n *= s
    return (axes_group(mesh, axes) if n > 1 else None), n, position


def release_groups() -> None:
    """Forget the subgroups :func:`axes_group` made: call it after
    ``destroy_process_group``, which destroyed them."""
    _GROUPS.clear()


def client_group(mesh):
    """The process group of the ranks that share this rank's coordinates
    off the client axes (every rank of the mesh when ``model`` is 1).
    Every rank of the default group calls it at the same point: it may
    create groups."""
    return axes_group(mesh, client_axes(mesh))


def axes_group(mesh, axes):
    """The process group of the ranks that share this rank's coordinates
    off ``axes`` (mesh axes, major to minor): its members are ordered by
    their row-major index over ``axes``.  Every rank of the default group
    calls it at the same point for the same ``axes``: it may create
    groups."""
    import torch.distributed as dist
    _check_ranks(mesh)
    axes = tuple(axes)
    names = list(mesh.mesh_dim_names)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    client_dims = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in client_dims]
    ranks = mesh.mesh.permute(client_dims + rest)
    n_client = 1
    for d in client_dims:
        n_client *= mesh.size(d)
    cols = ranks.reshape(n_client, -1).t().tolist()
    key = tuple(tuple(c) for c in cols)
    if key not in _GROUPS:
        _GROUPS[key] = [dist.new_group(ranks=list(c)) for c in cols]
    me = dist.get_rank()
    for c, g in zip(cols, _GROUPS[key]):
        if me in c:
            return g
    raise ValueError("this rank is not in the mesh")
