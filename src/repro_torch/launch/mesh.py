"""The meshes: the LM's ``("data", "model")`` mesh and the round engine's
``("data",)`` mesh, over ``torch.distributed``.

Port of ``repro/launch/mesh.py``.  JAX drives every device of a mesh from
one process; here each rank is a process.

* ``make_host_mesh(data, model)`` / ``make_production_mesh(multi_pod=)``:
  the LM's mesh, a ``torch.distributed.device_mesh.DeviceMesh`` with
  ``mesh_dim_names=("data", "model")`` (or ``("pod", "data", "model")``)
  over an initialized process group of exactly ``data * model`` ranks.
  Parameters are DTensors on it (``launch.shardings.distribute``) and the
  expert-parallel MoE takes its axes' process groups.  A mesh of one
  device needs no process group: without a group of one rank,
  ``make_host_mesh(1, 1)`` is a ``LocalMesh``, on which tensors stay
  plain and every collective is the identity.  It is the default of the
  steps and the serve engine.
* ``make_round_mesh(n)``: the round engine's 1-D mesh, the rank's view of
  the whole group: its size, its rank, its device, and the two moves a
  sharded program makes, ``shard`` (take this rank's block of a tensor
  every rank holds) and ``gather`` (all-gather the ranks' blocks).

Every rank runs the round's whole host pipeline (and the LM step's
Python) from the same seed, so a mesh spans the whole process group.

The collectives the expert-parallel MoE makes (``all_to_all``,
``all_gather``, ``reduce_scatter``, ``all_reduce_mean``) take a process
group, or None for a group of one (the identity).  Gloo moves no CUDA
tensor through an all-gather or an all-to-all, so on a gloo group a CUDA
tensor is staged through pinned host memory, as ``RoundMesh.gather``
does; NCCL moves it on the device.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import HostCopy, resolve_device

ROUND_AXIS = "data"   # the axis the round engine shards clients / D over
LM_AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


# ----------------------------------------------------------------------------
# the LM mesh
# ----------------------------------------------------------------------------


class LocalMesh:
    """A mesh of one device in this process, with no process group: the
    (1, 1) mesh of a bare process.  Tensors on it stay plain tensors and
    every collective on it is the identity (``axes_group`` gives None)."""

    is_local = True

    def __init__(self, mesh_dim_names=LM_AXES):
        self.mesh_dim_names = tuple(mesh_dim_names)

    @property
    def shape(self) -> tuple:
        return (1,) * len(self.mesh_dim_names)

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}=1" for a in self.mesh_dim_names)
        return f"LocalMesh(({dims}))"


def _device_type(device) -> str:
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def _lm_mesh(shape: tuple, names: tuple, device):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(device), shape, mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None):
    """The ``("data", "model")`` mesh over the ranks of the initialized
    process group, which must hold exactly ``data * model`` of them: a
    ``DeviceMesh``, whose ranks are laid out data-major as JAX's
    ``make_mesh`` lays out devices.  Without a process group of one rank,
    a mesh of one device is a ``LocalMesh``.

    ``device`` names the tensors' device type (default: CUDA when present,
    else the CPU)."""
    n = int(data) * int(model)
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if initialized and world == n:
        return _lm_mesh((data, model), LM_AXES, device)
    if n == 1:
        return LocalMesh(LM_AXES)
    if not initialized:
        raise RuntimeError(
            f"a ({data}, {model}) mesh needs an initialized process group "
            f"of {n} ranks: call torch.distributed.init_process_group first "
            f"(spawn_world does)")
    raise ValueError(f"need {n} devices, have {world}" if n > world else
                     f"a mesh spans the whole process group ({world} ranks, "
                     f"{n} asked)")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 = 256 ranks per pod; 2 pods = 512 ranks when multi_pod.
    ``ValueError`` on a process group of another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = POD_AXES if multi_pod else LM_AXES
    n = int(np.prod(shape))
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if world != n:
        raise ValueError(f"the production mesh {shape} needs {n} devices, "
                         f"have {world}")
    return _lm_mesh(shape, axes, device)


def mesh_axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` on ``mesh`` (1 for an axis it lacks)."""
    names = mesh_axis_names(mesh)
    if axis not in names:
        return 1
    shape = mesh.shape
    if isinstance(shape, dict):
        return int(shape[axis])
    return int(shape[names.index(axis)])


def axes_group(mesh, axes):
    """The process group spanning ``axes`` of ``mesh`` (a name or a tuple
    of names), or None when they hold one rank."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if getattr(mesh, "is_local", False) or all(
            mesh_axis_size(mesh, a) == 1 for a in axes):
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


# ----------------------------------------------------------------------------
# collectives on local tensors (the expert-parallel MoE's)
# ----------------------------------------------------------------------------


def _staged(group, t: torch.Tensor) -> bool:
    """Gloo and a CUDA tensor: the collective runs on a pinned host copy."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    return HostCopy(t.contiguous()).wait()


def _from_host(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return h.to(like.device, non_blocking=True)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x: (n, ...) on each of the group's n ranks; block i goes to rank i
    and block j of the result came from rank j (``lax.all_to_all`` with
    ``split_axis = concat_axis = 0``, untiled)."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    src = _to_host(x) if _staged(group, x) else x.contiguous()
    out = torch.empty_like(src, pin_memory=src.is_pinned())
    dist.all_to_all_single(out, src, group=group)
    return _from_host(out, x) if _staged(group, x) else out


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks concatenated along ``dim`` in rank order."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    n = dist.get_world_size(group)
    src = _to_host(x) if _staged(group, x) else x.contiguous()
    parts = [torch.empty_like(src, pin_memory=src.is_pinned())
             for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return _from_host(out, x) if _staged(group, x) else out


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's block along ``dim``
    (``lax.psum_scatter``, tiled)."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    n = dist.get_world_size(group)
    src = _to_host(x) if _staged(group, x) else x
    parts = [p.contiguous() for p in src.chunk(n, dim)]
    out = torch.empty_like(parts[0], pin_memory=src.is_pinned())
    dist.reduce_scatter(out, parts, group=group)
    return _from_host(out, x) if _staged(group, x) else out


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the group (``lax.pmean``)."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    out = _to_host(x).clone() if _staged(group, x) else x.clone()
    dist.all_reduce(out, group=group)
    out = out / dist.get_world_size(group)
    return _from_host(out, x) if _staged(group, x) else out


_STAGED_GATHER = {}


def _staged_all_gather(input: torch.Tensor, group_size: int, group_name):
    """The functional all-gather (``_c10d_functional.all_gather_into_tensor``)
    through host memory: the blocks gathered along dim 0 on the group's
    CPU side, then copied back to ``input``'s device."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = _resolve_process_group(group_name)
    host = input.detach().to("cpu").contiguous()
    out = host.new_empty((group_size * host.shape[0],) + tuple(host.shape[1:]))
    dist.all_gather_into_tensor(out, host, group=group)
    return out.to(input.device)


def stage_functional_all_gather(device_type: str = "cuda") -> None:
    """Route the functional all-gather of ``device_type`` tensors (what a
    DTensor's redistribution to ``Replicate`` and ``full_tensor`` issue)
    through host memory, in this process, from now on.

    For ranks that share one card on a gloo group (NCCL refuses two ranks
    on one GPU): on torch 2.11 gloo's functional all-gather of CUDA
    tensors ends the process with SIGSEGV, where its all-reduce and
    reduce-scatter, and c10d's in-place all-gather, run (PERF.md §6).
    The group must be gloo's; the op runs on its CPU side."""
    if device_type in _STAGED_GATHER:
        return
    if dist.get_backend() != "gloo":
        raise ValueError("the staged all-gather is for a gloo process group")
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _staged_all_gather,
             device_type.upper())
    _STAGED_GATHER[device_type] = lib


# ----------------------------------------------------------------------------
# the round mesh
# ----------------------------------------------------------------------------


class RoundMesh:
    """A 1-D ``("data",)`` mesh: one rank of an initialized process group.

    ``backend`` is the group's ("nccl" or "gloo"); ``device`` is where this
    rank's tensors live."""

    axis_names = (ROUND_AXIS,)

    def __init__(self, group, size: int, rank: int, device: torch.device,
                 backend: str):
        self.group = group
        self.size = size
        self.rank = rank
        self.device = device
        self.backend = backend

    @property
    def shape(self) -> dict:
        return {ROUND_AXIS: self.size}

    def __repr__(self) -> str:
        return (f"RoundMesh(size={self.size}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend!r})")

    def shard(self, x, dim: Optional[int]):
        """This rank's block of ``x`` (a tensor or numpy array every rank
        holds) along ``dim``; ``dim=None`` (replicated) returns ``x``."""
        if dim is None:
            return x
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"dim {dim} of size {n} does not split over "
                             f"{self.size} ranks (pad first)")
        block = n // self.size
        index = [slice(None)] * len(x.shape)
        index[dim] = slice(self.rank * block, (self.rank + 1) * block)
        return x[tuple(index)]

    def gather(self, local: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """All ranks' blocks of a tensor, concatenated along ``dim`` in rank
        order (``dim=None``: replicated, returned as is).

        NCCL gathers on the device (``all_gather_into_tensor``).  Gloo has
        no all-gather of CUDA tensors, so a CUDA block goes to pinned host
        memory (the copy's event is waited on), is gathered there, and the
        blocks come back with non-blocking copies; a CPU block is gathered
        in place."""
        if dim is None:
            return local
        local = local.contiguous()
        if self.backend == "nccl":
            out = torch.empty((self.size,) + tuple(local.shape),
                              dtype=local.dtype, device=local.device)
            dist.all_gather_into_tensor(out, local, group=self.group)
            blocks = out.unbind(0)
        elif local.device.type == "cuda":
            host = HostCopy(local).wait()
            parts = [torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                     for _ in range(self.size)]
            dist.all_gather(parts, host, group=self.group)
            blocks = [p.to(local.device, non_blocking=True) for p in parts]
        else:
            blocks = [torch.empty_like(local) for _ in range(self.size)]
            dist.all_gather(blocks, local, group=self.group)
        return torch.cat(blocks, dim)


def make_round_mesh(num_devices: Optional[int] = None, *,
                    device="cuda") -> RoundMesh:
    """The 1-D ``("data",)`` mesh the sharded round stages shard over, on
    the process group this rank has joined (``init_process_group``, or
    ``repro_torch.hostdevices.spawn_world`` for CPU ranks).

    ``device="cuda"`` puts the rank on ``cuda:<local rank>`` (``LOCAL_RANK``,
    else the rank); pass ``"cuda:<i>"`` to choose, or ``"cpu"``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_round_mesh needs an initialized process group: call "
            "torch.distributed.init_process_group first (spawn_world does)"
        )
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    if n < world:
        raise ValueError(
            f"a round mesh spans the whole process group ({world} ranks, "
            f"{n} asked): every rank runs the round's host pipeline"
        )
    rank = dist.get_rank()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return RoundMesh(dist.group.WORLD, n, rank, resolve_device(dev),
                     dist.get_backend())


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (includes 'pod' when present)."""
    return tuple(a for a in mesh_axis_names(mesh) if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
