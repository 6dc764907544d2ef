"""The round engine's data mesh over ``torch.distributed``.

Port of ``make_round_mesh`` / ``dp_axes`` of ``repro/launch/mesh.py``.
JAX drives every device of a mesh from one process; here each rank is a
process, and the mesh is the rank's view of a one-dimensional
``("data",)`` process group: its size, its rank, its device, and the two
moves a sharded program makes, ``shard`` (take this rank's block of a
tensor every rank holds) and ``gather`` (all-gather the ranks' blocks).
The LM's meshes (``make_host_mesh``, ``make_production_mesh``) wait with
the expert-parallel MoE (ROADMAP.md Queue 1 item 11).

Every rank runs the round's whole host pipeline from the same seed, so a
round mesh spans the whole process group: ``make_round_mesh(n)`` needs
exactly ``n`` ranks.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import HostCopy, resolve_device

ROUND_AXIS = "data"   # the axis the round engine shards clients / D over


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
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
