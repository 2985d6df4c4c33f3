"""Meshes of device slots for the keyframe- and chunk-sharded sweeps and
kNN (port of ``ltm.dist.mesh``).

``ltm`` shards with ``shard_map`` over a 1-D ``jax.sharding.Mesh`` along
the ``"kf"`` axis: one controller drives every device it sees.  The port
keeps that shape.  A :class:`Mesh` is a tuple of device *slots* along
``KF_AXIS``, one process drives all of its slots, and one device may fill
several slots: ``make_mesh([cuda:0] * 4)`` is a 4-slot mesh on one card,
the counterpart of ``tests/conftest.py``'s 8 virtual CPU devices.

A sharded function (``ltm_torch.dist.sharding``, ``ltm_torch.dist.removert``)
pads its sharded axis to a multiple of ``mesh.size``, runs the one-device
function on each of this process's slots over that slot's shard, on that
slot's device (launches are asynchronous, so slots on different cards
overlap), and combines the shards' results with one of three collectives:
:func:`reduce_or`, :func:`reduce_min` or :func:`concat`.  Each reduces over
the local slots on one device and then, when ``initialize_multihost``
started a process group, across processes (``all_reduce`` with MAX or MIN,
``all_gather``; equal shards keep the gather legal).  OR, min and
concatenation are exact, so a sharded result equals the one-device result
bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["KF_AXIS", "Mesh", "make_mesh", "mesh_from_config", "pad_to_multiple",
           "local_shards", "reduce_or", "reduce_min", "concat"]

KF_AXIS = "kf"


@dataclass(frozen=True)
class Mesh:
    """Device slots along ``KF_AXIS`` (repeats allowed) and, across
    processes, the process group.  Every process holds the same number of
    slots; process r's slots are the global slots ``r·len(slots) ...``."""

    slots: Tuple[torch.device, ...]
    group: Optional[Any] = None

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """Global slot count: local slots × processes."""
        return len(self.slots) * self.world

    @property
    def lead(self) -> torch.device:
        return self.slots[0]


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices``, repeats allowed (default: every CUDA card
    of this process).  When ``initialize_multihost`` has started a process
    group, the mesh spans it."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    slots = tuple(torch.device(d) for d in devices)
    if not slots:
        raise ValueError("a mesh needs at least one device slot")
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    return Mesh(slots, group)


def mesh_from_config(mesh_devices: Optional[int], device) -> Optional[Mesh]:
    """The drivers' ``cfg.mesh_devices`` contract (``ltm/dist/mesh.py:28-37``):
    None, 0 or 1 mean no mesh, -1 every device.  On CUDA the first
    ``min(n, device_count())`` cards, so one card gives None and runs the
    one-device path, as ``ltm`` does on one chip.  On the CPU ``n`` slots of
    the CPU device (-1 gives None)."""
    if not mesh_devices or mesh_devices == 1:
        return None
    device = torch.device(device)
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        count = n_cards if mesh_devices == -1 else min(mesh_devices, n_cards)
        return make_mesh([torch.device("cuda", i) for i in range(count)]) if count > 1 else None
    return make_mesh([device] * mesh_devices) if mesh_devices > 1 else None


def pad_to_multiple(t: torch.Tensor, multiple: int, axis: int = 0, fill=0) -> torch.Tensor:
    """Pad ``axis`` to a multiple of ``multiple`` with ``fill`` (masks carry
    validity)."""
    pad = (-t.shape[axis]) % multiple
    if pad == 0:
        return t
    shape = list(t.shape)
    shape[axis] = pad
    return torch.cat([t, t.new_full(shape, fill)], axis)


def local_shards(mesh: Mesh, n: int) -> List[Tuple[torch.device, int, int]]:
    """(slot device, start, stop) of this process's shards of an axis of
    ``n`` entries, a multiple of ``mesh.size``."""
    if n % mesh.size:
        raise ValueError(f"an axis of {n} does not split over {mesh.size} slots")
    per = n // mesh.size
    base = mesh.rank * len(mesh.slots)
    return [(d, (base + j) * per, (base + j + 1) * per) for j, d in enumerate(mesh.slots)]


def reduce_or(mesh: Mesh, parts: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """Logical OR of the slots' boolean results (``ltm``'s ``psum(int32) >
    0``), on ``device`` (default the lead slot's)."""
    device = mesh.lead if device is None else device
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out | p.to(device)
    if mesh.group is None:
        return out
    wire = out.to(torch.uint8)          # a copy: all_reduce works in place
    dist.all_reduce(wire, op=dist.ReduceOp.MAX, group=mesh.group)
    return wire.bool()


def reduce_min(mesh: Mesh, parts: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """Elementwise minimum of the slots' results (``ltm``'s ``pmin``)."""
    device = mesh.lead if device is None else device
    out = parts[0].to(device)
    for p in parts[1:]:
        out = torch.minimum(out, p.to(device))
    if mesh.group is None:
        return out
    out = out.clone() if out is parts[0] else out   # all_reduce works in place
    dist.all_reduce(out, op=dist.ReduceOp.MIN, group=mesh.group)
    return out


def concat(mesh: Mesh, parts: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The slots' shards concatenated along axis 0 in global slot order."""
    device = mesh.lead if device is None else device
    out = torch.cat([p.to(device) for p in parts])
    if mesh.group is None:
        return out
    is_bool = out.dtype == torch.bool
    wire = out.view(torch.uint8) if is_bool else out
    got = [torch.empty_like(wire) for _ in range(mesh.world)]
    dist.all_gather(got, wire, group=mesh.group)
    out = torch.cat(got)
    return out.view(torch.bool) if is_bool else out
