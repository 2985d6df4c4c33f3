"""Voxel-grid operations on padded clouds (port of ``ltm.kernels.voxel``).

Sort + segment-reduce formulation of PCL's voxel centroid / voxel grid
(reference ``octreeDownsampling``, ``ltremovert/src/utility.cpp:204-219``):

  1. integer voxel coordinates per point;
  2. one stable sort on a packed 61-bit key (invalid points last);
  3. group boundaries -> segment ids;
  4. segment mean (centroid) or first-representative select.
"""

from __future__ import annotations

import torch

from ltm_torch.kernels.projection import _div

__all__ = ["voxel_coords", "voxel_downsample_centroid", "voxel_unique_mask"]

_INT_SENTINEL = 2**31 - 1


def voxel_coords(xyz: torch.Tensor, voxel: float) -> torch.Tensor:
    """(N, 3) float -> (N, 3) int32 voxel coordinates."""
    return torch.floor(_div(xyz, voxel)).int()


def _sorted_groups(coords: torch.Tensor, mask: torch.Tensor):
    """Sort points by voxel (invalid last); return order + group segment ids.

    ``ltm`` lexsorts two int32 keys, hi = [invalid:1|x:21|y_hi:9] and
    lo = [y_lo:10|z:21], over coordinates rebased to the valid minimum and
    clamped at 21/19/21 bits per axis; one stable sort on the int64 key
    ``(hi << 31) | lo`` gives the same order."""
    m = mask[:, None]
    c = torch.where(m, coords, _INT_SENTINEL)
    cmin = c.amin(0).long()
    cr = torch.clamp(coords.long() - cmin, min=0)
    x = torch.clamp(cr[:, 0], max=(1 << 21) - 1)
    y = torch.clamp(cr[:, 1], max=(1 << 19) - 1)
    z = torch.clamp(cr[:, 2], max=(1 << 21) - 1)
    key_hi = torch.where(mask, 0, 1 << 30) | (x << 9) | (y >> 10)
    key_lo = ((y & ((1 << 10) - 1)) << 21) | z
    order = torch.sort((key_hi << 31) | key_lo, stable=True).indices
    cs = c[order]
    ms = mask[order]
    is_new = torch.any(cs != torch.roll(cs, 1, 0), dim=-1)
    is_new[0] = True
    is_new &= ms
    seg = torch.cumsum(is_new, 0) - 1  # invalid tail inherits last id; masked out later
    return order, seg, ms, is_new


def voxel_downsample_centroid(xyz: torch.Tensor, mask: torch.Tensor, voxel: float, out_capacity: int):
    """Centroid-per-voxel downsample.

    Returns ``(out_xyz (C,3), out_mask (C,), num_voxels)``; voxels beyond
    ``out_capacity`` are dropped (check ``num_voxels`` to detect overflow).
    The sums run over contiguous sorted runs with ``segment_reduce`` — a
    deterministic reduction, so a run repeats bit for bit (``index_add_``
    would use atomics on the card).
    """
    order, seg, ms, is_new = _sorted_groups(voxel_coords(xyz, voxel), mask)
    n_valid = int(ms.sum())                 # valid points sort first
    num_voxels = int(is_new.sum())
    n_out = min(num_voxels, out_capacity)
    out_xyz = torch.zeros((out_capacity, 3), dtype=xyz.dtype, device=xyz.device)
    if n_out:
        lengths = torch.bincount(seg[:n_valid], minlength=num_voxels)[:n_out]
        n_kept = int(lengths.sum())
        sums = torch.segment_reduce(xyz[order[:n_kept]], "sum", lengths=lengths, axis=0)
        out_xyz[:n_out] = sums / lengths[:, None].to(xyz.dtype)
    out_mask = torch.arange(out_capacity, device=xyz.device) < n_out
    return out_xyz, out_mask, num_voxels


def voxel_unique_mask(xyz: torch.Tensor, mask: torch.Tensor, voxel: float) -> torch.Tensor:
    """Keep-one-representative-per-voxel mask (preserves point identity).
    The kept point is the first in voxel-sorted order — deterministic."""
    order, _, _, is_new = _sorted_groups(voxel_coords(xyz, voxel), mask)
    keep = torch.empty_like(mask)
    keep[order] = is_new
    return keep & mask
