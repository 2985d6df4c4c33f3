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

__all__ = ["voxel_coords", "voxel_downsample_centroid", "voxel_unique_mask",
           "voxel_downsample_representative", "voxel_downsample_representative_capped"]

_INT_SENTINEL = 2**31 - 1


def voxel_coords(xyz: torch.Tensor, voxel: float) -> torch.Tensor:
    """(N, 3) float -> (N, 3) int32 voxel coordinates."""
    return torch.floor(_div(xyz, voxel)).int()


def _sorted_groups(coords: torch.Tensor, mask: torch.Tensor):
    """Sort points by voxel (invalid last); return order + group segment ids.

    ``ltm`` lexsorts two int32 keys, hi = [invalid:1|x:21|y_hi:9] and
    lo = [y_lo:10|z:21], over coordinates rebased to the valid minimum and
    clamped at 21/19/21 bits per axis; one stable sort on the int64 key
    ``(hi << 31) | lo`` gives the same order.  Leading batch dimensions
    (``(..., N, 3)`` coordinates) sort each cloud on its own, as ``ltm``'s
    ``vmap`` does."""
    m = mask[..., None]
    c = torch.where(m, coords, _INT_SENTINEL)
    cmin = c.amin(-2, keepdim=True).long()
    cr = torch.clamp(coords.long() - cmin, min=0)
    x = torch.clamp(cr[..., 0], max=(1 << 21) - 1)
    y = torch.clamp(cr[..., 1], max=(1 << 19) - 1)
    z = torch.clamp(cr[..., 2], max=(1 << 21) - 1)
    key_hi = torch.where(mask, 0, 1 << 30) | (x << 9) | (y >> 10)
    key_lo = ((y & ((1 << 10) - 1)) << 21) | z
    order = torch.sort((key_hi << 31) | key_lo, dim=-1, stable=True).indices
    cs = torch.gather(c, -2, order[..., None].expand(c.shape))
    ms = torch.gather(mask, -1, order)
    is_new = torch.any(cs != torch.roll(cs, 1, -2), dim=-1)
    is_new[..., 0] = True
    is_new &= ms
    seg = torch.cumsum(is_new, -1) - 1  # invalid tail inherits last id; masked out later
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


def voxel_downsample_representative(xyz: torch.Tensor, mask: torch.Tensor, voxel: float,
                                    out_capacity: int):
    """First-point-per-voxel downsample into a fixed-capacity output:
    ``(out_xyz (C,3), out_mask (C,), num_voxels)``, the kept points
    compacted to the front in their input order."""
    keep = voxel_unique_mask(xyz, mask, voxel)
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices
    out_xyz = xyz[order][:out_capacity]
    out_mask = keep[order][:out_capacity]
    return out_xyz, out_mask, keep.sum()


def voxel_downsample_representative_capped(xyz: torch.Tensor, mask: torch.Tensor,
                                           voxel: float, out_capacity: int):
    """Representative downsample with a spatially UNIFORM overflow cap
    (``ltm.kernels.voxel.voxel_downsample_representative_capped``).

    Keeps real input points, one a voxel; when more than ``out_capacity``
    voxels are occupied, adjacent voxels in sorted-key order merge
    uniformly (``seg -> floor(seg * (cap / nvox))`` in float32) and each
    merged group keeps its first sorted point.  Under capacity the kept set
    is the first point of each voxel, in voxel-sorted order.  ``xyz``
    may carry leading batch dimensions (``(..., N, 3)``, one cloud a row,
    as ``ltm`` maps it with ``vmap``).  Returns ``(out_xyz (..., C, 3),
    out_mask (..., C), num_voxels (...))``; ``num_voxels`` stays on the
    device (no host read)."""
    n = xyz.shape[-2]
    order, seg, ms, is_new = _sorted_groups(voxel_coords(xyz, voxel), mask)
    xs = torch.gather(xyz, -2, order[..., None].expand(xyz.shape))
    num_voxels = is_new.sum(-1)
    nv = torch.clamp(num_voxels, min=1)
    ratio = torch.full((), out_capacity, dtype=torch.float32, device=xyz.device) / nv.float()
    slot = torch.floor(seg.float() * ratio[..., None]).long()
    slot = torch.clamp(slot, max=out_capacity - 1)
    seg_u = torch.where((num_voxels > out_capacity)[..., None], slot, seg)
    seg_u = torch.clamp(torch.where(ms, seg_u, out_capacity), max=out_capacity)
    idx = torch.arange(n, device=xyz.device).expand(seg_u.shape)
    first = torch.full(seg_u.shape[:-1] + (out_capacity + 1,), n, dtype=torch.long,
                       device=xyz.device)
    first.scatter_reduce_(-1, seg_u, torch.where(ms, idx, n), "amin")
    first = first[..., :out_capacity]
    out_mask = first < n
    sel = torch.clamp(first, max=n - 1)
    out_xyz = torch.gather(xs, -2, sel[..., None].expand(sel.shape + (3,)))
    return out_xyz, out_mask, num_voxels
