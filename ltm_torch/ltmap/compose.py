"""LT-map composition: updated "live" map from union + deltas
(port of ``ltm.ltmap.compose``).

Reference ``Removerter::updateCurrentMap`` (``ltremovert/src/Removerter.cpp:
1483-1524``): updated map = union(query coexist, central coexist)
+ weak-ND (reverted to static) + PD (original or strong), deduplicated per
voxel.  Mask formulation over the concatenated [central | query] map.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ltm_torch.kernels.voxel import voxel_unique_mask

__all__ = ["compose_updated_maps"]


def compose_updated_maps(central_xyz, query_xyz, coexist_c, nd_weak, coexist_q,
                         pd, pd_strong, voxel: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (combined_xyz, updated_mask, updated_strong_mask)."""
    comb_xyz = torch.cat([central_xyz, query_xyz], 0)
    upd_c = coexist_c | nd_weak
    updated = voxel_unique_mask(comb_xyz, torch.cat([upd_c, coexist_q | pd]), voxel)
    updated_strong = voxel_unique_mask(comb_xyz, torch.cat([upd_c, coexist_q | pd_strong]), voxel)
    return comb_xyz, updated, updated_strong
