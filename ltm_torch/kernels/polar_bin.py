"""Polar-context (Scan Context) descriptor binning (port of
``ltm.kernels.polar_bin``).

The descriptor is a (num_ring, num_sector) grid of per-bin maximum z
(+ lidar height), matching ``SCManager::makeScancontext``
(``ltslam/src/Scancontext.cpp:151-195``): its ceil-and-clamp bin rule and
"empty bin -> 0".  ``ltm``'s ``desc.at[idx].max(zval, mode="drop")``
becomes ``scatter_reduce_(..., "amax")``; torch has no drop mode, so bins
out of range are masked to -inf explicitly.  The float ops follow what
XLA compiles ``ltm``'s expressions to under ``jit`` on the CPU (the FMA of
``x*x + y*y``, the product with the float32 reciprocal of 360 folded with
``num_sector``), so the bins agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ltm_torch.kernels.projection import _RAD2DEG, _div, _fma, _recip, _sqrt

__all__ = ["make_descriptor", "make_descriptors"]

_NO_POINT = -1000.0


def _remainder(x: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.remainder``: C fmod, plus ``m`` where the sign differs."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def make_descriptors(xyz: torch.Tensor, mask: torch.Tensor, num_ring: int = 20,
                     num_sector: int = 60, max_radius: float = 80.0,
                     lidar_height: float = 2.0) -> torch.Tensor:
    """(K, N, 3) scans in their lidar frames (and (K, N) masks) -> (K, R, S)."""
    K = xyz.shape[0]
    x, y = xyz[..., 0], xyz[..., 1]
    z = xyz[..., 2] + lidar_height
    r = _sqrt(_fma(x, x, y * y))
    theta = _remainder(torch.atan2(y, x) * np.float32(_RAD2DEG), 360.0)

    valid = mask & (r <= max_radius)
    ring = torch.clamp(torch.ceil(_div(r, max_radius) * num_ring), 1, num_ring).long() - 1
    sec_scale = float(np.float32(_recip(360.0)) * np.float32(num_sector))
    sector = torch.clamp(torch.ceil(theta * sec_scale), 1, num_sector).long() - 1
    n_bins = num_ring * num_sector
    idx = ring * num_sector + sector
    valid &= (idx >= 0) & (idx < n_bins)
    zval = torch.where(valid, z, -torch.inf)
    flat = torch.where(valid, idx, 0) + n_bins * torch.arange(K, device=xyz.device)[:, None]
    desc = torch.full((K * n_bins,), _NO_POINT, dtype=xyz.dtype, device=xyz.device)
    desc.scatter_reduce_(0, flat.reshape(-1), zval.reshape(-1), "amax")
    desc = torch.where(desc == _NO_POINT, 0.0, desc)
    return desc.reshape(K, num_ring, num_sector)


def make_descriptor(xyz: torch.Tensor, mask: torch.Tensor, **kw) -> torch.Tensor:
    """One (N, 3) scan -> (R, S)."""
    return make_descriptors(xyz[None], mask[None], **kw)[0]
