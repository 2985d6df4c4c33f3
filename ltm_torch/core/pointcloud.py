"""Fixed-shape, mask-based point clouds (port of ``ltm.core.pointcloud``).

A cloud is ``xyz`` (N, 3) float32 + ``mask`` (N,) bool (+ an optional
per-point intensity): "removing" points flips mask bits and data never
moves; a subset is a mask AND (the reference's ``pcl::ExtractIndices``,
``ltremovert/src/Removerter.cpp:933-946``); only at I/O boundaries is a
cloud compacted to its valid points.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch

__all__ = ["PointCloud", "concat", "pad_to", "compact", "from_numpy"]


@dataclass(frozen=True)
class PointCloud:
    """Padded point cloud: ``xyz`` (N, 3), ``mask`` (N,), optional intensity (N,)."""

    xyz: torch.Tensor
    mask: torch.Tensor
    intensity: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        """Number of valid points (a tensor on the cloud's device)."""
        return self.mask.sum(-1)

    def with_mask(self, mask: torch.Tensor) -> "PointCloud":
        return replace(self, mask=mask)

    def and_mask(self, mask: torch.Tensor) -> "PointCloud":
        return replace(self, mask=self.mask & mask)

    def transform(self, T: torch.Tensor) -> "PointCloud":
        """Rigid transform of the points (``se3.transform_points``)."""
        from ltm_torch.core import se3

        return replace(self, xyz=se3.transform_points(T, self.xyz))

    def masked_xyz(self, fill: float = 0.0) -> torch.Tensor:
        """xyz with invalid rows replaced by ``fill`` (before reductions)."""
        return torch.where(self.mask[..., None], self.xyz, fill)

    def to(self, device) -> "PointCloud":
        return PointCloud(self.xyz.to(device), self.mask.to(device),
                          None if self.intensity is None else self.intensity.to(device))

    def to_numpy(self) -> np.ndarray:
        """The valid points as a host (M, 3) float32 array."""
        return self.xyz[self.mask].cpu().numpy()

    def to_numpy_with_intensity(self) -> np.ndarray:
        """The valid points and their intensity (0 without one), (M, 4)."""
        inten = (self.intensity if self.intensity is not None
                 else self.xyz.new_zeros(self.xyz.shape[:-1]))
        return torch.cat([self.xyz[self.mask], inten[self.mask][:, None]], -1).cpu().numpy()


def from_numpy(xyz: np.ndarray, capacity: Optional[int] = None, intensity=None,
               device="cpu") -> PointCloud:
    """A padded :class:`PointCloud` on ``device`` from a host (M, 3) array."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    m = xyz.shape[0]
    n = capacity if capacity is not None else m
    if m > n:
        raise ValueError(f"cloud with {m} points exceeds capacity {n}")
    mask = np.zeros((n,), bool)
    mask[:m] = True
    inten = None
    if intensity is not None:
        inten = torch.from_numpy(np.pad(np.asarray(intensity, np.float32).reshape(-1),
                                        (0, n - m))).to(device)
    return PointCloud(torch.from_numpy(np.pad(xyz, ((0, n - m), (0, 0)))).to(device),
                      torch.from_numpy(mask).to(device), inten)


def concat(clouds: List[PointCloud]) -> PointCloud:
    """Concatenate padded clouds (capacities add; masks carried through; an
    intensity only if every cloud has one)."""
    inten = None
    if all(c.intensity is not None for c in clouds):
        inten = torch.cat([c.intensity for c in clouds], -1)
    return PointCloud(torch.cat([c.xyz for c in clouds], -2),
                      torch.cat([c.mask for c in clouds], -1), inten)


def pad_to(cloud: PointCloud, capacity: int) -> PointCloud:
    """Grow the capacity to ``capacity`` (no-op if already there)."""
    n = cloud.capacity
    if n == capacity:
        return cloud
    if n > capacity:
        raise ValueError(f"cannot shrink padded cloud {n} -> {capacity}")
    pad = capacity - n
    inten = None
    if cloud.intensity is not None:
        inten = torch.cat([cloud.intensity, cloud.intensity.new_zeros((pad,))], -1)
    return PointCloud(torch.cat([cloud.xyz, cloud.xyz.new_zeros((pad, 3))], -2),
                      torch.cat([cloud.mask, cloud.mask.new_zeros((pad,))], -1), inten)


def compact(cloud: PointCloud, capacity: int) -> PointCloud:
    """Move the valid points to the front (stable) and truncate to
    ``capacity``."""
    order = torch.argsort((~cloud.mask).to(torch.uint8), stable=True)[:capacity]
    inten = None if cloud.intensity is None else cloud.intensity[order]
    return PointCloud(cloud.xyz[order], cloud.mask[order], inten)
