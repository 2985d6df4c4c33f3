"""The sweep kernels' cluster plan on the CPU (``sweep._cluster_plan``):
how many CTAs a keyframe's cluster takes and how each image is cut into
row bands, one band a CTA, for the default resolutions (the filter image
125 x 900, the packed image 150 x 1 080), and the refusal (the global
variant) of images no cluster can hold.  The kernels take the plan's
numbers as they are (``sweep.cu``'s ``valid_bands`` and its shared-memory
bound); the card runs both variants in ``chip_smoke.py``'s phase 2.
"""

import pytest
import torch

from ltm_torch.kernels import projection as tp
from ltm_torch.kernels import sweep

torch.set_num_threads(1)

FOV = (50.0, 360.0)
FILTER = tp.rimg_shape(FOV, 2.5)      # 125 x 900
PACKED = tp.rimg_shape(FOV, 3.0)      # 150 x 1080


def _covers(plan, images):
    """Every band holds its rows, and the bands cover each image."""
    cs, rows, smem = plan
    assert smem == 4 * sum(r * ncol for r, (_, ncol) in zip(rows, images))
    assert smem <= sweep._SMEM_BYTES
    for r, (nrow, _) in zip(rows, images):
        assert r * cs >= nrow and (r - 1) * cs < nrow


def test_default_shapes():
    assert FILTER == (125, 900) and PACKED == (150, 1080)


@pytest.mark.parametrize("images,want", [
    ([FILTER], (4, (32,), 115_200)),                         # K2 against given images
    ([FILTER, FILTER], (8, (16, 16), 115_200)),              # K2 forward: scan and map images
    ([PACKED], (8, (19,), 82_080)),                          # K3: the packed image
    ([tp.rimg_shape(FOV, 5.0)], (8, (32,), 230_400)),        # finer: a CTA's limit
])
def test_cluster_sizes_and_bands(images, want):
    plan = sweep._cluster_plan(images)
    assert plan == want
    _covers(plan, images)


@pytest.mark.parametrize("images", [
    [tp.rimg_shape(FOV, 5.0)] * 2,                           # forward at 250 x 1800
    [tp.rimg_shape(FOV, 6.0)],                               # K3's packed image at 300 x 2160
    [(1, 58_200)],                                           # one row wider than a CTA holds
])
def test_too_large_for_a_cluster(images):
    assert sweep._cluster_plan(images) is None


def test_fewest_ctas_that_fit():
    """The fewest CTAs whose bands take at most half an SM's shared memory,
    else the fewest that fit a CTA's limit; small images still take four
    (the card's fill, not the bytes, sets the floor)."""
    assert sweep._cluster_plan([(8, 16)]) == (4, (2,), 128)
    assert sweep._cluster_plan([(3, 16)])[0] == 4                  # fewer rows than CTAs
    _covers(sweep._cluster_plan([(3, 16)]), [(3, 16)])
    half = sweep._SMEM_HALF // 4 // 100                         # rows of 100 columns
    one = sweep._SMEM_BYTES // 4 // 100
    assert sweep._cluster_plan([(4 * half, 100)])[:2] == (4, (half,))
    assert sweep._cluster_plan([(4 * half + 1, 100)])[0] == 8       # 8 CTAs, half an SM
    assert sweep._cluster_plan([(8 * half, 100)])[2] <= sweep._SMEM_HALF
    assert sweep._cluster_plan([(8 * half + 1, 100)])[:2] == (4, (2 * half + 1,))  # a CTA's limit
    assert sweep._cluster_plan([(8 * one, 100)])[:2] == (8, (one,))
    assert sweep._cluster_plan([(8 * one + 1, 100)]) is None
