"""The ParkingLot scene: ``bundles`` bundles of two sessions over one
persistent world each (:func:`harness.synthetic.make_two_sessions`, keyword
arguments ``sessions``): the same static structure and cars in both
sessions but the ``num_changed`` cars that one of them lacks, and a mover in
every scan.  ``sessions.world`` sets the world's point spacing."""

from __future__ import annotations

from typing import Dict, List

from harness import synthetic
from harness.traffic import STREAM_SESSIONS, rng


def sessions(mix: dict, survey: dict, seed: int) -> List[Dict]:
    base = int(rng(seed, STREAM_SESSIONS).integers(0, 2 ** 31))
    return [synthetic.make_two_sessions(seed=base + 1000 * b, **mix["sessions"],
                                        num_keyframes=survey["keyframes_per_session"],
                                        max_scan_points=survey["scan_points"])
            for b in range(mix["bundles"])]
