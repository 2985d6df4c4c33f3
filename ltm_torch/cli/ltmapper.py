"""Full LT-mapper chain of the port: LT-SLAM → LT-removert → LT-map in one
command (the same flags as ``ltm.cli.ltmapper`` plus ``--device``):

    python -m ltm_torch.cli.ltmapper --sessions-dir DATA --central 01 --query 02 \\
        --out OUT [--device cpu]

Writes OUT/ltslam/ (trajectories) and OUT/removert/ (maps, deltas, scans);
LT-removert reads LT-SLAM's central poses of both sessions.  ``--resume``
skips a stage whose inputs and configuration are unchanged
(``utils/stagecache.py``).  ``--device`` and ``--mesh-devices`` as in
``ltm_torch.cli.ltslam``.
"""

from __future__ import annotations

import argparse
import os

from ltm_torch.core.config import LTSlamConfig, RemovertConfig, load_yaml
from ltm_torch.io.sessions import load_session_dir
from ltm_torch.removert import Removerter, RemovertInput
from ltm_torch.slam import LTSlam
from ltm_torch.utils import get_logger
from ltm_torch.utils.stagecache import StageCache, stage_key

log = get_logger("ltm_torch.cli.ltmapper")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="LT-mapper (full chain) on PyTorch / CUDA")
    ap.add_argument("--sessions-dir", required=True)
    ap.add_argument("--central", default="01")
    ap.add_argument("--query", default="02")
    ap.add_argument("--out", required=True)
    ap.add_argument("--ltslam-config", help="optional YAML for LTSlamConfig")
    ap.add_argument("--removert-config", help="optional YAML for RemovertConfig")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="shard hot loops over this many local devices "
                         "(-1 = all, 1 = single; default: all local devices)")
    ap.add_argument("--resume", action="store_true",
                    help="skip stages whose inputs+config are unchanged since a "
                         "previous successful run (content-addressed stage cache)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (default) or cpu")
    args = ap.parse_args(argv)

    slam_cfg = load_yaml(args.ltslam_config, "ltslam") if args.ltslam_config else LTSlamConfig()
    rm_cfg = load_yaml(args.removert_config, "removert") if args.removert_config else RemovertConfig()
    for cfg in (slam_cfg, rm_cfg):
        if args.mesh_devices is not None:
            cfg.mesh_devices = args.mesh_devices
        elif cfg.mesh_devices is None:
            cfg.mesh_devices = -1
    slam = LTSlam(slam_cfg, device=args.device)
    removerter = Removerter(rm_cfg, device=args.device)

    slam_out = os.path.join(args.out, "ltslam")
    rm_out = os.path.join(args.out, "removert")
    central_dir = os.path.join(args.sessions_dir, args.central)
    query_dir = os.path.join(args.sessions_dir, args.query)
    cache = StageCache(os.path.join(args.out, ".stage_cache")) if args.resume else None

    slam_key = stage_key("ltslam", slam_cfg, [central_dir, query_dir],
                         extra=f"{args.central}|{args.query}")
    if cache is not None and cache.check("ltslam", slam_key):
        log.info("=== stage 1/2: LT-SLAM === (cached, skipping)")
        central_name, query_name = args.central, args.query
    else:
        central = load_session_dir(central_dir, max_nodes=slam_cfg.max_nodes_per_session)
        query = load_session_dir(query_dir, max_nodes=slam_cfg.max_nodes_per_session)
        central_name, query_name = central.name, query.name
        log.info("=== stage 1/2: LT-SLAM ===")
        slam.run(central, query, save_directory=slam_out)
        if cache is not None:
            cache.commit("ltslam", slam_key, [slam_out])

    c_pose = os.path.join(slam_out, f"{central_name}_central_aft_intersession_loops.txt")
    q_pose = os.path.join(slam_out, f"{query_name}_central_aft_intersession_loops.txt")
    c_scans = os.path.join(central_dir, "Scans")
    q_scans = os.path.join(query_dir, "Scans")
    rm_key = stage_key("ltremovert", rm_cfg, [c_scans, q_scans, c_pose, q_pose])
    if cache is not None and cache.check("ltremovert", rm_key):
        log.info("=== stage 2/2: LT-removert + LT-map === (cached, skipping)")
    else:
        log.info("=== stage 2/2: LT-removert + LT-map ===")
        removerter.run(RemovertInput.from_dirs(c_scans, c_pose),
                       RemovertInput.from_dirs(q_scans, q_pose), save_directory=rm_out)
        if cache is not None:
            cache.commit("ltremovert", rm_key, [rm_out])
    log.info("done: %s", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
