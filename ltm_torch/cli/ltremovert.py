"""LT-removert/LT-map entry point of the port (mirrors ``roslaunch removert
run_ltmapper.launch``; the same flags as ``ltm.cli.ltremovert``).

Usage:
    python -m ltm_torch.cli.ltremovert --config params_ltmapper.yaml
    python -m ltm_torch.cli.ltremovert --central-scans DIR --central-poses F \\
        --query-scans DIR --query-poses F --out OUT [--device cpu]

``--device`` (default ``cuda``) is the port's counterpart of JAX's platform
selection: ``cpu`` runs the plain PyTorch versions of the kernels.
``--mesh-devices`` keeps ``ltm``'s contract (default -1, every local
device): one CUDA card, or the CPU, runs on one device, and more than one
raises ``NotImplementedError`` until the multi-device paths are ported.
``ltm``'s persistent XLA compilation cache has no counterpart: the CUDA
kernels are built once per source hash into ``build/kernels``.
"""

from __future__ import annotations

import argparse
import os

from ltm_torch.core.config import RemovertConfig, load_yaml
from ltm_torch.removert import Removerter, RemovertInput
from ltm_torch.utils import get_logger

log = get_logger("ltm_torch.cli.ltremovert")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="LT-removert + LT-map on PyTorch / CUDA")
    ap.add_argument("--config", help="YAML config (RemovertConfig fields)")
    ap.add_argument("--central-scans")
    ap.add_argument("--central-poses")
    ap.add_argument("--query-scans")
    ap.add_argument("--query-poses")
    ap.add_argument("--out")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="shard hot loops over this many local devices "
                         "(-1 = all, 1 = single; default: all local devices)")
    ap.add_argument("--resume", action="store_true",
                    help="skip the run if inputs+config are unchanged since a "
                         "previous successful one (content-addressed stage cache)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = load_yaml(args.config, "removert") if args.config else RemovertConfig()
    if args.central_scans:
        cfg.central_sess_scan_dir = args.central_scans
    if args.central_poses:
        cfg.central_sess_pose_path = args.central_poses
    if args.query_scans:
        cfg.query_sess_scan_dir = args.query_scans
    if args.query_poses:
        cfg.query_sess_pose_path = args.query_poses
    if args.out:
        cfg.save_pcd_directory = args.out
    for field in ("central_sess_scan_dir", "central_sess_pose_path",
                  "query_sess_scan_dir", "query_sess_pose_path"):
        if not getattr(cfg, field):
            ap.error(f"{field} required (via --config or CLI flags)")
    if args.mesh_devices is not None:
        cfg.mesh_devices = args.mesh_devices
    elif cfg.mesh_devices is None:
        cfg.mesh_devices = -1
    removerter = Removerter(cfg, device=args.device)

    cache = key = None
    if args.resume and cfg.save_pcd_directory:
        from ltm_torch.utils.stagecache import StageCache, stage_key

        cache = StageCache(os.path.join(cfg.save_pcd_directory, ".stage_cache"))
        key = stage_key("ltremovert", cfg,
                        [cfg.central_sess_scan_dir, cfg.central_sess_pose_path,
                         cfg.query_sess_scan_dir, cfg.query_sess_pose_path])
        if cache.check("ltremovert", key):
            log.info("inputs+config unchanged — cached artifacts in %s", cfg.save_pcd_directory)
            return 0

    central = RemovertInput.from_dirs(cfg.central_sess_scan_dir, cfg.central_sess_pose_path)
    query = RemovertInput.from_dirs(cfg.query_sess_scan_dir, cfg.query_sess_pose_path)
    log.info("central: %d scans | query: %d scans", len(central.scans), len(query.scans))

    removerter.run(central, query, save_directory=cfg.save_pcd_directory)
    log.info("artifacts written to %s", cfg.save_pcd_directory)
    if cache is not None:
        cache.commit("ltremovert", key, [cfg.save_pcd_directory])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
