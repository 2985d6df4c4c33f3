"""LT-SLAM entry point of the port (mirrors ``roslaunch ltslam run.launch``;
the same flags as ``ltm.cli.ltslam`` plus ``--device``).

Usage:
    python -m ltm_torch.cli.ltslam --config params.yaml
    python -m ltm_torch.cli.ltslam --sessions-dir DIR --central 01 --query 02 --out OUT \\
        [--device cpu]

Reads the reference session-directory protocol (Scans/ SCDs/
singlesession_posegraph.g2o) and writes the reference trajectory files
(``<sess>_{local,central}_{bfr,aft}_intersession_loops.txt``).  ``--device``
(default ``cuda``) picks the torch device; ``--mesh-devices`` keeps
``ltm``'s contract (default -1, every local device): one card, or the CPU
with -1, runs on one device, and a mesh of more than one slot raises
``NotImplementedError`` until the LT-SLAM mesh slice is ported.
"""

from __future__ import annotations

import argparse
import os

from ltm_torch.core.config import LTSlamConfig, load_yaml
from ltm_torch.io.sessions import load_session_dir
from ltm_torch.slam import LTSlam
from ltm_torch.utils import get_logger

log = get_logger("ltm_torch.cli.ltslam")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="LT-SLAM on PyTorch / CUDA")
    ap.add_argument("--config", help="YAML config (LTSlamConfig fields)")
    ap.add_argument("--sessions-dir", help="override sessions_dir")
    ap.add_argument("--central", help="override central_sess_name")
    ap.add_argument("--query", help="override query_sess_name")
    ap.add_argument("--out", help="override save_directory")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="shard hot loops over this many local devices "
                         "(-1 = all, 1 = single; default: all local devices)")
    ap.add_argument("--resume", action="store_true",
                    help="skip the run if inputs+config are unchanged since a "
                         "previous successful one (content-addressed stage cache)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = load_yaml(args.config, "ltslam") if args.config else LTSlamConfig()
    if args.sessions_dir:
        cfg.sessions_dir = args.sessions_dir
    if args.central:
        cfg.central_sess_name = args.central
    if args.query:
        cfg.query_sess_name = args.query
    if args.out:
        cfg.save_directory = args.out
    if not cfg.sessions_dir:
        ap.error("sessions_dir required (via --config or --sessions-dir)")
    if args.mesh_devices is not None:
        cfg.mesh_devices = args.mesh_devices
    elif cfg.mesh_devices is None:
        cfg.mesh_devices = -1
    slam = LTSlam(cfg, device=args.device)

    cache = key = None
    if args.resume and cfg.save_directory:
        from ltm_torch.utils.stagecache import StageCache, stage_key

        cache = StageCache(os.path.join(cfg.save_directory, ".stage_cache"))
        key = stage_key("ltslam", cfg,
                        [os.path.join(cfg.sessions_dir, cfg.central_sess_name),
                         os.path.join(cfg.sessions_dir, cfg.query_sess_name)])
        if cache.check("ltslam", key):
            log.info("inputs+config unchanged — cached outputs in %s", cfg.save_directory)
            return 0

    central = load_session_dir(os.path.join(cfg.sessions_dir, cfg.central_sess_name),
                               max_nodes=cfg.max_nodes_per_session)
    query = load_session_dir(os.path.join(cfg.sessions_dir, cfg.query_sess_name),
                             max_nodes=cfg.max_nodes_per_session)
    log.info("sessions loaded: %s (%d nodes), %s (%d nodes)",
             central.name, central.num_nodes, query.name, query.num_nodes)

    result = slam.run(central, query, save_directory=cfg.save_directory)
    log.info("done: %d SC loops, %d RS loops; trajectories in %s",
             result.num_sc_loops, result.num_rs_loops, cfg.save_directory)
    if cache is not None:
        cache.commit("ltslam", key, [cfg.save_directory])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
