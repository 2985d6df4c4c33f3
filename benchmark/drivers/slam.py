"""Driver of LT-SLAM cells: ``ltm_torch.slam.LTSlam.run`` on the mix's
bundles of two sessions, jobs taking them in turn.

The configuration's ``settings`` are the program's ``LTSlamConfig`` as
run.  Every job's answer is compared once the window has closed
(``refs/slam_ref.py``): Scan Context's loops against the reference's
(``sc_loop_off``) and both trajectories against the ground truth
(``ate_m``, the configuration's own limit).  Reported beside them, not
compared: the count of loops found against the reference's
(``sc_found_gap``) and the loops' relative poses against the truth
(``loop_err_median_m``, ``loops_max_err_m``), which the control does not
separate (PERF.md).
"""

from __future__ import annotations

import numpy as np
import torch

from harness import traffic as tr
from refs import slam_ref as ref


def program_config(settings: dict):
    from ltm_torch.core.config import ICPConfig, LTSlamConfig, ScanContextConfig, SolverConfig

    s = dict(settings)
    nested = {"scan_context": ScanContextConfig(**s.pop("scan_context")),
              "icp": ICPConfig(**s.pop("icp")), "solver": SolverConfig(**s.pop("solver"))}
    s = {k: tuple(v) if isinstance(v, list) else v for k, v in s.items()}
    return LTSlamConfig(**s, **nested)


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        from ltm_torch.io.sessions import SessionData
        from ltm_torch.slam import LTSlam

        self.settings = cell.config["settings"]
        self.limits = cell.config["limits"]
        self.device = device
        self.slam = LTSlam(program_config(self.settings), device=device)
        self.bundles = tr.sessions(cell, seed)
        self.data = [tuple(SessionData(name=s.name, node_ids=s.node_ids, poses=s.poses,
                                       edges=s.edges, scans=s.scans)
                           for s in (b["central"], b["query"])) for b in self.bundles]
        self.answers = []

    def _run(self, b: int):
        c, q = self.data[b]
        res = self.slam.run(c, q, save_directory=None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return res, c.num_nodes + q.num_nodes

    def job(self, i: int) -> int:
        b = i % len(self.data)
        res, units = self._run(b)
        self.answers.append(self.answer(b, res))
        return units

    def warm_up(self) -> None:
        """One job on each bundle: each graph's shapes."""
        for b in range(len(self.data)):
            self._run(b)

    def check_among(self, n_jobs: int) -> None:
        """Every job is checked."""

    def answer(self, b: int, res) -> dict:
        """The job's loops (target node, source node, relative pose), in the
        order added (Scan Context's first), and its trajectories."""
        s = self.slam
        loops = [(tv - s.n_sessions, sv - s.n_sessions - s.nodes_cap, np.asarray(T, np.float64))
                 for tv, sv, _, _, T, _ in s.anchored]
        return {"bundle": b, "poses": {k: np.asarray(v) for k, v in res.central_poses.items()},
                "loops": loops, "n_sc": res.num_sc_loops, "n_rs": res.num_rs_loops,
                "sc_found": res.diagnostics.get("sc_pairs_found_02", 0)}

    # ------------------------------------------------------------------
    def reference_loops(self, dtype=torch.float64):
        sc = self.settings["scan_context"]
        out = []
        for b in self.bundles:
            qd = ref.scan_contexts(b["query"].scans, sc, dtype)
            td = ref.scan_contexts(b["central"].scans, sc, dtype)
            out.append(ref.detect_loops(qd, td, sc))
        return out

    def numbers(self, answers, ref_loops):
        worst = {"sc_loop_off": 0.0, "ate_m": 0.0}
        info = {"jobs_checked": len(answers), "sc_found_gap": 0.0, "loop_err_median_m": 0.0}
        for a in answers:
            b = self.bundles[a["bundle"]]
            want = ref_loops[a["bundle"]]
            n_ref = int((want >= 0).sum())
            sc_loops = a["loops"][:a["n_sc"]]
            off = sum(int(want[s] != t) for t, s, _ in sc_loops)
            site = {"01": b["central"].site_poses, "02": b["query"].site_poses}
            errs = [np.linalg.norm(T[:3, 3] - ref.relative_truth(site["01"][t], site["02"][s])[:3, 3])
                    for t, s, T in a["loops"]]
            info["sc_found_gap"] = max(info["sc_found_gap"],
                                       abs(a["sc_found"] - n_ref) / max(n_ref, 1))
            info["loop_err_median_m"] = max(info["loop_err_median_m"],
                                            float(np.median(errs)) if errs else float("inf"))
            vals = {"sc_loop_off": off / max(len(sc_loops), 1),
                    "ate_m": ref.ate_rmse(a["poses"], site)}
            for k, v in vals.items():
                worst[k] = max(worst[k], v)
            info["loops_max_err_m"] = max(info.get("loops_max_err_m", 0.0), max(errs, default=0.0))
        return worst, info

    def checks(self):
        self.slam = None
        worst, info = self.numbers(self.answers, self.reference_loops())
        return [(k, v, self.limits[k]) for k, v in worst.items()], info

    def control(self, dtype=torch.bfloat16):
        """The reference in ``dtype`` put in the program's place: its loop
        set as the program's, each loop's pose and the trajectories the
        truth computed in ``dtype``."""
        ref64, low = self.reference_loops(), self.reference_loops(dtype)
        answers = []
        for b, bundle in enumerate(self.bundles):
            site = {"01": bundle["central"].site_poses, "02": bundle["query"].site_poses}
            loops = [(int(t), s, ref.relative_truth(site["01"][t], site["02"][s], dtype))
                     for s, t in enumerate(low[b]) if t >= 0]
            poses = {n: torch.from_numpy(p).to(dtype).double().numpy() for n, p in site.items()}
            answers.append({"bundle": b, "poses": poses, "loops": loops, "n_sc": len(loops),
                            "n_rs": 0, "sc_found": len(loops)})
        worst, info = self.numbers(answers, ref64)
        return [(k, v, self.limits[k]) for k, v in worst.items()], info
