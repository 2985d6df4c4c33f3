"""Driver of LT-removert cells: ``ltm_torch.removert.Removerter.run`` on the
two sessions of the mix's first bundle, each at its true poses in the site's
frame (the sessions as LT-SLAM aligned them), each job under its own frame
of the world.

The configuration's ``settings`` are the program's ``RemovertConfig`` as
run.  The checked job's answer is compared, once the window has closed and
the program's state is freed, with ``refs/removert_ref.py`` on the card:
the prep (``prep_gap``) and the 14 named sets (``set_gap``, the worst).
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from harness import traffic as tr
from refs import removert_ref as ref


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        from ltm_torch.core.config import RemovertConfig
        from ltm_torch.removert import Removerter, RemovertInput

        self.settings = dict(cell.config["settings"])
        self.limits = cell.config["limits"]
        self.traffic, self.seed, self.device = cell.traffic, seed, device
        self.input_type = RemovertInput
        self.rm = Removerter(RemovertConfig(**self.settings), device=device)
        b = tr.sessions(cell, seed)[0]
        self.sessions = [(s.scans, s.site_poses) for s in (b["central"], b["query"])]
        self.want = tr.checked_job(cell.traffic, seed)
        self.kept = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def inputs(self, i: int):
        T = tr.job_frame(self.traffic, self.seed, i)
        return tuple(self.input_type(scans=scans, poses=np.einsum("ij,njk->nik", T, poses))
                     for scans, poses in self.sessions)

    def job(self, i: int) -> int:
        c, q = self.inputs(i)
        res = self.rm.run(c, q, save_directory=None)
        self._sync()
        if 0 <= i <= self.want:
            self.kept = (i, c, q, res)
        return res.central.num_keyframes + res.query.num_keyframes

    def warm_up(self) -> None:
        for _ in range(2):
            self.job(-1)

    def check_among(self, n_jobs: int) -> None:
        """Check one of the first ``n_jobs`` jobs (a traced run's)."""
        self.want = min(self.want, n_jobs - 1)

    # ------------------------------------------------------------------
    def answer(self):
        """The checked job's answer on the host; the program's state freed."""
        i, c, q, res = self.kept
        sets = {n: torch.from_numpy(res.points(n)) for n in ref.SET_NAMES}
        kept = []
        for sess in (res.central, res.query):
            K = sess.num_keyframes
            xyz, m = sess.scans_xyz[:K].cpu(), sess.scans_mask[:K].cpu()
            kept.append([xyz[k][m[k]] for k in range(K)])
        kf = (np.asarray(res.central.keyframe_indices), np.asarray(res.query.keyframe_indices))
        self.kept = self.rm = None
        del res
        gc.collect()
        torch.cuda.empty_cache()
        return {"job": i, "inputs": (c, q), "sets": sets, "kept": kept, "kf": kf}

    def reference(self, ans, dtype=torch.float64):
        """The reference's keyframes, raw scans and sets for the answer's
        inputs, in ``dtype``; its detector starts from the program's kept
        scans (the prep is checked apart, ``prep_gap``)."""
        c, q = ans["inputs"]
        s = self.settings
        c_idx, q_idx = ref.keyframe_indices(c.poses, q.poses, s)
        raw = [[torch.from_numpy(np.asarray(inp.scans[i])[:, :3]).to(self.device, dtype)
                for i in idx] for inp, idx in ((c, c_idx), (q, q_idx))]
        kept = ans["kept"]
        sets = ref.detector_reference(
            [p.to(self.device) for p in kept[0]], c.poses[c_idx],
            [p.to(self.device) for p in kept[1]], q.poses[q_idx], s,
            dtype=dtype, device=self.device)
        return (c_idx, q_idx), raw, sets

    def checks(self):
        ans = self.answer()
        (c_idx, q_idx), raw, sets = self.reference(ans)
        same_kf = (np.array_equal(c_idx, ans["kf"][0]) and np.array_equal(q_idx, ans["kf"][1]))
        prep = 1.0 if not same_kf else ref.prep_gap(
            [p.to(self.device) for p in ans["kept"][0] + ans["kept"][1]],
            raw[0] + raw[1], self.settings)
        gaps = ref.set_gaps({n: v.to(self.device) for n, v in ans["sets"].items()}, sets)
        info = {"job": ans["job"], **{f"gap.{n}": v for n, v in gaps.items()}}
        return [("prep_gap", prep, self.limits["prep_gap"]),
                ("set_gap", max(gaps.values()), self.limits["set_gap"])], info

    def control(self, dtype=torch.bfloat16):
        """The reference in ``dtype`` put in the program's place: its own
        prep against the reference's voxel centroids, and its sets from the
        program's kept scans against the float64 reference's."""
        ans = self.answer()
        (c_idx, q_idx), raw, sets = self.reference(ans)
        low_raw = [[r.to(dtype) for r in rs] for rs in raw]
        low_kept = [ref.prep_reference(r, self.settings) for r in low_raw]
        prep = ref.prep_gap([p for k in low_kept for p in k], raw[0] + raw[1], self.settings)
        _, _, low_sets = self.reference(ans, dtype=dtype)
        gaps = ref.set_gaps({n: v.double() for n, v in low_sets.items()}, sets)
        return [("prep_gap", prep, self.limits["prep_gap"]),
                ("set_gap", max(gaps.values()), self.limits["set_gap"])], \
            {f"gap.{n}": v for n, v in gaps.items()}
