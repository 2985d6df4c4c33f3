"""The port stands alone: importing it pulls in neither ``jax`` nor ``ltm``,
no port file (nor ``chip_smoke.py``) imports them, and its entry points
refuse to run on the CPU unless asked to."""

import os
import re
import subprocess
import sys

import pytest
import torch

from ltm_torch.removert import Removerter
from ltm_torch.slam import LTSlam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_and_ltm_out():
    code = ("import sys\n"
            "import ltm_torch, ltm_torch.removert.pipeline, ltm_torch.kernels.knn2\n"
            "import ltm_torch.kernels.chunk_knn, ltm_torch.cli.ltremovert\n"
            "import ltm_torch.io.pcd, ltm_torch.io.poses, ltm_torch.io.sessions\n"
            "import ltm_torch.utils.viz, ltm_torch.utils.stagecache\n"
            "import ltm_torch.slam, ltm_torch.slam.convert, ltm_torch.cli.ltslam\n"
            "import ltm_torch.cli.ltmapper, ltm_torch.io.synthetic, ltm_torch.io.g2o\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ltm'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _port_sources():
    for root, _, files in os.walk(os.path.join(REPO, "ltm_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_port_file_imports_jax_or_ltm():
    pat = re.compile(r"^\s*(import\s+(jax|ltm)\b|from\s+(jax|ltm)(\.|\s))", re.M)
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            if pat.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert not offenders


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert Removerter().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Removerter()
    assert Removerter(device="cpu").device.type == "cpu"


def test_ltslam_default_device_is_cuda():
    if torch.cuda.is_available():
        assert LTSlam().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LTSlam()
    assert LTSlam(device="cpu").device.type == "cpu"
