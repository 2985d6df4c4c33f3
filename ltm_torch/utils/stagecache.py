"""Content-addressed stage cache: idempotent, resumable pipeline stages.

The reference's only resume story is its file protocol — every module is
restartable because stages communicate through files on disk (SURVEY §5),
and LT-SLAM even *wipes* its save directory at startup
(``ltslam/src/RosParamServer.cpp:13-14``), so a crash always means a full
re-run.  This module implements the improvement SURVEY §5 calls for
("idempotent stage outputs + content-addressed stage cache"): every CLI
stage computes a content key over (stage name, config, input files), and
after a successful run commits a manifest of its outputs.  A re-run with an
unchanged key verifies the manifest and skips the stage entirely; any input
edit, config change, or missing/size-changed output invalidates it.
Crash-safety comes for free: the manifest is written (atomically) only
after the stage's outputs are fully on disk.

Input fingerprints default to (relative name, size, mtime_ns) per file —
cheap and safe for the multi-GB scan directories this pipeline consumes.
Set ``LTM_STAGE_CACHE_HASH=content`` to fingerprint by SHA-256 of file
contents instead (immune to mtime-preserving edits, at the cost of reading
every input byte).  The port's copy of ``ltm.utils.stagecache``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Iterable, List, Optional

__all__ = ["fingerprint_paths", "stage_key", "StageCache"]

_KEY_VERSION = "ltm-stagecache-v1"


def _iter_files(path: str) -> Iterable[str]:
    if os.path.isfile(path):
        yield path
        return
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for name in sorted(files):
            yield os.path.join(root, name)


def _file_fingerprint(path: str, rel: str, by_content: bool) -> str:
    if by_content:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return f"{rel}:sha256:{h.hexdigest()}"
    st = os.stat(path)
    return f"{rel}:stat:{st.st_size}:{st.st_mtime_ns}"


def fingerprint_paths(paths: Iterable[str]) -> List[str]:
    """One fingerprint line per input file (dirs are walked, sorted)."""
    by_content = os.environ.get("LTM_STAGE_CACHE_HASH", "stat") == "content"
    out: List[str] = []
    for p in paths:
        if p is None or not os.path.exists(p):
            out.append(f"{p}:absent")
            continue
        base = os.path.dirname(p) if os.path.isfile(p) else p
        for f in _iter_files(p):
            rel = os.path.join(os.path.basename(p), os.path.relpath(f, base))
            out.append(_file_fingerprint(f, rel, by_content))
    return out


def _config_blob(cfg) -> str:
    if cfg is None:
        return "null"
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    return json.dumps(cfg, sort_keys=True, default=repr)


def stage_key(stage: str, cfg, inputs: Iterable[str], extra: str = "") -> str:
    """SHA-256 content key of a stage invocation."""
    h = hashlib.sha256()
    for part in (_KEY_VERSION, stage, _config_blob(cfg), extra, *fingerprint_paths(inputs)):
        h.update(part.encode())
        h.update(b"\0")
    return h.hexdigest()


class StageCache:
    """Manifest store rooted in the pipeline's output directory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _manifest_path(self, stage: str, key: str) -> str:
        return os.path.join(self.root, f"{stage}-{key[:16]}.json")

    def check(self, stage: str, key: str) -> Optional[dict]:
        """Return the manifest iff this (stage, key) ran before and every
        recorded output still exists with its recorded size."""
        path = self._manifest_path(stage, key)
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        if manifest.get("key") != key:
            return None
        for rec in manifest.get("outputs", []):
            try:
                if os.stat(rec["path"]).st_size != rec["size"]:
                    return None
            except OSError:
                return None
        return manifest

    def commit(self, stage: str, key: str, output_paths: Iterable[str]) -> dict:
        """Record a successful run. Call only after outputs are on disk."""
        cache_root = os.path.abspath(self.root)
        outputs = []
        for p in output_paths:
            for f in _iter_files(p) if os.path.exists(p) else ():
                if os.path.abspath(f).startswith(cache_root + os.sep):
                    continue  # the cache's own manifests are not stage outputs
                outputs.append({"path": f, "size": os.stat(f).st_size})
        manifest = {"key": key, "stage": stage, "outputs": outputs}
        path = self._manifest_path(stage, key)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return manifest
