"""Structured logging + stage timing (the port's copy of ``ltm.utils.logging``).

A context-manager stage timer records wall-clock per pipeline stage.  CUDA
work is asynchronous, so a stage's wall is its host time unless
``LTM_SYNC_STAGES=1``, which synchronises the card at every stage boundary
for accurate attribution (totals then include the waits).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

import torch

__all__ = ["get_logger", "stage_timer", "stage_times", "reset_stage_times",
           "count_slots", "slot_counts", "reset_slot_counts", "current_stage",
           "count_host_read", "host_reads", "reset_host_reads"]

_STAGE_TIMES: Dict[str, float] = {}
_STAGE_STACK: list = []
_SLOT_COUNTS: Dict[str, int] = {}  # map-slots touched per stage
_HOST_READS: Dict[str, int] = {}   # device-to-host reads that steer a loop, by kind


def current_stage() -> str:
    return _STAGE_STACK[-1] if _STAGE_STACK else "<none>"


def count_slots(n: int) -> None:
    """Accumulate ``n`` map-slot touches (scatter/gather elements) against
    the innermost active stage — host-side integers only, no device cost."""
    s = current_stage()
    _SLOT_COUNTS[s] = _SLOT_COUNTS.get(s, 0) + int(n)


def slot_counts() -> Dict[str, int]:
    return dict(_SLOT_COUNTS)


def reset_slot_counts() -> None:
    _SLOT_COUNTS.clear()


def count_host_read(kind: str) -> None:
    """Count one device read that a host loop waits on (a PCG stop test, an
    ICP round's ``done``, an LM accept test): each one drains the card's
    queue before the host can enqueue more."""
    _HOST_READS[kind] = _HOST_READS.get(kind, 0) + 1


def host_reads() -> Dict[str, int]:
    return dict(_HOST_READS)


def reset_host_reads() -> None:
    _HOST_READS.clear()


def get_logger(name: str = "ltm_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage_timer(stage: str, logger: Optional[logging.Logger] = None):
    """Times a pipeline stage and records it globally (see module doc for
    ``LTM_SYNC_STAGES``)."""
    sync = os.environ.get("LTM_SYNC_STAGES") == "1"
    if sync:
        _sync()
    t0 = time.perf_counter()
    _STAGE_STACK.append(stage)
    try:
        yield
    finally:
        _STAGE_STACK.pop()
        if sync:
            _sync()
        dt = time.perf_counter() - t0
        _STAGE_TIMES[stage] = _STAGE_TIMES.get(stage, 0.0) + dt
        (logger or get_logger()).info("stage %-32s %8.3f s", stage, dt)


def stage_times() -> Dict[str, float]:
    return dict(_STAGE_TIMES)


def reset_stage_times() -> None:
    _STAGE_TIMES.clear()
