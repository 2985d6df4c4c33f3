"""ltm_torch: the PyTorch / CUDA port of ``ltm`` for NVIDIA Hopper.

The package mirrors ``ltm``'s module layout.  It imports ``torch`` and
never ``jax`` or ``ltm``; what it shares with ``ltm`` it keeps as its own
copy.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

from ltm_torch.device import resolve_device  # noqa: F401
