"""Share of the sweeps' roofline (K2, K3), %: the least time the card could
take for the traced jobs' sweep calls over the device time of the ``k2_*``
and ``k3_*`` kernels.

Each call's work is counted from its inputs and outputs, whatever
implements it (a frozen copy of ``chip_smoke.sweep_work``'s arithmetic at
commit 15258b49d6b0, recast to count no block selection of the kernel's):
every live map point within the call's range bound of a keyframe that has
a scan point or an image pixel to compare (every keyframe in the winner
pass), projected once for that keyframe (62 FP64 and 15 FP32 operations;
K3's winner pass 2 and 3 more), every valid scan point of
the forward sweep projected once (50 and 9); the bytes read once (the live
points' coordinates and flags, the scans, the images, the poses) and
written once (the mask, K3's images).  The bound is the larger of the FP64
operations at the FP64 peak and the FP32 ones at the FP32 peak (separate
pipes), against the bytes at the HBM rate.
"""

from harness.peaks import H100_BYTES_PER_S, H100_FP32_FLOPS, H100_FP64_FLOPS
from harness.trace import kernel_base_seconds

FP64_POINT, FP32_POINT = 62, 15
FP64_SCAN, FP32_SCAN = 50, 9
FUNCS = ("block_sweep_discrepancy", "block_sweep_discrepancy_vs_images",
         "block_fused_visibility_images")


def install(ctx):
    import ltm_torch.removert.pipeline as pipe

    calls = ctx.records.setdefault("sweeps", [])
    saved = {n: getattr(pipe, n) for n in FUNCS}

    def wrap(name, fn):
        def recording(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out
        return recording

    for n, fn in saved.items():
        setattr(pipe, n, wrap(n, fn))
    return lambda: [setattr(pipe, n, fn) for n, fn in saved.items()]


def _in_range(xyz, origins, max_range):
    """Points of ``xyz`` within ``max_range`` of each origin, summed; and the
    points within range of any."""
    import torch

    total = 0
    anyk = torch.zeros(len(xyz), dtype=torch.bool, device=xyz.device)
    for o in origins:
        near = ((xyz - o) ** 2).sum(-1) <= max_range * max_range
        total += int(near.sum())
        anyk |= near
    return total, int(anyk.sum())


def call_work(name, args, kwargs):
    """(fp64, fp32, bytes) of one sweep call."""
    import torch

    bm = args[0]
    live = bm.mask.reshape(-1)
    if name != "block_sweep_discrepancy" and args[1] is not None:
        live = live & args[1].reshape(-1)
    xyz = bm.xyz.reshape(-1, 3)[live]
    nbytes = 0
    if name == "block_sweep_discrepancy":
        scans, smask, poses = args[1], args[2], args[4]
        has = smask.any(1)
        scan_pts = int(smask.sum())
        nbytes += scan_pts * 12 + smask.numel()
    elif name == "block_fused_visibility_images":
        poses, proj_shape = args[3], args[6]
        has = torch.ones(len(poses), dtype=torch.bool)
        scan_pts = 0
        nbytes += int(has.sum()) * proj_shape[0] * proj_shape[1] * 4
    else:
        imgs, poses = args[2], args[4]
        has = (imgs < 1e4).any(-1) if imgs.dim() > 1 else torch.ones(len(poses), dtype=torch.bool)
        scan_pts = 0
        nbytes += imgs.numel() * imgs.element_size()
    origins = poses[:, :3, 3][has.to(poses.device)[:len(poses)]]
    pts, touched = _in_range(xyz.double(), origins.double(), float(kwargs["max_range"]))
    fused = name == "block_fused_visibility_images"
    fp64 = pts * (FP64_POINT + 2 * fused) + scan_pts * FP64_SCAN
    fp32 = pts * (FP32_POINT + 3 * fused) + scan_pts * FP32_SCAN
    nbytes += touched * 13 + bm.mask.numel() + len(origins) * 64
    return fp64, fp32, nbytes


def read(ctx):
    dev_s, n = kernel_base_seconds(ctx.kernels, ("k2_", "k3_"))
    calls = ctx.records.get("sweeps", [])
    if not n or not calls:
        return None
    bound = 0.0
    for name, args, kwargs, _ in calls:
        fp64, fp32, nbytes = call_work(name, args, kwargs)
        bound += max(fp64 / H100_FP64_FLOPS, fp32 / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S)
    calls.clear()
    return 100.0 * bound / dev_s
