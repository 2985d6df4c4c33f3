"""Run one cell of the port's benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json`` and the port,
``ltm_torch``, on a machine with CUDA cards.  Set-up (imports, the seed's
inputs, building the program, one warm-up job that compiles and loads
every kernel the cell's traffic uses) is ``setup_s``; then jobs run back to
back for ``--seconds`` (under the profiler, device activity only, where an
end-to-end metric of the cell is read from the device trace), and the
cell's end-to-end metrics are printed.
``--trace 1`` runs instead the mix's first ``trace_jobs`` jobs with
``LTM_SYNC_STAGES=1`` under ``torch.profiler`` and prints the cell's
per-layer metrics.  Then the checked answers are compared with the plain
reference under ``refs/``; each number compared and its limit end standard
error and the result line (``checks``).  The last line of standard output
is the result, one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
HOST_THREADS = "4"      # the CPU libraries' pools, beside the program's own


def _environment() -> None:
    """Caches of the program's builds inside the checkout, at fixed paths;
    the CPU libraries' thread pools fixed (before torch and NumPy load); the
    program's stages unsynced and its log quiet; imports from the checkout
    and the benchmark's folder."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = HOST_THREADS
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ.pop("LTM_SYNC_STAGES", None)
    logging.disable(logging.INFO)          # the program's per-stage log lines
    for p in (ROOT, BENCH_DIR):
        if p not in sys.path:
            sys.path.insert(0, p)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def traced_jobs(cell, driver, device, n_jobs: int):
    """Run the first ``n_jobs`` jobs under the profiler and the stage
    recorder; the per-layer metrics' context and readers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from harness import trace
    from ltm_torch import utils

    ctx = trace.TraceContext()
    modules = {m["name"]: cell.metric_module(m["name"]) for m in cell.per_layer}
    undo = [mod.install(ctx) for mod in modules.values() if hasattr(mod, "install")]
    utils.reset_stage_times()
    utils.reset_host_reads()
    os.environ["LTM_SYNC_STAGES"] = "1"
    spans = []
    try:
        with trace.host_stages(ctx.stages), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n_jobs):
                t0 = time.time_ns() * 1e-9
                driver.job(i)
                spans.append((t0, time.time_ns() * 1e-9))
            torch.cuda.synchronize(device)
    finally:
        os.environ.pop("LTM_SYNC_STAGES", None)
        for u in undo:
            if u is not None:
                u()
    lo, hi = spans[0][0], spans[-1][1]
    ctx.jobs = n_jobs
    ctx.window_s = hi - lo
    ctx.kernels = trace.align(trace.profiled_kernels(prof), lo, hi)
    ctx.busy_s = trace.union_seconds([(k.start, k.start + k.dur) for k in ctx.kernels], lo, hi)
    ctx.stage_s = utils.stage_times()
    ctx.host_reads = utils.host_reads()
    ctx.breakdown = {"device_ops": trace.device_ops(ctx.kernels),
                     "idle_gaps": trace.idle_by_stage(ctx.kernels, ctx.stages, lo, hi)}
    return ctx, modules


def profiled_window(job, seconds: float, device):
    """``run_window`` under the profiler, device activity only, for the
    end-to-end metrics read from the device trace: ``device_s`` is the
    union of the card's operations over the window (each job ends synced,
    so all of its work lies inside)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from harness import trace
    from harness.window import run_window

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lo = time.time_ns() * 1e-9
        window = run_window(job, seconds)
        torch.cuda.synchronize(device)
        hi = time.time_ns() * 1e-9
    kernels = trace.align(trace.profiled_kernels(prof), lo, hi)
    window.device_s = trace.union_seconds([(k.start, k.start + k.dur) for k in kernels], lo, hi)
    return window


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device, t_start: float):
    """One run of ``cell``: the result's fields but ``device``'s name."""
    import torch

    from harness import host
    from harness.window import run_window

    t_driver = time.perf_counter()
    driver = cell.driver.Driver(cell, seed, device)
    t_warm = time.perf_counter()
    driver.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    setup_parts = {"imports_s": t_driver - t_start, "inputs_and_program_s": t_warm - t_driver,
                   "warm_up_job_s": t_start + setup_s - t_warm}

    metrics, host_info = {}, None
    if trace_on:
        n = int(cell.traffic.get("trace_jobs", 1))
        driver.check_among(n)
        ctx, modules = traced_jobs(cell, driver, device, n)
        window, attempted = None, n
        for m in cell.per_layer:
            v = modules[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        before = host.snapshot()
        if device.type == "cuda" and any(m["source"] == "device_trace" for m in cell.end_to_end):
            window = profiled_window(driver.job, seconds, device)
        else:
            window = run_window(driver.job, seconds)
        host_info = host.between(before, host.snapshot())
        attempted = len(window.jobs)
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else \
                cell.metric_module(m["name"]).read_window(window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    t_ref = time.perf_counter()
    checks, info = driver.checks()
    info["reference_s"] = time.perf_counter() - t_ref
    info.update(setup_parts)
    if host_info is not None:
        info["host"] = host_info
    correct = all(v <= lim for _, v, lim in checks)
    out = {"correct": correct, "attempted": attempted,
           "failed": 0 if correct else 1, "metrics": metrics,
           "device": {"count": 1, "memory_peak_bytes": int(peak)},
           "info": info}
    if window is not None:
        out["window"] = {"jobs": len(window.jobs), "seconds": window.seconds,
                         "device_s": window.device_s,
                         "job_walls_s": [j.wall for j in window.jobs]}
    if trace_on:
        out["device"].update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        out["breakdown"] = ctx.breakdown
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return out


def main(argv=None) -> int:
    _environment()
    args = parse(argv)
    from harness.cell import find_cell, load_json
    from harness.guard import forbidden_modules

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = find_cell(bench, args.workload)

    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), **out["device"]}

    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 4
    print(f"modules checked: none of jax, jaxlib, flax, ltm among {len(sys.modules)} loaded",
          file=sys.stderr)
    if "window" in out:
        print(f"jobs in the window: {out['window']['jobs']}", file=sys.stderr)
    else:
        print(f"traced jobs: {out['attempted']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
