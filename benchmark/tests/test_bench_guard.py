"""Nothing the harness loads is JAX or the JAX package (top-level names
compared whole: the port's ``ltm_torch`` begins with ``ltm``)."""

import subprocess
import sys
import textwrap

from conftest import BENCH, ROOT
from harness.guard import forbidden_modules


def test_names_compared_whole():
    assert forbidden_modules(["ltm_torch", "ltm_torch.slam", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["ltm", "ltm.core", "jax.numpy", "flax", "jaxlib"]) == \
        ["flax", "jax.numpy", "jaxlib", "ltm", "ltm.core"]


def test_the_harness_loads_no_jax_and_no_ltm():
    """In a fresh process that refuses to import them, the harness, every
    driver, reference and metric, and the program's entries they call all
    import; and none is in ``sys.modules`` after."""
    code = textwrap.dedent(f"""
        import importlib.abc, os, sys
        for name in list(sys.modules):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "ltm"):
                del sys.modules[name]

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "ltm"):
                    raise ImportError("refused: " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        sys.path[:0] = [{ROOT!r}, {BENCH!r}]
        import run
        from harness import cell, guard, host, synthetic, trace, traffic, window
        bench = cell.load_json(os.path.join({ROOT!r}, "BENCHMARK.json"))
        for w in bench["workloads"]:
            c = cell.find_cell(bench, w["name"])
            cell.load_module(os.path.join(c.bench_dir, "scenes", c.traffic["scene"] + ".py"))
            for m in c.per_layer + [m for m in c.end_to_end if m["name"] != "setup_s"]:
                c.metric_module(m["name"])
        import refs.removert_ref, refs.slam_ref
        import ltm_torch.removert, ltm_torch.slam, ltm_torch.io.sessions
        import ltm_torch.removert.pipeline, ltm_torch.graph.solver
        print(guard.forbidden_modules(sys.modules))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
