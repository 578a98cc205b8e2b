"""Nothing the benchmark runs loads JAX or the JAX package: a tiny run of a
training cell in a fresh process, its modules compared by whole top-level
name, and no file of the benchmark importing them."""

import ast
import json
import subprocess
import sys

from tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sept_tpu"}


def test_no_file_imports_jax():
    for path in (ROOT / "gpu_bench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_a_run_loads_no_jax():
    code = f"""
import json, sys, time
sys.path.insert(0, {str(ROOT / 'gpu_bench' / 'tests')!r})
sys.path.insert(0, {str(ROOT)!r})
from tiny import train_cell
from gpu_bench.drivers import train as train_job
sys.argv = ["run.py"]
import gpu_bench.run as run
rec = train_job.run(train_cell("grl_train_f32"), 21, 0.1, False, "cpu", time.perf_counter())
print(json.dumps({{"correct": rec.correct, "found": run.loaded_forbidden(),
                  "top": sorted({{m.split('.')[0] for m in sys.modules}})}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["found"] == []
    assert "sept_tpu_torch" in got["top"] and not FORBIDDEN & set(got["top"])
