"""Nothing the benchmark runs loads JAX or the JAX package: no module
under benchmark/ imports jax, jaxlib, flax or rlrpt_tpu, and a cell run in
a fresh process leaves none of them in sys.modules.  Names are compared
whole by their top-level part, so rlrpt_tpu_torch (the program) passes."""

import ast
import json
import subprocess
import sys

from benchmark import harness
from benchmark.tests.small import ROOT, SMALL


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_top_level_names_are_compared_whole():
    assert "rlrpt_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    assert "rlrpt_tpu.ops".split(".")[0] in harness.FORBIDDEN


def test_no_module_of_the_benchmark_imports_jax():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert len(files) > 20
    bad = [(f.relative_to(ROOT), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in harness.FORBIDDEN]
    assert bad == []


def test_a_cell_run_loads_no_jax():
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        f"root = Path({str(ROOT)!r})\n"
        "s = harness.load_json(root / 'BENCHMARK.json')\n"
        "for name in ('cornell_mega_1spp', 'cornell_sarsa_mega_32spp'):\n"
        "    harness.execute(root, s, harness.find_cell(s, name), 9, 0.2,\n"
        "                    False, 'cpu', time.perf_counter(),\n"
        f"                    overrides={SMALL!r})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.splitlines()[-1]))
    assert "rlrpt_tpu_torch" in loaded
    assert loaded & set(harness.FORBIDDEN) == set()
