"""The benchmark's core: find a cell of BENCHMARK.json and the files that
define it, run it once, decide ``correct`` and print the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name:

* ``configs/<config>.json``: the deployment (scene, sizes, learning
  settings, pinned ground truth); its ``scene.kind`` names
  ``scenes/<kind>.py``, which loads the scene into the program and
  builds the reference's tables from the configuration's data;
* ``traffic/<mix>.json``: the mix's parameters; its ``loop`` names
  ``loops/<loop>.py``, which drives the program and holds the comparison
  that judges what it produced;
* ``metrics/<metric>.py``: a reader ``read(run)`` that returns the metric's
  value, or None where the run has nothing to read.

A run: set-up (the program's scene, warm-up of the cell's shapes), the
measured window, the peak memory read, the program's state dropped, the
comparison with the reference, the check that no JAX module was loaded,
and the result line, which is the last line of standard output.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import random
import sys
import tempfile
import time
from pathlib import Path

from benchmark.tracing import Spans

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rlrpt_tpu")


class JaxLoaded(RuntimeError):
    """A module of JAX or of the JAX package was loaded in the run."""


class Run:
    """One run of one cell: what the loops fill and the readers read."""

    def __init__(self, root: Path, cell: dict, config: dict, traffic: dict,
                 seed: int, seconds: float, trace: bool, device: str,
                 workdir: Path, t0: float):
        self.root, self.cell, self.config = root, cell, config
        self.traffic, self.seed, self.seconds = traffic, seed, seconds
        self.trace, self.device, self.workdir = trace, device, workdir
        self.t0 = t0
        self.rng = random.Random(seed)
        self.spans = Spans()
        self.setup_s = None
        self.window_s = None
        self.answer_s: list = []       # each answer's seconds, in order
        self.paths_per_answer = None   # camera paths a frame completes
        self.trace_summary = None      # tracing.read_trace of the window
        self.traced_answers = 0        # answers inside the traced window
        self.extra: dict = {}          # what a loop reports to readers
        self.checks: list = []         # (name, value, limit)
        self.failed = 0                # answers checked that failed
        self.check_s = None
        self.setup_parts: dict = {}    # seconds from t0 at each mark

    def mark(self, name: str) -> None:
        """Note the set-up's progress (printed under ``phases``)."""
        self.setup_parts[name] = time.perf_counter() - self.t0

    @property
    def answers(self) -> int:
        return len(self.answer_s)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import ``path`` under ``name`` (metric files carry dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_files(spec: dict, cell: dict, base: Path = HERE) -> tuple:
    """(config, traffic) of a cell, read from their files."""
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    root = base.parent
    config = load_json(root / conf["file"])
    traffic = load_json(base / "traffic" / f"{cell['traffic']}.json")
    return config, traffic


def metrics_for(spec: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports: the end-to-end ones untraced,
    the per-layer ones traced; an entry with ``workloads`` only there."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def read_metrics(run: Run, entries: list, base: Path = HERE) -> dict:
    out = {}
    for m in entries:
        reader = load_module(base / "metrics" / f"{m['name']}.py",
                             f"benchmark_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(run: Run) -> dict:
    import torch
    if run.device == "cpu":
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": int(run.cell["chips"]),
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if run.trace_summary is not None:
        info["busy_s"] = run.trace_summary["busy_s"]
        info["window_s"] = run.trace_summary["window_s"]
    return info


def execute(root: Path, spec: dict, cell: dict, seed: int, seconds: float,
            trace: bool, device: str, t0: float, overrides: dict | None = None,
            faults: dict | None = None, control: bool = False) -> dict:
    """Run ``cell`` once; return the result object.  ``overrides`` (the
    tests' small sizes) merge into the configuration and the mix; ``faults``
    are handed to the loop, which breaks the timed path with them (the
    tests' planted faults); ``control`` adds the control's readings of the
    same comparisons under ``"control"`` (calibrate.py)."""
    config, traffic = cell_files(spec, cell)
    overrides = overrides or {}
    config = merged(config, overrides.get("config", {}))
    traffic = merged(traffic, overrides.get("traffic", {}))
    loop = importlib.import_module(f"benchmark.loops.{traffic['loop']}")
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        run = Run(root, cell, config, traffic, seed, seconds, trace, device,
                  Path(tmp), t0)
        run.extra["faults"] = faults or {}
        if device != "cpu":
            import torch
            torch.cuda.init()
            torch.empty((1,), device=device)
        run.mark("cuda")
        state = loop.prepare(run)
        run.setup_s = time.perf_counter() - t0
        kept = loop.window(run, state)
        device_block = device_info(run)
        del state
        gc.collect()
        if device != "cpu":
            import torch
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        drawn = run.rng.getstate()
        run.checks = loop.check(run, kept)
        run.check_s = time.perf_counter() - t_check
        if control:
            run.rng.setstate(drawn)
            run.extra["control"] = {
                n: v for n, v, _ in loop.check(run, kept, control=True)}
        del kept
    found = forbidden_modules()
    if found:
        raise JaxLoaded(f"modules loaded: {', '.join(found)}")
    run.failed = int(any(v > lim for _, v, lim in run.checks))
    result = {
        "correct": run.failed == 0,
        "attempted": run.answers,
        "failed": run.failed,
        "metrics": read_metrics(run, metrics_for(spec, cell["name"], trace)),
        "device": device_block,
    }
    if run.trace_summary is not None:
        result["breakdown"] = {
            "device_ops": run.trace_summary["device_ops"],
            "idle_gaps": run.trace_summary["idle_gaps"]}
    result["phases"] = {"setup_s": run.setup_s, "window_s": run.window_s,
                        "check_s": run.check_s,
                        "checked": run.extra.get("checked"),
                        "setup_marks": run.setup_parts}
    if control:
        result["control"] = run.extra["control"]
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in run.checks}
    return result


def main(args, t0: float, root: Path) -> int:
    spec = load_json(root / "BENCHMARK.json")
    try:
        cell = find_cell(spec, args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{cell['name']} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        result = execute(root, spec, cell, args.seed, args.seconds,
                         bool(args.trace), "cuda", t0)
    except JaxLoaded as e:
        print(f"refusing to report: {e}", file=sys.stderr)
        return 4
    print(f"phases: {json.dumps(result['phases'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
