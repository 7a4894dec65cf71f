"""rlrpt_tpu_torch's thesis MAPE evaluation (tools/evaluate.py) vs
rlrpt_tpu's: the chunking and the MAPE equal JAX's, the ground-truth
cache is shared by file name (JAX writes, the port reads and never
overwrites), the rows and their keys are JAX's, the default row's MAPE
against one shared GT falls among JAX's over four keys, and --append
merges as JAX's does (tests/test_evaluate.py:31).

Small sizes: the JAX smoke size (32 px, GT 16 spp, tests of 8 spp, 6
bounces), the port on its plain twins.
"""

import ast
import inspect
import json
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu.tools import evaluate as jeval
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.tools import evaluate
from _torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SMOKE = dict(size=32, gt_spp=16, spp=8, bounces=6, sarsa_frames=1,
             sarsa_spp=2, nq_frames=1, nq_spp=1, area_per_sample=0.05)
# tests/test_evaluate.py:20
JAX_METHODS = ["default", "sarsa", "sarsa_guided", "default_eqtime",
               "sarsa_mega", "default_eqtotal", "neural_q"]


def _jax_row_keys() -> dict:
    """Each method's row keys as the JAX tool writes them, read from its
    source: the dict literal of each rows.append, plus the keys the final
    loop sets on every row (not the conditional russian_roulette)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(
        jeval.evaluate_scene)))
    keys, common = {}, set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "append"
                and node.args and isinstance(node.args[0], ast.Dict)):
            d = node.args[0]
            ks = [k.value for k in d.keys]
            keys[d.values[ks.index("method")].value] = set(ks)
        if (isinstance(node, ast.For) and isinstance(node.target, ast.Name)
                and node.target.id == "r"):
            for stmt in node.body:
                if isinstance(stmt, ast.Assign):
                    common.add(stmt.targets[0].slice.value)
    assert common == {"gt_spp", "gt_render_sec", "size", "bounces"}
    return {m: k | common for m, k in keys.items()}


@pytest.mark.parametrize("total,chunk", [(4096, 256), (300, 256), (128, 32),
                                         (7, 8), (0, 16), (129, 128)])
def test_split_chunks_match_jax(total, chunk):
    assert evaluate._split_chunks(total, chunk) == jeval._split_chunks(
        total, chunk)


@pytest.mark.parametrize("scale", [1.0, 1.6], ids=["in_range",
                                                   "out_of_range"])
def test_mape_matches_jax(scale):
    """Seeded images, negative and above-1 values included at scale 1.6."""
    rng = np.random.default_rng(4)
    img = (rng.random((24, 20, 3)) * scale - 0.2 * (scale - 1)).astype(
        np.float32)
    gt = (rng.random((24, 20, 3)) * scale).astype(np.float32)
    if scale > 1:
        assert img.min() < 0 and img.max() > 1 and gt.max() > 1
    assert evaluate._mape(img, gt) == jeval._mape(img, gt)
    assert evaluate._mape(torch.from_numpy(img), gt) == jeval._mape(img, gt)


def test_gt_cache_shared_and_never_overwritten(tmp_path):
    """JAX writes gt_cornell_16_4_3.npz through --gt-cache-dir; the port
    reads it under the same name (gt_render_sec 0) and leaves it as it
    was; writing over a cache file raises."""
    flags = ["--scene", "cornell", "--size", "16", "--gt-spp", "4",
             "--spp", "2", "--bounces", "3", "--skip-sarsa", "--skip-nq",
             "--gt-cache-dir", str(tmp_path)]
    jeval.main(flags + ["--out", str(tmp_path / "j.json")])
    path = tmp_path / "gt_cornell_16_4_3.npz"
    assert path.exists() and evaluate.gt_cache_name(
        "cornell", 16, 4, 3) == path.name
    assert evaluate.gt_cache_name("door_room", 720, 4096, 80,
                                  True) == "gt_door_room_720_4096_80_rr.npz"
    before = path.read_bytes()
    evaluate.main(flags + ["--out", str(tmp_path / "t.json"),
                           "--device", "cpu"])
    assert path.read_bytes() == before
    (row,) = json.loads((tmp_path / "t.json").read_text())["rows"]
    assert row["method"] == "default" and row["gt_render_sec"] == 0.0
    assert np.isfinite(row["mape"])
    with pytest.raises(FileExistsError):
        evaluate.save_gt(str(path), np.zeros((16, 16, 3), np.float32))
    assert path.read_bytes() == before


def test_repo_gt_cache_reads():
    """The thesis GT in the repository: (720, 720, 3) float32, mean
    0.39968."""
    gt = evaluate.load_gt(str(ROOT / "artifacts" / "gt_cache"
                              / evaluate.gt_cache_name("cornell", 720, 4096,
                                                       80)))
    assert gt.shape == (720, 720, 3) and gt.dtype == np.float32
    assert abs(float(gt.mean()) - 0.39968) < 5e-6


def test_rows_and_keys_match_jax():
    """The JAX smoke point (tests/test_evaluate.py:13): JAX's row list, and
    each row has the keys the JAX tool gives it."""
    rows = evaluate.evaluate_scene(
        cornell_box(device="cpu"), Camera.create([0.0, 0.0, -3.0]),
        device="cpu", seed=0, **SMOKE)
    assert [r["method"] for r in rows] == JAX_METHODS
    jax_keys = _jax_row_keys()
    for r in rows:
        assert set(r) == jax_keys[r["method"]], r["method"]
        assert np.isfinite(r["mape"]) and r["mape"] >= 0.0
        assert r["gt_spp"] == 16
        if r["method"] not in ("default_eqtime", "default_eqtotal"):
            assert r["spp"] == 8
    guided = next(r for r in rows if r["method"] == "sarsa_guided")
    assert guided["uv_bins"] == 4 and guided["sector_grid"] == 11
    # the budget rows' keys too
    assert set(jax_keys) == set(JAX_METHODS) | {"sarsa_mega_budget",
                                                "default_budget"}


def test_default_mape_matches_jax(tmp_path):
    """One cached GT (JAX's, key 0); the port's default-row MAPE lies
    within 4 standard deviations of JAX's over keys 0-3."""
    gt_cache = str(tmp_path / "gt.npz")
    kw = dict(SMOKE, skip_sarsa=True, skip_nq=True, gt_cache=gt_cache)
    jax_mapes = [jeval.evaluate_scene(
        jax_cornell_box(), JCamera.create([0.0, 0.0, -3.0]), interpret=True,
        key=jax.random.PRNGKey(k), **kw)[0]["mape"] for k in range(4)]
    port = [evaluate.evaluate_scene(
        cornell_box(device="cpu"), Camera.create([0.0, 0.0, -3.0]),
        device="cpu", seed=s, **kw)[0] for s in (0, 1)]
    mu, sd = np.mean(jax_mapes), np.std(jax_mapes, ddof=1)
    for row in port:
        assert row["gt_render_sec"] == 0.0     # the cached GT
        assert abs(row["mape"] - mu) <= 4 * sd, (row["mape"], jax_mapes)


def test_append_preserves_extra_top_level_keys(tmp_path):
    """tests/test_evaluate.py:31 on the port."""
    out = tmp_path / "EVAL.json"
    out.write_text(json.dumps({
        "protocol": "x", "backend": "cpu", "notes": {"k": "kept"},
        "rows": [{"scene": "cornell", "method": "default", "mape": 1.0},
                 {"scene": "other", "method": "sarsa", "mape": 2.0}]}))
    evaluate.main(["--scene", "cornell", "--size", "16", "--gt-spp", "4",
                   "--spp", "2", "--bounces", "3", "--skip-sarsa",
                   "--skip-nq", "--append", "--out", str(out),
                   "--device", "cpu"])
    d = json.loads(out.read_text())
    assert d["notes"] == {"k": "kept"}
    # the protocol name the JAX tool wrote into EVAL.json
    assert d["protocol"] == evaluate.PROTOCOL == json.loads(
        (ROOT / "EVAL.json").read_text())["protocol"]
    scenes = {(r["scene"], r["method"]) for r in d["rows"]}
    assert ("other", "sarsa") in scenes          # untouched row kept
    # cornell/default replaced by the fresh run (not duplicated)
    assert sum(1 for r in d["rows"]
               if (r["scene"], r["method"]) == ("cornell", "default")) == 1


def test_fold_in_streams():
    """fold_in: deterministic, distinct streams, kernel-valid seeds."""
    seeds = [evaluate.fold_in(1984, n) for n in range(10000)]
    assert seeds == [evaluate.fold_in(1984, n) for n in range(10000)]
    assert len(set(seeds)) == len(seeds)
    assert all(0 <= s < 2 ** 31 - 1 for s in seeds)
    assert evaluate.fold_in(0, 5) != evaluate.fold_in(1, 5)
