"""Large-scene throughput bench (counterpart of
``rlrpt_tpu/tools/scene_bench.py``).

The megakernel's sweep tests every triangle at every path segment: it is
O(T) per segment, as the reference's hot loop is (GPU_Rendering_Engine/
Source/rays/ray.cu:17-36); the culled kernel walks a bounding-volume
hierarchy instead (``render_default_mega(cull=...)``).  This records, per
scene, the frame time of ``render_default_mega`` (kernel B1) so the cost
of T is measured, not argued.

    python -m rlrpt_tpu_torch.tools.scene_bench [--scenes cornell,bunny]
        [--spp 1] [--size 720] [--bounces 80] [--frames 3] [--r-tile 128]
        [--pix-mux 1] [--no-morton] [--cull on|off|both] [--json PATH]
        [--device cuda]

One JSON line per scene and cull setting (the JAX tool's rows: ``both``
gives an off and an on row for a scene of more than one 256-triangle
chunk, an off row alone for one chunk): triangles, cull, morton,
sec_per_frame (host clock around render_default_mega, packing, the
tree's build and assembly included, fenced by a synchronize),
avg_path_length, rays_per_sec, ray_tri_tests_per_sec (the brute force's
tests a second: rays x T, culled or not) and, on the card, kernel_ms
(CUDA events around B1's launches on the same tables and tree).  On the
CPU kernel_ms is null: the twin's time is no device metric.
The card's name and power limit are printed first.  ``bench_scene``
times one Scene and camera, so callers can bench a scene that is no
preset.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.ops import megakernel as mk
from rlrpt_tpu_torch.scene import presets
from rlrpt_tpu_torch.scene.scene import Scene, morton_sort_surfaces
from rlrpt_tpu_torch.ops.bvh import build_bvh
from rlrpt_tpu_torch.tools.mega_sweep import card_state, kernel_ms


def bench_scene(name: str, scene: Scene, camera: Camera, cfg: RenderConfig,
                device, frames: int = 3, morton: bool = True,
                r_tile: int = mk.R_TILE, pix_mux: int = mk.PIX_MUX,
                seed: int = 1984, cull: bool = False) -> dict:
    """One row: ``frames`` timed frames after 3 warm-up frames, culled
    when ``cull`` and the scene spans more than one chunk
    (megakernel.use_cull)."""
    device = torch.device(device)
    if morton:
        scene = morton_sort_surfaces(scene)
    scene = scene.to(device)
    cuda = device.type == "cuda"
    cull = mk.use_cull(scene.n_triangles, cull)

    def fence():
        if cuda:
            torch.cuda.synchronize(device)

    def run(i):
        return mk.render_default_mega(seed + i, scene, camera, cfg, device,
                                      r_tile=r_tile, pix_mux=pix_mux,
                                      cull=cull)

    for i in range(3):
        run(900 + i)
    fence()
    t0 = time.perf_counter()
    paths = [run(i)[1]["avg_path_length"] for i in range(frames)]
    fence()
    dt = (time.perf_counter() - t0) / frames
    plen = float(sum(float(p) for p in paths) / frames)
    rays = plen * cfg.n_pixels * cfg.samples_per_pixel
    n_tris = scene.n_triangles
    row = {"scene": name, "triangles": n_tris, "cull": cull,
           "morton": morton,
           "sec_per_frame": dt, "avg_path_length": plen,
           "rays_per_sec": rays / dt,
           "ray_tri_tests_per_sec": rays * n_tris / dt,
           "kernel_ms": None,
           "device": (torch.cuda.get_device_name(device) if cuda
                      else "cpu")}
    if cuda:
        tris, mat = mk.pack_scene(scene)
        cam = mk.camera_vector(camera)
        n_slots = mk.n_slots_for(cfg.n_pixels, r_tile, pix_mux)
        args = (seed, cam, tris, mat, cfg, n_slots, pix_mux)
        tree = build_bvh(tris) if cull else None
        row["kernel_ms"] = kernel_ms(
            lambda: mk.mega_default_frame(*args, tree), frames)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", default="cornell,medieval_house,bunny",
                    help="comma-separated preset names")
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--size", type=int, default=720)
    ap.add_argument("--bounces", type=int, default=80)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--r-tile", type=int, default=mk.R_TILE)
    ap.add_argument("--pix-mux", type=int, default=mk.PIX_MUX)
    ap.add_argument("--morton", action="store_true", default=True,
                    help="Morton-sort the surfaces (scene."
                         "morton_sort_surfaces; the default)")
    ap.add_argument("--no-morton", dest="morton", action="store_false")
    ap.add_argument("--cull", choices=("on", "off", "both"), default="both",
                    help="the culled kernel B1, a BVH walk (multi-chunk "
                         "scenes only; 'both' records an off/on row pair "
                         "per such scene)")
    ap.add_argument("--json", default=None, help="also write the rows here")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda times kernel B1, cpu its twin")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        print(card_state(), flush=True)
    cfg = RenderConfig(width=args.size, height=args.size,
                       samples_per_pixel=args.spp,
                       max_ray_bounces=args.bounces)
    rows = []
    for name in args.scenes.split(","):
        p = presets.get(name)
        scene = p.load(device=device)
        multi = mk.use_cull(scene.n_triangles)
        modes = {"on": [True], "off": [False],
                 "both": [False, True] if multi else [False]}[args.cull]
        for cull in modes:
            row = bench_scene(name, scene, Camera.create(p.camera_position),
                              cfg, device, args.frames, args.morton,
                              args.r_tile, args.pix_mux, cull=cull)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"config": {"size": args.size, "spp": args.spp,
                                  "bounces": args.bounces,
                                  "r_tile": args.r_tile,
                                  "pix_mux": args.pix_mux},
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
