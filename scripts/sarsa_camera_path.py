"""Frame times of ``tools/interactive.py --mode sarsa`` without its window:
the fine map learning online across frames on one CUDA card, the camera
moved along the tool's scripted headless path (each frame
``rotate_left(0.05).move_forwards(0.02)``) or held still:

    python scripts/sarsa_camera_path.py [--frames 20] [--size 360]
        [--spp 4] [--bounces 20] [--path moving|still] [--device cuda]

The renderer is the tool's own (``interactive._build_renderer``: the
Cornell box, ``area_per_sample`` 0.01, ``pix_mux`` 2), so a tree without
this script times the same frames (run it by path with ``PYTHONPATH`` set
to that tree).  A frame is timed from its call to the end of the card's
work on it, as the tool's tonemap waits.  Prints the card's name and power
limit, then one JSON row: the seconds of every frame, the median of all
but the first (which builds the kernels, the tables and, on the graph
route, the first captures) and, on the card, the bytes the allocator holds
at the end and at most.
"""

import argparse
import json
import statistics
import subprocess
import time

import torch

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.scene import presets
from rlrpt_tpu_torch.tools.evaluate import fold_in
from rlrpt_tpu_torch.tools.interactive import _build_renderer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--size", type=int, default=360)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--bounces", type=int, default=20)
    ap.add_argument("--path", choices=("moving", "still"), default="moving")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    on_card = args.device.startswith("cuda")
    if on_card:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    wait = torch.cuda.synchronize if on_card else (lambda: None)
    p = presets.get("cornell")
    scene = p.load(device=args.device)
    camera = Camera.create(p.camera_position)
    cfg = RenderConfig(width=args.size, height=args.size,
                       samples_per_pixel=args.spp,
                       max_ray_bounces=args.bounces)
    rl = RadianceVolumeConfig(area_per_sample=0.01)
    render = _build_renderer("sarsa", scene, cfg, rl, args.device)
    seconds = []
    for n in range(args.frames):
        wait()
        t0 = time.perf_counter()
        render(fold_in(1984, n), camera)
        wait()
        seconds.append(time.perf_counter() - t0)
        if args.path == "moving":
            camera = camera.rotate_left(0.05).move_forwards(0.02)
    row = {"path": args.path, "size": args.size, "spp": args.spp,
           "frames": args.frames, "median_s": statistics.median(seconds[1:]),
           "seconds": seconds}
    if on_card:
        row.update(reserved_bytes=torch.cuda.memory_reserved(),
                   max_reserved_bytes=torch.cuda.max_memory_reserved())
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
