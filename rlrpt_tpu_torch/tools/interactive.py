"""Interactive SDL render window with keyboard camera control
(counterpart of ``rlrpt_tpu/tools/interactive.py``).

The reference's presentation layer: the SDL window and per-frame render
loop of main.cu:42-89 (`Update()` polls the keyboard and moves or rotates
the camera; main.cu:207-243 re-renders and presents each frame) and
sdl_screen.cpp.  pygame (SDL2) only presents: every pixel comes from the
port's renderers, on the card unless ``--device cpu``.  pygame is imported
inside ``main`` alone, so ``_build_renderer`` runs where pygame is absent.

Keys (matching Camera::Update, main.cu:61-88):
  UP / W      move forwards          DOWN / S    move backwards
  LEFT / A    rotate left            RIGHT / D   rotate right
  Q / E       rotate up / down
  F           save frame (BMP, like SDL_SaveImage -> screenshot.bmp)
  ESC         quit

Modes: default (kernel B1), sarsa (the fine map learning online across
frames, like the reference's mode-1 loop, main.cu:301-362, on kernel B4a)
and sarsa-mega (the binned map learning inside kernel B2 each frame).
The learned maps are camera-independent, so moving the camera keeps
them.  Frame n's seed is ``evaluate.fold_in(1984, n)``.

Headless operation: --frames N renders N frames along a scripted camera
path under SDL's dummy video driver and saves the last frame.

Usage:
  python -m rlrpt_tpu_torch.tools.interactive [--scene cornell]
      [--mode default] [--size 360] [--spp 4] [--bounces 20] [--frames 0]
      [--out out.bmp] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch


def _build_renderer(mode, scene, cfg, rl, device):
    """Returns render(seed, camera) -> (image (H, W, 3), aux), carrying the
    learning state between calls for the sarsa modes (like the reference's
    persistent device radiance map, main.cu:274-301)."""
    device = torch.device(device)
    scene = scene.to(device)
    if mode == "default":
        from rlrpt_tpu_torch.ops.megakernel import render_default_mega

        def render(seed, camera):
            return render_default_mega(seed, scene, camera, cfg, device)
        return render

    if mode == "sarsa":
        from rlrpt_tpu_torch.integrators.sarsa_wavefront import (
            render_frame_sarsa_wavefront)
        from rlrpt_tpu_torch.radiance.grid_bucket import (
            build_volume_class_table)
        from rlrpt_tpu_torch.radiance.volumes import build_radiance_volumes

        vols = build_radiance_volumes(scene, rl)
        grid = build_volume_class_table(vols, scene)
        state = {"vols": vols}

        def render(seed, camera):
            img, state["vols"], aux = render_frame_sarsa_wavefront(
                seed, scene, camera, state["vols"], grid, cfg, rl, pix_mux=2)
            return img, aux
        return render

    if mode == "sarsa-mega":
        from rlrpt_tpu_torch.ops.guided_mega_train import (
            init_bin_q, rebuild_bin_cdf, render_sarsa_mega_train)
        from rlrpt_tpu_torch.ops.megakernel import _t_pad

        rl_k = rl if rl.grid_resolution != 12 else dataclasses.replace(
            rl, grid_resolution=11)
        gr, ub = rl_k.grid_resolution, 4
        t_pad = _t_pad(scene.n_triangles)
        q, vis = init_bin_q(t_pad, ub, gr, rl_k.initial_radiance,
                            device=device)

        def rebuild(q):
            return rebuild_bin_cdf(q, gr, ub, t_pad,
                                   defensive_mix=rl_k.defensive_mix)
        state = {"q": q, "vis": vis, "tb": rebuild(q)}

        def render(seed, camera):
            img, state["q"], state["vis"], aux = render_sarsa_mega_train(
                seed, scene, camera, state["tb"], state["q"], state["vis"],
                cfg, rl_k.radiance_threshold, device)
            state["tb"] = rebuild(state["q"])
            return img, aux
        return render

    raise SystemExit(f"unknown --mode {mode}")


def _apply_keys(camera, keys, move=0.1, rot=0.1):
    """Camera::Update key bindings (main.cu:61-88 / camera.cu:9-83)."""
    import pygame

    if keys[pygame.K_UP] or keys[pygame.K_w]:
        camera = camera.move_forwards(move)
    if keys[pygame.K_DOWN] or keys[pygame.K_s]:
        camera = camera.move_backwards(move)
    if keys[pygame.K_LEFT] or keys[pygame.K_a]:
        camera = camera.rotate_left(rot)
    if keys[pygame.K_RIGHT] or keys[pygame.K_d]:
        camera = camera.rotate_right(rot)
    if keys[pygame.K_q]:
        camera = camera.rotate_up(rot)
    if keys[pygame.K_e]:
        camera = camera.rotate_down(rot)
    return camera


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--mode", default="default",
                    choices=("default", "sarsa", "sarsa-mega"))
    ap.add_argument("--size", type=int, default=360)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--bounces", type=int, default=20)
    ap.add_argument("--area-per-sample", type=float, default=0.01)
    ap.add_argument("--frames", type=int, default=0,
                    help=">0: headless scripted run of N frames, then exit")
    ap.add_argument("--out", default="screenshot.bmp")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda runs the CUDA kernels, cpu "
                         "their plain torch twins")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.frames > 0:
        # Headless: SDL renders into a dummy surface, no display needed.
        os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

    import pygame

    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
    from rlrpt_tpu_torch.scene import presets
    from rlrpt_tpu_torch.tools.evaluate import fold_in
    from rlrpt_tpu_torch.utils.image import tonemap, write_bmp

    p = presets.get(args.scene)
    scene = p.load(device=args.device)
    camera = Camera.create(p.camera_position)
    cfg = RenderConfig(width=args.size, height=args.size,
                       samples_per_pixel=args.spp,
                       max_ray_bounces=args.bounces)
    rl = RadianceVolumeConfig(area_per_sample=args.area_per_sample)
    render = _build_renderer(args.mode, scene, cfg, rl, args.device)

    pygame.init()
    screen = pygame.display.set_mode((args.size, args.size))
    pygame.display.set_caption(f"rlrpt_tpu_torch — {args.scene} "
                               f"({args.mode})")
    clock = pygame.time.Clock()
    frame_no = 0
    running = True
    img_u8 = None

    while running:
        t0 = time.time()
        img, aux = render(fold_in(1984, frame_no), camera)
        img_u8 = tonemap(img)      # waits for the device
        # PutPixelSDL equivalent: one blit of the tonemapped frame
        # (sdl_screen.cpp:96-108 clamps to 8-bit per pixel; tonemap does).
        surf = pygame.surfarray.make_surface(img_u8.swapaxes(0, 1))
        screen.blit(surf, (0, 0))
        pygame.display.flip()
        dt = time.time() - t0
        print(f"frame {frame_no}: {dt:.2f}s  "
              f"avg_path {float(aux['avg_path_length']):.2f}", flush=True)
        frame_no += 1

        if args.frames > 0:
            # Scripted headless camera path: orbit + dolly.
            camera = camera.rotate_left(0.05).move_forwards(0.02)
            if frame_no >= args.frames:
                running = False
            continue

        # Interactive: block until a key or quit event, then apply the
        # held keys (re-render only on input, so the card idles while
        # nothing changes).
        waiting = True
        while waiting and running:
            for ev in pygame.event.get():
                if ev.type == pygame.QUIT:
                    running = False
                elif ev.type == pygame.KEYDOWN:
                    if ev.key == pygame.K_ESCAPE:
                        running = False
                    elif ev.key == pygame.K_f:
                        write_bmp(args.out, img_u8)
                        print(f"saved {args.out}", flush=True)
                    else:
                        waiting = False
            if waiting and running:
                clock.tick(60)
        camera = _apply_keys(camera, pygame.key.get_pressed())

    if img_u8 is not None:
        write_bmp(args.out, img_u8)
        print(f"saved {args.out}", flush=True)
    pygame.quit()


if __name__ == "__main__":
    main()
