"""rlrpt_tpu_torch persistent-wavefront tracer vs rlrpt_tpu's, and its two
hit modes against each other.

The JAX wavefront draws from threefry and the port from a torch.Generator,
so the two agree in distribution: frame mean, column profile, avg path
length (the tolerances of tests/test_wavefront.py:58-108).  At 48x48 and
32 spp the frame mean's seed noise is about 2-3%: JAX keys 0, 1 and 3 give
0.392, 0.398 and 0.410 with RR off.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.config import RenderConfig as JRenderConfig
from rlrpt_tpu.integrators.wavefront import render_wavefront as jax_wavefront
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.integrators.wavefront import render_wavefront
from rlrpt_tpu_torch.ops import intersect_pallas as ip
from rlrpt_tpu_torch.ops.megakernel import render_default_mega
from rlrpt_tpu_torch.scene import cornell_box
from _torch_parity import one_torch_thread  # noqa: F401

CAM = (0.0, 0.0, -3.0)
KW = dict(width=48, height=48, samples_per_pixel=32, max_ray_bounces=8)


def _profile_corr(a, b):
    return np.corrcoef(a.mean(axis=(0, 2)), b.mean(axis=(0, 2)))[0, 1]


@pytest.mark.parametrize("rr", [False, True], ids=["rr_off", "rr_on"])
def test_matches_jax_f32(rr):
    """Port (hit_mode "mxu", its default) vs JAX hit_mode "f32": frame
    means within 8% (about 4 seed-noise sigmas; RR adds variance),
    column profiles correlated, avg path within 0.5, iterations within
    the regeneration bound."""
    kw = dict(KW, russian_roulette=rr)
    img_j, aux_j = jax_wavefront(jax.random.PRNGKey(3), jax_cornell_box(),
                                 JCamera.create(CAM), JRenderConfig(**kw),
                                 interpret=True, hit_mode="f32")
    img_t, aux_t = render_wavefront(1, cornell_box(), Camera.create(CAM),
                                    RenderConfig(**kw), "cpu")
    a, b = img_t.numpy(), np.asarray(img_j)
    assert a.shape == b.shape and np.isfinite(a).all()
    assert abs(a.mean() - b.mean()) / b.mean() < 0.08, (a.mean(), b.mean())
    assert _profile_corr(a, b) > 0.95
    assert abs(float(aux_t["avg_path_length"])
               - float(aux_j["avg_path_length"])) < 0.5
    assert 0 < int(aux_t["wavefront_iterations"]) <= 32 * 8


def test_hit_modes_agree():
    """Both hit modes are exact f32: one generator state gives one image;
    two seeds agree in distribution (tests/test_wavefront.py:58-77)."""
    cfg = RenderConfig(**KW)
    cam = Camera.create(CAM)
    before = (ip.KERNEL_F32.launches, ip.KERNEL_MAT.launches)
    img_m, aux_m = render_wavefront(5, cornell_box(), cam, cfg, "cpu",
                                    hit_mode="mxu")
    img_f, aux_f = render_wavefront(5, cornell_box(), cam, cfg, "cpu",
                                    hit_mode="f32")
    assert torch.equal(img_m, img_f)
    assert float(aux_m["avg_path_length"]) == float(aux_f["avg_path_length"])
    img_g, _ = render_wavefront(torch.Generator().manual_seed(6),
                                cornell_box(), cam, cfg, "cpu", hit_mode="f32")
    m, f = img_m.numpy(), img_g.numpy()
    assert abs(m.mean() - f.mean()) / f.mean() < 0.06
    assert _profile_corr(m, f) > 0.95
    assert (ip.KERNEL_F32.launches, ip.KERNEL_MAT.launches) == before
    with pytest.raises(ValueError, match="hit_mode"):
        render_wavefront(5, cornell_box(), cam, cfg, "cpu", hit_mode="bf16")


def test_rr_keeps_the_mean():
    """RR on and off estimate the same image (the port's megakernel, 64
    spp, as the anchor); RR shortens paths."""
    cfg = RenderConfig(**KW)
    cam = Camera.create(CAM)
    img_r, aux_r = render_wavefront(
        7, cornell_box(), cam, dataclasses.replace(cfg, russian_roulette=True),
        "cpu")
    img_o, aux_o = render_wavefront(8, cornell_box(), cam, cfg, "cpu")
    img_ref, _ = render_default_mega(
        9, cornell_box(), cam,
        dataclasses.replace(cfg, samples_per_pixel=64), device="cpu",
        r_tile=512, pix_mux=4)
    ref = float(img_ref.mean())
    for img in (img_r, img_o):
        assert abs(float(img.mean()) - ref) / ref < 0.06
    assert float(aux_r["avg_path_length"]) < float(aux_o["avg_path_length"])
