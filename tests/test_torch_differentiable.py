"""rlrpt_tpu_torch's differentiable renderer vs rlrpt_tpu's
(integrators/differentiable.py): the four cases of
tests/test_differentiable.py, and the same radiance and gradients as
jax.grad's when the port is fed JAX's own draws.

JAX's render_diff splits its key into (key, kcam, ktr) per sample, draws
the jitter from kcam and splits ktr once a bounce for that bounce's (R, 2)
direction uniforms; replaying that schedule gives the port the same path
geometry, so the radiance and the gradients in diffuse_c and emission
must agree to f32 rounding (rtol 1e-4, atol 1e-6) at 24x24, 2 spp, 4
bounces.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.config import RenderConfig as JRenderConfig
from rlrpt_tpu.integrators.differentiable import render_diff as jax_diff
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu_torch.camera import Camera, pixel_rays
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.integrators.default_tracer import render_default
from rlrpt_tpu_torch.integrators.differentiable import (pixel_gradients,
                                                        render_diff,
                                                        trace_sample_diff)
from rlrpt_tpu_torch.ops import intersect_pallas as ip
from rlrpt_tpu_torch.scene import cornell_box
from _torch_parity import one_torch_thread  # noqa: F401

CAM = (0.0, 0.0, -3.0)
KW = dict(width=24, height=24, samples_per_pixel=2, max_ray_bounces=4)
_CFG = RenderConfig(**KW)


def _scene():
    return cornell_box(device="cpu")


def test_render_diff_matches_default():
    """tests/test_differentiable.py:18: the frame matches the default
    tracer's mean."""
    scene, cam = _scene(), Camera.create(CAM)
    img_d, _ = render_default(0, scene, cam, _CFG, "cpu")
    img_g = render_diff(1, scene, cam, _CFG, "cpu")
    a, b = img_g.numpy(), img_d.numpy()
    assert img_g.shape == (24, 24, 3) and np.isfinite(a).all()
    assert abs(a.mean() - b.mean()) < 0.5 * max(b.mean(), 1e-3)


def test_emission_gradient_positive():
    """tests/test_differentiable.py:28: brightening the lights brightens
    the image; geometry gets no gradient."""
    scene = _scene()
    loss, grads = pixel_gradients(0, scene, Camera.create(CAM), _CFG,
                                  lambda img: img.mean(), "cpu")
    g_em = grads.emission.numpy()
    assert np.isfinite(g_em).all() and np.isfinite(float(loss))
    assert g_em[scene.n_surfaces:].sum() > 0.0
    for name in ("v0", "v1", "v2", "normal", "luminance"):
        g = getattr(grads, name)
        assert g.shape == getattr(scene, name).shape
        assert not g.any(), name


def test_reflectance_gradient_positive():
    """tests/test_differentiable.py:41."""
    scene = _scene()
    _, grads = pixel_gradients(0, scene, Camera.create(CAM), _CFG,
                               lambda img: img.mean(), "cpu")
    g_c = grads.diffuse_c.numpy()[: scene.n_surfaces]
    assert np.isfinite(g_c).all()
    assert g_c.sum() > 0.0


def test_gradient_descent_recovers_brightness():
    """tests/test_differentiable.py:51: the sign of d loss / d scale
    points a one-parameter light power back to the target's."""
    scene, cam = _scene(), Camera.create(CAM)
    target = render_diff(0, scene, cam, _CFG, "cpu").detach()

    def grad_at(scale):
        s = torch.tensor(scale, requires_grad=True)
        s2 = dataclasses.replace(scene, emission=scene.emission * s)
        loss = ((render_diff(0, s2, cam, _CFG, "cpu") - target) ** 2).mean()
        loss.backward()
        return float(s.grad)

    assert grad_at(0.5) < 0.0    # too dark -> increase scale
    assert grad_at(2.0) > 0.0    # too bright -> decrease scale


def _jax_draws(key, cfg):
    """JAX render_diff's draws: per sample the (H, W, 2) jitter and the
    (B, R, 2) direction uniforms."""
    n = cfg.width * cfg.height
    out = []
    for _ in range(cfg.samples_per_pixel):
        key, kcam, ktr = jax.random.split(key, 3)
        jitter = jax.random.uniform(kcam, (cfg.height, cfg.width, 2),
                                    dtype=jnp.float32)
        us = []
        for _ in range(cfg.max_ray_bounces):
            ktr, sub = jax.random.split(ktr)
            us.append(jax.random.uniform(sub, (n, 2), dtype=jnp.float32))
        out.append((np.array(jitter), np.array(jnp.stack(us))))
    return out


@pytest.mark.parametrize("env", [0.0, 0.5], ids=["env0", "env0.5"])
def test_gradients_equal_jax_grad(env):
    """On JAX's draws the port's radiance and its gradients in diffuse_c
    and emission equal jax.grad's at fixed path geometry (B4b's plain twin
    does the hits)."""
    key = jax.random.PRNGKey(3)
    jcfg = JRenderConfig(**KW, environment_light=env)
    cfg = RenderConfig(**KW, environment_light=env)
    jscene, jcam = jax_cornell_box(), JCamera.create(list(CAM))
    w = np.random.default_rng(0).random((24, 24, 3)).astype(np.float32)

    def jloss(dc, em):
        s = dataclasses.replace(jscene, diffuse_c=dc, emission=em)
        return jnp.sum(jax_diff(key, s, jcam, jcfg) * w)

    img_j = np.asarray(jax_diff(key, jscene, jcam, jcfg))
    g_c_j, g_e_j = map(np.asarray, jax.grad(jloss, argnums=(0, 1))(
        jscene.diffuse_c, jscene.emission))

    scene, cam = _scene(), Camera.create(CAM)
    dc = scene.diffuse_c.clone().requires_grad_(True)
    em = scene.emission.clone().requires_grad_(True)
    live = dataclasses.replace(scene, diffuse_c=dc, emission=em)
    tris = ip.pack_triangles(scene)
    before = ip.KERNEL_F32.launches
    acc = 0.0
    for jitter, u in _jax_draws(key, cfg):
        o, d = pixel_rays(torch.from_numpy(jitter), cam, 24, 24, cfg.focal)
        acc = acc + trace_sample_diff(o, d, live, cfg, torch.from_numpy(u),
                                      tris)
    img_t = (acc / cfg.samples_per_pixel).reshape(24, 24, 3)
    (img_t * torch.from_numpy(w)).sum().backward()
    assert ip.KERNEL_F32.launches == before     # the CPU runs the twin

    np.testing.assert_allclose(img_t.detach().numpy(), img_j, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(dc.grad.numpy(), g_c_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(em.grad.numpy(), g_e_j, rtol=1e-4, atol=1e-6)
    assert np.abs(g_c_j).sum() > 0 and np.abs(g_e_j).sum() > 0


def test_render_diff_draw_schedule():
    """render_diff draws, per sample, the jitter then the (B, R, 2)
    uniforms from its generator, and hands them to trace_sample_diff."""
    scene, cam = _scene(), Camera.create(CAM)
    img = render_diff(torch.Generator().manual_seed(9), scene, cam, _CFG,
                      "cpu")
    gen = torch.Generator().manual_seed(9)
    acc = 0.0
    for _ in range(_CFG.samples_per_pixel):
        jitter = torch.rand((24, 24, 2), generator=gen)
        u = torch.rand((_CFG.max_ray_bounces, 24 * 24, 2), generator=gen)
        o, d = pixel_rays(jitter, cam, 24, 24, _CFG.focal)
        acc = acc + trace_sample_diff(o, d, scene, _CFG, u)
    assert torch.equal(img, (acc / _CFG.samples_per_pixel).reshape(24, 24,
                                                                   3))
    with pytest.raises(ValueError, match="uniforms"):
        trace_sample_diff(o, d, scene, _CFG, u[:2])
