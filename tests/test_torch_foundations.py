"""rlrpt_tpu_torch foundations vs rlrpt_tpu: scene, counter PRNG, camera,
hemisphere maps, image IO, and the port's independence from JAX."""

import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.camera import primary_rays as jax_primary_rays
from rlrpt_tpu.ops import hemisphere as jhs
from rlrpt_tpu.ops import linalg as jla
from rlrpt_tpu.ops import megakernel as jmk
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu.utils import image as jimage
from rlrpt_tpu_torch.camera import Camera, pixel_rays
from rlrpt_tpu_torch.ops import hemisphere as hs
from rlrpt_tpu_torch.ops import linalg as la
from rlrpt_tpu_torch.ops import megakernel as mk
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.utils import image
from _torch_parity import one_torch_thread, torch_scene  # noqa: F401

PKG = pathlib.Path(__file__).resolve().parent.parent / "rlrpt_tpu_torch"


@pytest.mark.parametrize("field", ["v0", "v1", "v2", "normal", "diffuse_c",
                                   "emission", "luminance"])
def test_cornell_arrays_equal(field):
    j, t = jax_cornell_box(), cornell_box(device="cpu")
    assert t.n_surfaces == j.n_surfaces == 36 and t.n_triangles == 38
    np.testing.assert_array_equal(getattr(t, field).numpy(),
                                  np.asarray(getattr(j, field)))
    # the numpy hand-over used by the parity tests is lossless too
    np.testing.assert_array_equal(
        getattr(torch_scene(j), field).numpy(), np.asarray(getattr(j, field)))


def test_uniform_bit_equal():
    seeds = [0, 1, 12345, 2 ** 30 + 3, 2 ** 31 - 2]
    pix = np.array([0, 1, 7, 518_399, 2 ** 24 + 5, 2 ** 31 - 1])
    its = np.array([0, 1, 2, 80, 4097, 2 ** 31 - 1])
    P, I = np.meshgrid(pix, its, indexing="ij")
    for seed in seeds:
        for stream in range(6):
            j = jmk._uniform(jnp.int32(seed), jnp.asarray(P, jnp.int32),
                             jnp.asarray(I, jnp.int32), stream)
            t = mk._uniform(seed, torch.from_numpy(P), torch.from_numpy(I),
                            stream)
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_hash32_bit_equal_above_2_31():
    """Inputs with the top bit set: int32 negatives on the JAX side,
    uint32 >= 2^31 here (the shifts must be logical)."""
    x = np.array([2 ** 31, 2 ** 31 + 1, 0xDEADBEEF, 0xFFFFFFFF, 0x9E3779B9,
                  0, 1, 2 ** 31 - 1], dtype=np.uint32)
    j = np.asarray(jmk._hash32(jnp.asarray(x.view(np.int32)))).view(np.uint32)
    t = mk._hash32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(t.astype(np.uint32), j)


def test_concentric_map_and_sector_cos():
    g = np.linspace(0.0, 1.0, 41, dtype=np.float32)
    X, Y = np.meshgrid(g, g, indexing="ij")
    np.testing.assert_allclose(
        hs.concentric_map(torch.from_numpy(X), torch.from_numpy(Y)).numpy(),
        np.asarray(jhs.concentric_map(jnp.asarray(X), jnp.asarray(Y))),
        atol=1e-6)
    for grid in (11, 12):
        np.testing.assert_allclose(hs.sector_cos_thetas(grid).numpy(),
                                   np.asarray(jhs.sector_cos_thetas(grid)),
                                   atol=1e-6)


def test_uniform_hemisphere_and_frame():
    rng = np.random.default_rng(0)
    r1, r2 = rng.random((2, 256)).astype(np.float32)
    np.testing.assert_allclose(
        hs.uniform_hemisphere_local(torch.from_numpy(r1),
                                    torch.from_numpy(r2)).numpy(),
        np.asarray(jhs.uniform_hemisphere_local(jnp.asarray(r1),
                                                jnp.asarray(r2))),
        atol=1e-6)
    n = rng.normal(size=(256, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    np.testing.assert_allclose(la.make_frame(torch.from_numpy(n)).numpy(),
                               np.asarray(jla.make_frame(jnp.asarray(n))),
                               atol=1e-6)


@pytest.mark.parametrize("yaw", [(0.0, 0.0), (0.3, -0.2)])
def test_primary_rays(yaw):
    key = jax.random.PRNGKey(3)
    w, h = 24, 16
    jcam = JCamera.create([0.0, 0.0, -3.0], *yaw)
    o_j, d_j = jax_primary_rays(key, jcam, w, h, float(h))
    jitter = np.asarray(jax.random.uniform(key, (h, w, 2),
                                           dtype=jnp.float32))
    cam = Camera.create([0.0, 0.0, -3.0], *yaw)
    o_t, d_t = pixel_rays(torch.tensor(jitter), cam, w, h, float(h))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)

    # the megakernels' per-slot generator against make_primary_fn
    pix = np.arange(w * h, dtype=np.int32)
    u1, u2 = jitter.reshape(-1, 2).T
    cam_row = jnp.asarray([mk.camera_vector(cam) + (0.0,)], jnp.float32)
    j = jmk.make_primary_fn(cam_row, w * h, w, h, float(h))(
        jnp.asarray(pix)[None], jnp.asarray(u1)[None], jnp.asarray(u2)[None])
    t = mk._primary(torch.from_numpy(pix.astype(np.int64)),
                    torch.from_numpy(u1.copy()), torch.from_numpy(u2.copy()),
                    mk.camera_vector(cam), w, h, float(h))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[0], atol=1e-6)


def test_image_io_and_mape(tmp_path):
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    hdr = rng.random((9, 13, 3)).astype(np.float32) * 1.3
    for name, writer, jwriter in (("a.png", image.write_png, jimage.write_png),
                                  ("a.bmp", image.write_bmp, jimage.write_bmp)):
        for img in (u8, hdr):
            writer(str(tmp_path / ("t" + name)), torch.from_numpy(img))
            jwriter(str(tmp_path / ("j" + name)), img)
            assert ((tmp_path / ("t" + name)).read_bytes()
                    == (tmp_path / ("j" + name)).read_bytes())
        np.testing.assert_array_equal(
            image.read_image(str(tmp_path / ("t" + name))),
            jimage.tonemap(hdr))
    np.testing.assert_array_equal(image.tonemap(hdr), jimage.tonemap(hdr))
    other = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    assert image.mape_score(u8, other) == jimage.mape_score(u8, other)


def test_port_never_imports_jax():
    """Importing every module of the port leaves jax and rlrpt_tpu out of
    sys.modules, and no source names them in an import."""
    mods = sorted("rlrpt_tpu_torch." + ".".join(p.relative_to(PKG)
                                                .with_suffix("").parts)
                  for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'rlrpt_tpu.')) or m == 'rlrpt_tpu']\n"
            "print(len(sys.modules), bad)\n"
            "raise SystemExit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=PKG.parent, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    pat = re.compile(r"^\s*(import|from)\s+(jax|rlrpt_tpu)(\.|\s|$)", re.M)
    for p in PKG.rglob("*.py"):
        assert not pat.search(p.read_text()), p
