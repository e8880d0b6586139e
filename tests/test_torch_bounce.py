"""The port's fused bounce (plain PyTorch version) against the JAX package.

Three oracles:
- one bounce of `bounce.bounce_physics`, called eagerly (op by op) on the
  same random lanes;
- the whole render against the JAX fused kernel's own step function
  (`bounce.wave_step`) run eagerly until no lane is alive, and against
  the jitted XLA wavefront `integrator.render_wavefront`;
- `tests/golden_renders.npz`.

Eager JAX rounds every op on its own, as the port and the CUDA kernel do
(built with --fmad=false). Jitted XLA:CPU contracts a*b+c into fused
multiply-adds and rewrites 1/sqrt, which moves floats by an ulp; a path
that crosses a discrete decision (a Fresnel draw, a Russian roulette of
beta, an edge of a face) right there then changes a whole pixel. The
comparisons against jitted JAX are statistical for that reason.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniraytracer_tpu.models import camera as jcam
from miniraytracer_tpu.models import integrator as jinteg
from miniraytracer_tpu.models import scenes as jscenes
from miniraytracer_tpu.ops import bounce as jbounce
from miniraytracer_tpu.ops import rng as jrng
from miniraytracer_tpu.ops.vecmath import V3 as JV3
from miniraytracer_tpu.scene.builder import SceneBuilder as JBuilder
from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.ops import bounce as tbounce
from miniraytracer_tpu_torch.ops.vecmath import V3 as TV3
from miniraytracer_tpu_torch.scene.builder import SceneBuilder as TBuilder
from tests.make_goldens import BOUNCES as G_BOUNCES, SIZE as G_SIZE, SPP as G_SPP

torch.set_num_threads(1)

MAX_LUM = 1000.0


def _synthetic(builder_cls):
    """Everything the fused class can hold that the four scenes do not use:
    a moving sphere, a lens camera with a shutter, metal, a triangle, a
    sphere-bounded volume, a sphere light beside a rect light."""
    b = builder_cls()
    b.name = "synthetic"
    b.set_camera([0, 1, 5], [0, 0.5, 0], [0, 1, 0], 40.0, 1.0,
                 aperture=0.4, focus_dist=5.0, t0=0.0, t1=1.0)
    gray = b.lambertian(b.tex_const([0.5, 0.5, 0.5]))
    red = b.lambertian(b.tex_const([0.8, 0.2, 0.2]))
    lm = b.diffuse_light(b.tex_const([4, 4, 4]))
    b.sphere([0, -1000, 0], 1000, gray)
    b.sphere([-0.6, 0.5, 0], 0.5, red, center1=[0.6, 0.5, 0], t0=0.0, t1=1.0)
    b.sphere([1.2, 0.4, -0.5], 0.4, b.metal(b.tex_const([0.9, 0.9, 0.9]), 0.7))
    b.sphere([-1.2, 0.4, 0.5], 0.4, b.dielectric(1.5))
    b.triangle([-1, 0, -1.5], [1, 0, -1.5], [0, 1.5, -1.5], red)
    b.volume_sphere([0.3, 0.3, 1.0], 0.3, 2.0, b.tex_const([0.9, 0.9, 0.9]))
    b.box([-0.3, 0, -0.3], [0.3, 0.6, 0.3], gray, rot_y_deg=20.0,
          offset=[0.8, 0, 1.2])
    b.add_light(b.sphere([0, 3, 0], 0.5, lm))
    b.add_light(b.xz_rect(-1, 1, -1, 1, 2.5, lm))
    return b.build()


def _scenes(name):
    if name == "synthetic":
        return _synthetic(JBuilder), _synthetic(TBuilder)
    return getattr(jscenes, name)(1.0), getattr(tscenes, name)(1.0)


# origin boxes (lo, hi) for the random lanes: inside the Cornell room, or
# around the book-1 look-at point
_ORIGINS = {
    "cornell_box": ((1, 1, 1), (554, 554, 554)),
    "cornell_smoke": ((1, 1, 1), (554, 554, 554)),
    "two_spheres": ((-0.2, -4, -4), (5.8, 5, 6.4)),
    "perlin_spheres": ((-0.2, -1.5, -2.8), (5.8, 2.5, 5.2)),
    "synthetic": ((-2, 0.05, -2), (2, 2.4, 3)),
}


@pytest.mark.parametrize("name", list(_ORIGINS))
def test_torch_bounce_physics_matches_jax(name):
    js, ts = _scenes(name)
    rs = np.random.default_rng(len(name))
    n = 1024  # (8, 128) tiles for JAX's Perlin lane gather
    lo, hi = (np.asarray(v, np.float32)[:, None] for v in _ORIGINS[name])
    ro = (lo + (hi - lo) * rs.random((3, n), dtype=np.float32)).astype(np.float32)
    rd = rs.normal(size=(3, n)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=0)
    time = rs.random(n, dtype=np.float32)
    inside = rs.integers(0, 2, n).astype(np.int32)
    keys = rs.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)

    meta, tabs = jbounce.pack_scene(js)
    tile = lambda a: jnp.asarray(a.reshape(8, 128))
    jo = jbounce.bounce_physics(
        meta, tabs[:7], tabs[8], JV3(*map(tile, ro)), JV3(*map(tile, rd)),
        tile(time), tile(inside), tile(keys))
    tmeta, ttabs = tbounce.pack_scene(ts)
    t = torch.as_tensor
    to = tbounce.bounce_physics(
        tmeta, ttabs[:7], ttabs[8], TV3(*map(t, ro)), TV3(*map(t, rd)),
        t(time), t(inside), t(keys.astype(np.int64)))

    J = lambda x: np.asarray(x).reshape(-1)
    agree = np.ones(n, bool)
    for f in ("hit", "is_light", "is_specular", "new_inside"):
        same = J(getattr(jo, f)) == getattr(to, f).numpy()
        assert same.mean() >= 0.999, (f, same.mean())
        agree &= same
    assert J(jo.hit).mean() > 0.3  # the lanes exercise real hits
    for f in ("safe_t", "p", "nrm", "emitted", "weight", "new_rd"):
        a, b = getattr(jo, f), getattr(to, f)
        pairs = zip(a, b) if isinstance(b, tuple) else [(a, b)]
        for ac, bc in pairs:
            np.testing.assert_allclose(bc.numpy()[agree], J(ac)[agree],
                                       rtol=1e-5, atol=1e-5, err_msg=f)


def _jax_eager_render(scene, w, h, sq, bounces):
    """JAX's fused render with its step function `bounce.wave_step` run op
    by op on (rows, 128) lane tiles until no lane is alive, from the same
    first rays as `render_wavefront_fused_pixels`. Returns the frame (N, 3)
    and the ray count."""
    meta, tabs = jbounce.pack_scene(scene)
    n = w * h
    rows = 8 * (-(-n // 1024))
    shape = (rows, 128)
    pix = np.zeros(rows * 128, np.uint32)
    pix[:n] = np.arange(n)
    pj = jnp.asarray(pix.reshape(shape))
    keys0 = jrng.ray_key(pj, jnp.zeros(shape, jnp.uint32))
    off = np.float32(0.5 / sq)  # sample 0 of the sq x sq grid
    x = (pix % w).astype(np.float32).reshape(shape)
    y = (pix // w).astype(np.float32).reshape(shape)
    r0 = jcam.get_rays(scene.camera, jnp.asarray((x + off) / w),
                       jnp.asarray((y + off) / h), keys0)
    one, zero = jnp.ones(shape), jnp.zeros(shape)
    iz = jnp.zeros(shape, jnp.int32)
    alive = jnp.asarray((np.arange(rows * 128) < n).astype(np.float32).reshape(shape))
    c = (zero, zero, zero, *r0.ro, *r0.rd, r0.time, one, one, one,
         zero, zero, zero, alive, iz, r0.inside, iz, keys0, zero)
    while bool(jnp.any(c[jbounce.R_ALIVE] > 0)):
        c, _, _ = jbounce.wave_step(
            meta, tabs[:7], tabs[8], tabs[7], w, h, sq, bounces,
            jnp.float32(MAX_LUM), jnp.int32(0), jnp.int32(sq * sq), pj, c)
    flat = lambda a: np.asarray(a).reshape(-1)[:n]
    acc = np.stack([flat(c[i]) for i in range(3)], axis=-1)
    cnt = flat(c[jbounce.NF + jbounce.I_COUNT])
    return acc / np.maximum(cnt, 1)[:, None], float(np.asarray(c[-1]).sum())


def _torch_render(scene, w, h, spp, bounces):
    frame, stats = tbounce.render_wavefront_fused(scene, w, h, spp,
                                                  max_bounces=bounces)
    assert stats["renderer"] == "fused"
    return frame.numpy(), stats["rays"]


RENDERS = [("cornell_box", 16, 8), ("cornell_smoke", 16, 8),
           ("two_spheres", 16, 8), ("perlin_spheres", 12, 6)]


@pytest.mark.parametrize("name,size,bounces", RENDERS)
def test_torch_render_matches_jax_fused_step(name, size, bounces):
    js, ts = _scenes(name)
    fj, rays_j = _jax_eager_render(js, size, size, 2, bounces)
    ft, rays_t = _torch_render(ts, size, size, 4, bounces)
    ft = ft.reshape(-1, 3)
    assert rays_t == rays_j
    err = np.abs(ft - fj).max(axis=1)
    assert (err < 1e-4).mean() >= 0.99, (err < 1e-4).mean()
    np.testing.assert_allclose(ft.mean(0), fj.mean(0), rtol=0.01)


@pytest.mark.parametrize("name,size,bounces", RENDERS)
def test_torch_render_matches_xla_wavefront(name, size, bounces):
    """Against the jitted XLA wavefront, which the JAX fused kernel equals
    in ray count (tests/test_bounce.py). Its fused multiply-adds flip rare
    decisions (module docstring): the ray count may differ by 0.5% and
    about 1.5% of pixels by more than 1e-4 (cornell_box 16x16x4x8: 4 of
    256); channel means stay within 1%."""
    js, ts = _scenes(name)
    fj, st = jinteg.render_wavefront(js, size, size, 4, max_bounces=bounces)
    fj = np.asarray(fj)
    ft, rays_t = _torch_render(ts, size, size, 4, bounces)
    assert abs(rays_t - st["rays"]) <= 0.005 * st["rays"]
    err = np.abs(ft - fj).max(axis=-1)
    assert (err < 1e-4).mean() >= 0.97, (err < 1e-4).mean()
    np.testing.assert_allclose(ft.mean((0, 1)), fj.mean((0, 1)), rtol=0.01)


@pytest.fixture(scope="module")
def goldens():
    with np.load(os.path.join(os.path.dirname(__file__),
                              "golden_renders.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke",
                                  "two_spheres", "perlin_spheres"])
def test_torch_render_matches_golden(goldens, name):
    """Against the jitted XLA goldens at test_golden.py's per-pixel
    tolerance. Perlin turbulence sums hundreds of multiply-adds with
    cancellation near zero, so XLA's fused multiply-adds move ~3% of
    perlin_spheres pixels past rtol 2e-4 (the other scenes: <1%)."""
    ft, _ = _torch_render(getattr(tscenes, name)(1.0), G_SIZE, G_SIZE,
                          G_SPP, G_BOUNCES)
    g = goldens[name]
    assert np.isfinite(ft).all()
    close = np.isclose(ft, g, rtol=2e-4, atol=2e-5).all(axis=-1)
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(ft.mean((0, 1)), g.mean((0, 1)), rtol=0.01)
