"""The renderers over the bounce in tensor operations, against the JAX package:
the plain wavefront (`integrator.render_wavefront`), the work queue with its
shading in tensor operations (`render_workqueue_pixels(fused_shade=False)`),
`intersect.make_accel`, and `render` of random_spheres_2.

- `make_accel`: the same keys as JAX's on its accelerator (JAX's called with
  `jax.default_backend` reporting "tpu"), the sphere and triangle tables to
  1e-6 of each row's scale (tests/test_torch_flash.py), the clusters' boxes
  and order and the turbulence tables EQUAL.
- random_spheres_2, 6x6 pixels, 4 samples, 5 bounces, against JAX's
  `render_workqueue_pixels` and `render_wavefront_pixels` run eagerly
  (`jax.disable_jit()`, so no multiply-add is contracted). With the sphere set
  swept by the same formula on both sides (`make_accel`'s "sph" entry left
  out: `intersect.sphere_ts`) steps, claims, sample counts and rays are EQUAL
  and frames within 1e-6. Through `render` the dense sphere kernel's plain
  version sums the quadratic in another order; on the radius-1000 ground c
  cancels and t moves by up to ~4e-4, so a path may turn elsewhere: rays
  within 1%, channel means within 2%.
- `render_wavefront` against `tests/golden_renders.npz` (24x24, 4 spp, 6
  bounces; jitted XLA, which contracts multiply-adds) for the five scenes
  that need no asset file, at the tolerances of
  tests/test_torch_bounce.py::test_torch_render_matches_golden: 95% of pixels
  at test_golden.py's rtol 2e-4 / atol 2e-5, channel means within 1%. (The
  other four goldens were rendered with the earth map and the meshes, which
  the repository does not hold: without them JAX's own golden test fails on
  those four too.)
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import miniraytracer_tpu_torch as mrt
from miniraytracer_tpu.models import integrator as jinteg
from miniraytracer_tpu.models import scenes as jscenes
from miniraytracer_tpu.ops import intersect as jix
from miniraytracer_tpu.scene.builder import SceneBuilder as JBuilder
from miniraytracer_tpu_torch.models import integrator as tinteg
from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.ops import flash as tflash
from miniraytracer_tpu_torch.ops import hybrid as thybrid
from miniraytracer_tpu_torch.ops import intersect as tix
from miniraytracer_tpu_torch.ops import noise as tnoise
from tests.make_goldens import BOUNCES as G_BOUNCES, SIZE as G_SIZE, SPP as G_SPP
from tests.test_torch_flash import _assert_rows_close

torch.set_num_threads(1)

W = H = 6
SPP, BOUNCES = 4, 5
GOLDEN_OK = ["random_spheres", "two_spheres", "perlin_spheres", "cornell_box", "cornell_smoke"]


def _jax_eager(fn, *args, **kw):
    """fn run op by op, with the number of `_shade_and_advance` calls."""
    calls = []
    real = jinteg._shade_and_advance

    def count(*a, **k):
        calls.append(1)
        return real(*a, **k)

    jinteg._shade_and_advance = count
    try:
        with jax.disable_jit():
            out = fn(*args, **kw)
    finally:
        jinteg._shade_and_advance = real
    return out, len(calls)


@pytest.fixture(scope="module")
def jax_rs2():
    """JAX's eager queue and wavefront on random_spheres_2: {renderer:
    (frame (N, 3), count (N,), rays, steps)}."""
    js = jscenes.random_spheres_2(1.0)
    offs, _ = jinteg.sample_offsets(SPP)
    kw = dict(width=W, height=H, max_bounces=BOUNCES)
    (a, c, r), steps = _jax_eager(jinteg.render_workqueue_pixels, js, W * H, W * H, offs, SPP,
                                  jnp.float32(1000.0), **kw)
    out = {"workqueue": (np.asarray((a * (1.0 / jnp.maximum(c, 1.0))).arr), np.asarray(c),
                         int(r), steps)}
    (a, c, r), steps = _jax_eager(jinteg.render_wavefront_pixels, js,
                                  jnp.arange(W * H, dtype=jnp.uint32), offs, jnp.int32(0),
                                  jnp.int32(SPP), jnp.float32(1000.0), **kw)
    cf = jnp.maximum(c.astype(jnp.float32), 1.0)
    out["wavefront"] = (np.asarray((a * (1.0 / cf)).arr), np.asarray(c), int(r), steps)
    return out


def _without_dense_spheres(monkeypatch):
    real = tix.make_accel
    monkeypatch.setattr(tix, "make_accel", lambda scene, **kw: {
        k: v for k, v in real(scene, **kw).items() if k != "sph"})


def test_eager_queue_equals_eager_jax(jax_rs2, monkeypatch):
    _without_dense_spheres(monkeypatch)
    ts = tscenes.random_spheres_2(1.0)
    fj, cj, rj, steps_j = jax_rs2["workqueue"]
    stats = {}
    a, c, r = tinteg.render_workqueue_pixels(
        ts, W * H, W * H, SPP, 1000.0, width=W, height=H, max_bounces=BOUNCES, spp_sq=2,
        fused_shade=False, stats=stats)
    assert stats["steps"] == steps_j > BOUNCES
    assert stats["claimed"] == W * H * (SPP + 1)  # every finished path claims once
    np.testing.assert_array_equal(c.numpy(), cj)
    assert int(r) == rj
    np.testing.assert_allclose((a / c.clamp_min(1)[:, None]).numpy(), fj, atol=1e-6)
    # fewer lanes than pixels: the same samples in another order
    stats_few = {}
    a2, c2, r2 = tinteg.render_workqueue_pixels(
        ts, W * H, 10, SPP, 1000.0, width=W, height=H, max_bounces=BOUNCES, spp_sq=2,
        fused_shade=False, stats=stats_few)
    assert int(r2) == rj and torch.equal(c2, c) and stats_few["claimed"] == 10 + W * H * SPP
    np.testing.assert_allclose((a2 / c2.clamp_min(1)[:, None]).numpy(), fj, atol=1e-6)


def test_wavefront_equals_eager_jax(jax_rs2, monkeypatch):
    _without_dense_spheres(monkeypatch)
    ts = tscenes.random_spheres_2(1.0)
    fj, cj, rj, steps_j = jax_rs2["wavefront"]
    frame, stats = tinteg.render_wavefront(ts, W, H, SPP, max_bounces=BOUNCES,
                                           device="cpu")
    assert stats["renderer"] == "wavefront" and stats["steps"] == steps_j
    assert stats["rays"] == rj
    np.testing.assert_allclose(frame.numpy().reshape(-1, 3), fj, atol=1e-6)
    pix = torch.arange(W * H, dtype=torch.int32)
    _, count, rays = tinteg.render_wavefront_pixels(ts, pix, 0, SPP, 1000.0, width=W, height=H,
                                                    max_bounces=BOUNCES, spp_sq=2)
    assert count.dtype == torch.int32 and rays.dtype == torch.int32
    np.testing.assert_array_equal(count.numpy(), cj)
    # sample blocks: samples [1, 4) of each pixel alone
    _, c3, _ = tinteg.render_wavefront_pixels(ts, pix, 1, 3, 1000.0, width=W, height=H,
                                              max_bounces=BOUNCES, spp_sq=2)
    assert (c3 == 3).all()


def test_render_routes_random_spheres_2_to_the_eager_queue(jax_rs2):
    """`render` on the CPU: the rule picks the work queue, `prefer_hybrid` is
    false (ext-material mode with an image), so the shading is in tensor
    operations over `make_accel` (the dense sphere sweep and the turbulence,
    their plain versions here: no launch is counted)."""
    ts = tscenes.random_spheres_2(1.0)
    assert mrt.pick_renderer(ts) == "workqueue" and not thybrid.prefer_hybrid(ts)
    assert set(tix.make_accel(ts)) == {"sph", "perlin"}
    counts = (thybrid.shade_launches, tflash.sphere_launches, tnoise.launches)
    frame, stats = mrt.render(ts, W, H, SPP, max_bounces=BOUNCES, device="cpu")
    assert counts == (thybrid.shade_launches, tflash.sphere_launches, tnoise.launches)
    assert stats["renderer"] == "workqueue" and stats["lanes"] == W * H
    fj, cj, rj, steps_j = jax_rs2["workqueue"]
    assert stats["claimed"] == W * H * (SPP + 1)
    assert abs(stats["rays"] - rj) <= 0.01 * rj and abs(stats["steps"] - steps_j) <= 2
    ft = frame.numpy().reshape(-1, 3)
    assert np.isfinite(ft).all()
    np.testing.assert_allclose(ft.mean(0), fj.mean(0), rtol=0.02)
    # the same render through the wavefront and with plain=True
    f2, s2 = mrt.render_wavefront(ts, W, H, SPP, max_bounces=BOUNCES, plain=True,
                                  device="cpu")
    assert abs(s2["rays"] - rj) <= 0.01 * rj
    np.testing.assert_allclose(f2.numpy().reshape(-1, 3).mean(0), fj.mean(0), rtol=0.02)


@pytest.mark.parametrize("name", GOLDEN_OK)
def test_wavefront_matches_golden(name):
    with np.load(os.path.join(os.path.dirname(__file__), "golden_renders.npz")) as z:
        golden = z[name]
    frame, stats = mrt.render_wavefront(getattr(tscenes, name)(1.0), G_SIZE, G_SIZE, G_SPP,
                                        max_bounces=G_BOUNCES, device="cpu")
    ft = frame.numpy()
    assert np.isfinite(ft).all() and stats["rays"] > G_SIZE * G_SIZE * G_SPP
    close = np.isclose(ft, golden, rtol=2e-4, atol=2e-5).all(axis=-1)
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(ft.mean((0, 1)), golden.mean((0, 1)), rtol=0.01)


def _accel_pair(name):
    if name == "spheres_5000":
        return (tscenes.hybrid_probe(1.0, 5000, 0, builder_cls=JBuilder),
                tscenes.hybrid_probe(1.0, 5000, 0))
    if name == "triangles_200":
        return (tscenes.hybrid_probe(1.0, 80, 200, builder_cls=JBuilder),
                tscenes.hybrid_probe(1.0, 80, 200))
    return getattr(jscenes, name)(1.0), getattr(tscenes, name)(1.0)


@pytest.mark.parametrize("name,keys", [
    ("random_spheres_2", {"sph", "perlin"}), ("book2_final", {"sph_gate", "perlin"}),
    ("spheres_5000", {"sph_cull"}), ("triangles_200", {"sph", "tri"}),
    ("cornell_box", set()), ("perlin_spheres", {"perlin"})])
def test_make_accel_equals_jax(monkeypatch, name, keys):
    js, ts = _accel_pair(name)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jacc = jix.make_accel(js) or {}
    acc = tix.make_accel(ts)
    assert set(jacc) == set(acc) == keys
    for k in ("sph", "tri"):
        if k in acc:
            for a, b in zip(jacc[k], acc[k]):
                _assert_rows_close(a, b.numpy())
    for k in ("sph_gate", "sph_cull"):
        if k in acc:
            (jcb, jcc), jbounds, jorig, _ = jacc[k]
            (cb, cc), bounds, orig = acc[k]
            np.testing.assert_array_equal(orig.numpy(), np.asarray(jorig))
            np.testing.assert_array_equal(bounds.numpy(), np.asarray(jbounds))
            for a, b in ((jcb, cb), (jcc, cc)):
                _assert_rows_close(a, b.numpy())
    if "perlin" in acc:
        jtab = np.asarray(jacc["perlin"])
        np.testing.assert_array_equal(
            acc["perlin"].numpy(),
            np.stack([np.concatenate([jtab[16 * r], jtab[16 * r + 8]]) for r in range(6)]))
    # the scans' entries: each sweep's differentiable key, no turbulence
    d_keys = {{"sph": "sph_d", "sph_gate": "sph_cull_d", "sph_cull": "sph_cull_d",
               "tri": "tri_d"}[k] for k in keys if k != "perlin"}
    dacc = tix.make_accel(ts, differentiable=True)
    assert set(dacc) == set(jix.make_accel(js, differentiable=True) or {}) == d_keys
    for k, kd in (("sph", "sph_d"), ("tri", "tri_d")):
        if k in acc:
            for a, b in zip(acc[k], dacc[kd]):
                assert torch.equal(a, b)


def test_fast_perlin_and_small_scenes_reach_the_plain_wavefront():
    """The rule's last answer, on its own: a fast_perlin scene leaves the fused
    class (and `make_accel` has no turbulence tables for it), a scene with
    more materials than the fused tables hold and fewer than 64 primitives
    is no hybrid scene. `render` draws both through `render_wavefront`."""
    fast = dataclasses.replace(tscenes.perlin_spheres(1.0), fast_perlin=True)
    b = mrt.SceneBuilder()
    b.name = "many_materials"
    b.set_camera([0, 3, 12], [0, 1, 0], [0, 1, 0], 40.0, 1.0, aperture=0.0,
                 focus_dist=10.0, t0=0.0, t1=0.0)
    rs = np.random.RandomState(1)
    for _ in range(30):
        b.sphere(rs.uniform(-5, 5, 3).tolist(), 0.5,
                 b.lambertian(b.tex_const(rs.uniform(0, 1, 3).tolist())))
    many = b.build()
    for scene in (fast, many):
        assert mrt.pick_renderer(scene) == "wavefront"
        assert "perlin" not in tix.make_accel(scene)
        frame, stats = mrt.render(scene, 8, 8, 1, max_bounces=3, device="cpu")
        assert stats["renderer"] == "wavefront" and torch.isfinite(frame).all()
        assert frame.shape == (8, 8, 3) and stats["rays"] >= 64


def test_trace_paths_equals_eager_jax():
    """One path for each of 128 camera rays of cornell_smoke, bounce by bounce
    at a common depth: radiance within 1e-6, rays EQUAL. The scan loop of the
    AD paths gives the same paths."""
    from miniraytracer_tpu.models import camera as jcam
    from miniraytracer_tpu_torch.models import camera as tcam

    js, ts = jscenes.cornell_smoke(1.0), tscenes.cornell_smoke(1.0)
    rs = np.random.default_rng(2)
    s, t = (rs.random(128, dtype=np.float32) for _ in range(2))
    keys = rs.integers(0, 2 ** 32, 128, dtype=np.int64)
    rays = tcam.get_rays(ts.camera, torch.as_tensor(s), torch.as_tensor(t), torch.as_tensor(keys))
    rad, n_rays = tinteg.trace_paths(ts, rays, torch.as_tensor(keys), 6)
    jrays = jcam.get_rays(js.camera, jnp.asarray(s), jnp.asarray(t),
                          jnp.asarray(keys.astype(np.uint32)))
    (jrad, jn), _ = _jax_eager(jinteg.trace_paths, js, jrays, jnp.asarray(keys.astype(np.uint32)), 6)
    assert n_rays.dtype == torch.int64 and int(n_rays) == int(jn) > 128
    for a, b in zip(rad, jrad):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    # the AD paths' loop: exactly 7 bounces, the same paths
    rad_s, n_s = tinteg.trace_paths(ts, rays, torch.as_tensor(keys), 6, loop="scan")
    assert int(n_s) == int(n_rays)
    for a, b in zip(rad_s, rad):
        assert torch.equal(a, b)
