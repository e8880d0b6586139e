"""The port's scan AD paths and progressive renderer against the JAX package.

- `intersect.make_accel(differentiable=True)`: its keys and tables against
  JAX's `make_accel(differentiable=True)` as it builds them on its
  accelerator (`jax.default_backend` patched to "tpu"), one scene per
  threshold class: 64-1023 triangles ("tri_d"), 1024 or more ("tri_cull_d"),
  64-511 spheres ("sph_d"), 512 or more ("sph_cull_d"; the gated and the
  streamed sweep), and a Perlin scene, which gets no key; the coefficient
  rows within 1e-6 of each row's largest entry, the cluster tables equal;
- `trace_paths(loop="scan")` equal to `loop="while"` in the port (radiance
  and rays to the bit) and to JAX's scan run op by op (`jax.disable_jit`,
  its flash sweeps interpreted): rays equal, radiance within 1e-6 on
  cornell_box; on random_spheres_2 within 1e-4 on 95% of the paths and 5e-3
  on all (the dense sphere sweep sums its quadratic in another order than
  JAX's interpreted kernel: t on the radius-1000 ground moves by up to 4e-4,
  and the ground's Perlin texture turns the moved point into up to 3e-3 of
  radiance; with the sphere entry left out on both sides, both sweep with
  `sphere_ts`, and the paths agree within 1e-6);
- `sample_radiance_packed` against the port's unpacked scan and against
  JAX's jitted packed scan, with the JAX package's own rule for the two
  (tests/test_integrator.py: median difference 0, under 0.5% of the items
  off by more than 1e-5; the rays within 1%, `done` equal on 99% of the
  items); its truncation observable, the completed items equal to the full
  run's;
- the port's fused AD step against its own packed scan, as
  tests/test_bounce_ad.py pairs the JAX ones: forward sums within 1e-5 and
  valid counts equal, loss rtol 1e-5, every TrainParams gradient rtol
  2e-3, atol 2e-4 of the leaf's largest entry;
- `render_progressive` against JAX's jitted `integrator.render` with
  `loop="while"` and `"scan"`, by the rule tests/test_torch_bounce.py holds
  the jitted wavefront to (jitted XLA:CPU contracts multiply-adds), and
  `merge_pass`'s average, clamp and NaN policy against JAX's.

The train step against JAX's is in tests/test_torch_scan_train.py.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import miniraytracer_tpu_torch as mrt
from miniraytracer_tpu.models import camera as jcam
from miniraytracer_tpu.models import integrator as jinteg
from miniraytracer_tpu.models import scenes as jscenes
from miniraytracer_tpu.ops import flash as jflash
from miniraytracer_tpu.ops import intersect as jix
from miniraytracer_tpu.scene.builder import SceneBuilder as JBuilder
from miniraytracer_tpu_torch.models import camera as tcam
from miniraytracer_tpu_torch.models import integrator as tinteg
from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.ops import bounce_ad as tad
from miniraytracer_tpu_torch.ops import intersect as tix
from miniraytracer_tpu_torch.parallel import train as ttrain
from miniraytracer_tpu_torch.scene import types as ttypes
from tests import test_bounce_ad as jtests
from tests.test_torch_flash import _assert_rows_close
from tests.test_torch_scene import _leaves

torch.set_num_threads(1)

FLASH_NAMES = ("flash_tri_hit", "flash_tri_hit_resident", "flash_tri_hit_streamed",
               "flash_sphere_hit", "flash_sphere_hit_gated", "flash_sphere_hit_streamed")
_PAIRS = {}


def scene_pair(name):
    """(JAX scene, port scene carried over from it)."""
    if name not in _PAIRS:
        probes = {"tris_200": (80, 200), "tris_1100": (4, 1100), "spheres_600": (600, 0),
                  "spheres_5000": (5000, 0)}
        if name in probes:
            js = tscenes.hybrid_probe(1.0, *probes[name], builder_cls=JBuilder)
        elif name == "sphere_light":
            js = jtests._sphere_light_scene()
        else:
            js = getattr(jscenes, name)(1.0)
        _PAIRS[name] = (js, ttypes.from_numpy(_leaves(js)))
    return _PAIRS[name]


# ---------------------------------------------------------------------------
# (a) make_accel(differentiable=True)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,keys", [
    ("tris_200", {"sph_d", "tri_d"}), ("tris_1100", {"tri_cull_d"}),
    ("random_spheres_2", {"sph_d"}), ("spheres_600", {"sph_cull_d"}),
    ("spheres_5000", {"sph_cull_d"}), ("perlin_spheres", set())])
def test_make_accel_differentiable_equals_jax(monkeypatch, name, keys):
    js, ts = scene_pair(name)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jacc = jix.make_accel(js, differentiable=True) or {}
    leaves = ttrain.TrainParams(*(p.clone().requires_grad_(True)
                                  for p in ttrain.extract_params(ts)))
    acc = tix.make_accel(ttrain.apply_params(ts, leaves), differentiable=True)
    assert set(jacc) == set(acc) == keys
    for k in ("sph_d", "tri_d"):
        if k in acc:
            # the gradient reaches the scene's leaves (c_det has no tri_m in it)
            assert all(b.requires_grad for b in acc[k][k == "tri_d":])
            for a, b in zip(jacc[k], acc[k]):
                _assert_rows_close(a, b.detach().numpy())
    if "sph_cull_d" in acc:
        ((jcb, jcc), jbounds, jorig, _), jco = jacc["sph_cull_d"]
        ((cb, cc), bounds, orig), co = acc["sph_cull_d"]
        np.testing.assert_array_equal(orig.numpy(), np.asarray(jorig))
        np.testing.assert_array_equal(bounds.numpy(), np.asarray(jbounds))
        for a, b in ((jcb, cb), (jcc, cc), *zip(jco, co)):
            _assert_rows_close(a, b.detach().numpy())
        assert not (cb.requires_grad or bounds.requires_grad) and co[0].requires_grad
    if "tri_cull_d" in acc:
        (jcds, jbounds, jorig, jord, _), jco = jacc["tri_cull_d"]
        (cds, bounds, orig, cl_ord), co = acc["tri_cull_d"]
        np.testing.assert_array_equal(orig.numpy(), np.asarray(jorig))
        np.testing.assert_array_equal(bounds.numpy(), np.asarray(jbounds))
        np.testing.assert_array_equal(cl_ord.numpy(), np.asarray(jord))
        for a, b in (*zip(jcds, cds), *zip(jco, co)):
            _assert_rows_close(a, b.detach().numpy())
        assert not cds[0].requires_grad and co[3].requires_grad


def test_scene_hit_routes_the_differentiable_entries(monkeypatch):
    """Each `_d` entry reaches its custom-VJP sweep with `plain` passed
    through, and gives the forward entry's record."""
    from miniraytracer_tpu_torch.ops import flash as tflash

    seen = []
    for fn in ("flash_sphere_hit_d", "flash_sphere_hit_culled_d", "flash_tri_hit_d",
               "flash_tri_hit_culled_d"):
        real = getattr(tflash, fn)
        monkeypatch.setattr(tflash, fn, lambda *a, _f=fn, _r=real, **k: (
            seen.append((_f, k.get("plain"))), _r(*a, **k))[1])
    rs = np.random.default_rng(3)
    for name in ("tris_200", "spheres_600", "tris_1100"):
        _, ts = scene_pair(name)
        n = 96
        s, t = (torch.as_tensor(rs.random(n, dtype=np.float32)) for _ in range(2))
        keys = torch.as_tensor(rs.integers(0, 2 ** 32, n))
        rays = tcam.get_rays(ts.camera, s, t, keys)
        fwd = tix.scene_hit(ts, rays, accel=tix.make_accel(ts))
        d = tix.scene_hit(ts, rays, accel=tix.make_accel(ts, differentiable=True), plain=True)
        for a, b in zip(fwd, d):
            if isinstance(a, tuple):
                for x, y in zip(a, b):
                    torch.testing.assert_close(y, x, rtol=0, atol=1e-6)
            else:
                torch.testing.assert_close(b, a, rtol=0, atol=1e-6)
        assert fwd.hit.any()
    assert {f for f, _ in seen} == {"flash_sphere_hit_d", "flash_sphere_hit_culled_d",
                                    "flash_tri_hit_d", "flash_tri_hit_culled_d"}
    assert all(p is True for _, p in seen)


# ---------------------------------------------------------------------------
# (b) trace_paths(loop="scan")
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,atol,share,sweeps", [
    ("cornell_box", 1e-6, 1.0, True), ("random_spheres_2", 1e-4, 0.95, True),
    ("random_spheres_2", 1e-6, 1.0, False)])
def test_trace_paths_scan_equals_while_and_jax_scan(monkeypatch, name, atol, share, sweeps):
    js, ts = scene_pair(name)
    if sweeps:
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
        for fn in FLASH_NAMES:
            monkeypatch.setattr(jflash, fn, partial(getattr(jflash, fn), interpret=True))
    else:  # both sides sweep the spheres in tensor operations (sphere_ts)
        real = tix.make_accel
        monkeypatch.setattr(tix, "make_accel", lambda sc, differentiable=False: {} if
                            differentiable else real(sc))
    rs = np.random.default_rng(5)
    n, bounces = 96, 5
    s, t = (rs.random(n, dtype=np.float32) for _ in range(2))
    keys = rs.integers(0, 2 ** 32, n, dtype=np.int64)
    rays = tcam.get_rays(ts.camera, torch.as_tensor(s), torch.as_tensor(t), torch.as_tensor(keys))
    rad_w, n_w = tinteg.trace_paths(ts, rays, torch.as_tensor(keys), bounces)
    rad_s, n_s = tinteg.trace_paths(ts, rays, torch.as_tensor(keys), bounces, loop="scan")
    assert n_s.dtype == torch.int64 and int(n_s) == int(n_w) > n
    for a, b in zip(rad_s, rad_w):
        assert torch.equal(a, b) or not sweeps  # the while loop keeps its sweeps
    jrays = jcam.get_rays(js.camera, jnp.asarray(s), jnp.asarray(t),
                          jnp.asarray(keys.astype(np.uint32)))
    with jax.disable_jit():
        jrad, jn = jinteg.trace_paths(js, jrays, jnp.asarray(keys.astype(np.uint32)), bounces,
                                      loop="scan")
    assert int(n_s) == int(jn)
    err = np.max([np.abs(a.numpy() - np.asarray(b)) for a, b in zip(rad_s, jrad)], axis=0)
    assert (err <= atol).mean() >= share and err.max() <= 5e-3, err.max()
    with pytest.raises(ValueError, match="loop"):
        tinteg.trace_paths(ts, rays, torch.as_tensor(keys), bounces, loop="fori")


# ---------------------------------------------------------------------------
# (c) sample_radiance_packed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cornell_packed():
    """The setup of tests/test_integrator.py's packed-scan test, in both
    packages: cornell_box 24x24, one sample a pixel at offset (0.5, 0.5), 8
    bounces, pack 8, 8*8 + 9 scan steps; JAX's jitted."""
    js, ts = scene_pair("cornell_box")
    w = 24
    kw = dict(width=w, height=w, max_bounces=8)
    off = np.asarray([0.5, 0.5], np.float32)
    jr, jdone, jrays = jax.jit(partial(jinteg.sample_radiance_packed, pack=8,
                                       scan_steps=8 * 8 + 9, **kw))(
        js, jnp.arange(w * w, dtype=jnp.uint32), jnp.int32(0), jnp.asarray(off))
    pix = torch.arange(w * w)
    r1, done, rays1 = tinteg.sample_radiance_packed(ts, pix, 0, torch.as_tensor(off), pack=8,
                                                    scan_steps=8 * 8 + 9, **kw)
    return dict(ts=ts, kw=kw, pix=pix, off=torch.as_tensor(off), r1=r1, done=done,
                rays1=rays1, jax=(np.asarray(jr.arr), np.asarray(jdone), float(jrays)))


def _assert_packed_rule(a, b):
    d = np.abs(a - b)
    assert np.median(d) == 0.0
    assert (d > 1e-5).mean() < 5e-3, (d > 1e-5).mean()


def test_packed_scan_matches_unpacked_and_jax(cornell_packed):
    c = cornell_packed
    r0, rays0 = tinteg.sample_radiance(c["ts"], c["pix"], 0, c["off"], loop="scan", **c["kw"])
    assert bool(c["done"].all())
    _assert_packed_rule(c["r1"].arr.numpy(), r0.arr.numpy())
    assert abs(int(rays0) - int(c["rays1"])) <= 1e-2 * int(rays0)
    jr, jdone, jrays = c["jax"]
    assert (c["done"].numpy() == jdone).mean() >= 0.99
    assert abs(int(c["rays1"]) - jrays) <= 1e-2 * jrays
    _assert_packed_rule(c["r1"].arr.numpy(), jr)


def test_packed_scan_truncation_is_observable(cornell_packed):
    """An under-budgeted scan drops whole items (done False) and never
    returns partial radiance; the completed items equal the full run's."""
    c = cornell_packed
    w = 16
    kw = dict(c["kw"], width=w, height=w)
    pix = torch.arange(w * w)
    full, done_f, _ = tinteg.sample_radiance_packed(c["ts"], pix, 0, c["off"], pack=8,
                                                    scan_steps=8 * 8 + 9, **kw)
    tiny, done_t, _ = tinteg.sample_radiance_packed(c["ts"], pix, 0, c["off"], pack=8,
                                                    scan_steps=12, **kw)
    assert bool(done_f.all()) and not bool(done_t.all()) and bool(done_t.any())
    assert torch.isfinite(tiny.arr).all()
    m = done_t
    np.testing.assert_allclose(tiny.arr[m].numpy(), full.arr[m].numpy(), atol=1e-6)
    assert (tiny.arr[~m] == 0).all()
    with pytest.raises(ValueError, match="multiple of pack"):
        tinteg.sample_radiance_packed(c["ts"], pix[:-1], 0, c["off"], pack=8, **kw)
    with pytest.raises(ValueError, match="scan_steps"):
        tinteg.sample_radiance_packed(c["ts"], pix, 0, c["off"], pack=8, scan_steps=5, **kw)


def test_packed_per_item_samples_and_offsets():
    """Per-item sample indices and offsets: each item is the unpacked scan's
    sample of its own (pixel, sample, offset), and the slot select and
    write are exact."""
    _, ts = scene_pair("cornell_box")
    w, kw = 6, dict(width=6, height=6, max_bounces=4)
    offs, _ = tinteg.sample_offsets(64)
    pix = torch.arange(w * w).repeat(2)
    samp = torch.arange(2).repeat_interleave(w * w) + 5
    rad, done, _ = tinteg.sample_radiance_packed(ts, pix, samp, offs[samp % 64], pack=4,
                                                 scan_steps=4 * 5 + 2, **kw)
    assert bool(done.all())
    for s in (5, 6):
        one, _ = tinteg.sample_radiance(ts, torch.arange(w * w), s, offs[s], loop="scan", **kw)
        part = slice((s - 5) * w * w, (s - 4) * w * w)
        _assert_packed_rule(rad.arr[part].numpy(), one.arr.numpy())
    table = torch.arange(12.0).reshape(2, 2, 3)
    out = tinteg._write_slot(table, torch.tensor([1, 0]), torch.tensor([[7.0, 8, 9], [1, 1, 1]]),
                             torch.tensor([True, False]))
    assert out.tolist() == [[[0, 1, 2], [7, 8, 9]], [[6, 7, 8], [9, 10, 11]]]
    assert tinteg._select_slot(torch.tensor([[1, 2], [3, 4]]), torch.tensor([1, 0])).tolist() == [
        2, 3]


# ---------------------------------------------------------------------------
# (e) the fused AD step against the packed scan, in the port
# ---------------------------------------------------------------------------


def _fold_packed(ts, pix, spp, w, bounces, steps):
    """(sum, nvalid) per pixel from the packed scan on the items the fused
    step owns: sample s of each pixel at offset s of 64."""
    n = pix.shape[0]
    offs, _ = tinteg.sample_offsets(64)
    samp = torch.arange(spp).repeat_interleave(n)
    rad, done, _ = tinteg.sample_radiance_packed(ts, pix.repeat(spp), samp, offs[samp % 64],
                                                 width=w, height=w, max_bounces=bounces,
                                                 pack=spp, scan_steps=steps)
    rad3 = rad.arr.reshape(spp, n, 3)
    val = done.reshape(spp, n, 1) & torch.isfinite(rad3).all(-1, keepdim=True)
    return torch.where(val, rad3, 0.0).sum(0), val.to(torch.float32).sum(0)[:, 0], done


@pytest.mark.parametrize("name", ["cornell_box", "sphere_light"])
def test_fused_step_matches_packed_scan(name):
    _, ts = scene_pair(name)
    w, spp, bounces = 10, 2, 6
    steps = spp * (bounces + 1) + 2
    pix = torch.arange(w * w)
    target = torch.full((w * w, 3), 0.25)
    out = {}
    for kind in ("fused", "packed"):
        leaves = ttrain.TrainParams(*(p.clone().requires_grad_(True)
                                      for p in ttrain.extract_params(ts)))
        sc = ttrain.apply_params(ts, leaves)
        if kind == "fused":
            summ, nv, _ = tad.sample_pixel_sums_fused(sc, pix.to(torch.int32), 0, spp, width=w,
                                                      height=w, max_bounces=bounces,
                                                      scan_steps=steps)
        else:
            summ, nv, done = _fold_packed(sc, pix, spp, w, bounces, steps)
            assert bool(done.all()), "the packed reference must complete"
        err = torch.where(nv[:, None] > 0, summ / nv.clamp_min(1)[:, None] - target, 0.0)
        loss = (err * err).sum()
        out[kind] = (summ.detach(), nv, loss.detach(),
                     torch.autograd.grad(loss, list(leaves), allow_unused=True))
    (sf, nf, lf, gf), (sx, nx, lx, gx) = out["fused"], out["packed"]
    assert torch.equal(nf, nx)
    assert float((sf - sx).abs().max()) < 1e-5
    np.testing.assert_allclose(float(lf), float(lx), rtol=1e-5)
    nonzero = False
    for leaf, a, b in zip(ttrain.TrainParams._fields, gf, gx):
        a = torch.zeros_like(ts.tex_c0) if a is None and b is None else a
        if b is None:
            assert a is None or float(a.abs().max()) == 0.0, leaf
            continue
        b = b.numpy()
        a = np.zeros_like(b) if a is None else a.numpy()
        assert np.isfinite(a).all() and np.isfinite(b).all(), leaf
        scale = max(np.abs(b).max(), 1e-3)
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4 * scale, err_msg=leaf)
        nonzero |= bool(np.abs(b).max() > 0)
    assert nonzero


# ---------------------------------------------------------------------------
# (f) the progressive renderer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loop", ["while", "scan"])
def test_render_progressive_matches_jitted_jax(loop):
    js, ts = scene_pair("cornell_box")
    w, spp, bounces = 8, 4, 4
    fj, sj = jinteg.render(js, w, w, spp, max_bounces=bounces, loop=loop)
    fj = np.asarray(fj)
    ft, st = mrt.render_progressive(ts, w, w, spp, max_bounces=bounces, loop=loop,
                                    device="cpu")
    assert st["renderer"] == "progressive" and st["spp"] == spp and ft.shape == (w, w, 3)
    assert abs(st["rays"] - sj["rays"]) <= 0.005 * sj["rays"]
    err = np.abs(ft.numpy() - fj).max(axis=-1)
    assert (err < 1e-4).mean() >= 0.97, (err < 1e-4).mean()
    np.testing.assert_allclose(ft.numpy().mean((0, 1)), fj.mean((0, 1)), rtol=0.01)
    if loop == "scan":  # the port's two loops give the same frame
        fw, sw = mrt.render_progressive(ts, w, w, spp, max_bounces=bounces, device="cpu")
        assert torch.equal(fw, ft) and sw["rays"] == st["rays"]


def test_progressive_on_random_spheres_2_follows_its_passes():
    """One pass is `render_pass`, the frame the passes' draw2 average; the
    kernels' plain versions run (the scene is on the CPU); `progress` sees
    each pass, and the default device is the GPU."""
    _, ts = scene_pair("random_spheres_2")
    w = 4
    seen = []
    frame, st = mrt.render_progressive(ts, w, w, 4, max_bounces=3, device="cpu",
                                       progress=lambda i, n, f: seen.append((i, n)))
    assert seen == [(1, 4), (2, 4), (3, 4), (4, 4)] and torch.isfinite(frame).all()
    offs, _ = tinteg.sample_offsets(4)
    acc = torch.zeros((w * w, 3))
    rays = 0
    for i in range(4):
        acc, r = tinteg.render_pass(ts, acc, i, offs[i], 1000.0, width=w, height=w,
                                    max_bounces=3)
        rays += int(r)
    assert torch.equal(acc.reshape(w, w, 3), frame) and rays == st["rays"]
    rows, r = tinteg.render_tile_pass(ts, torch.zeros((3, 3)), torch.tensor([0, 5, 9]), 0,
                                      offs[0], 1000.0, width=w, height=w, max_bounces=3)
    one, _ = tinteg.render_pass(ts, torch.zeros((w * w, 3)), 0, offs[0], 1000.0, width=w,
                                height=w, max_bounces=3)
    assert torch.equal(rows, one[[0, 5, 9]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mrt.render_progressive(ts, w, w, 1)


def test_merge_pass_and_nan_policy_match_jax(monkeypatch):
    """The incremental average, the luminance clamp on the running average
    and the NaN policy of `render_pixels` (a sample with a non-finite
    channel takes the previous average, or 0 on the first pass), against
    JAX's, on the same samples to the bit."""
    from miniraytracer_tpu.ops.vecmath import V3 as JV3
    from miniraytracer_tpu_torch.ops.vecmath import V3

    rs = np.random.default_rng(9)
    frame = rs.uniform(0, 3, (64, 3)).astype(np.float32)
    color = rs.uniform(0, 3, (64, 3)).astype(np.float32)
    color[:8] *= 1e4  # past the clamp
    for k in (0, 1, 7):
        for max_lum in (1000.0, 2.0):
            jm = jinteg.merge_pass(jnp.asarray(frame), jnp.asarray(color), jnp.int32(k), 1.0,
                                   jnp.float32(max_lum))
            tm = tinteg.merge_pass(torch.as_tensor(frame), torch.as_tensor(color), k, 1.0,
                                   max_lum)
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    sample = color.copy()
    sample[1, 0], sample[2, 2], sample[3, 1] = np.nan, np.inf, -np.inf
    monkeypatch.setattr(jinteg, "sample_radiance", lambda *a, **k: (
        JV3(*(jnp.asarray(sample[:, c]) for c in range(3))), jnp.float32(0)))
    monkeypatch.setattr(tinteg, "sample_radiance", lambda *a, **k: (
        V3(*(torch.as_tensor(sample[:, c]) for c in range(3))), torch.zeros((), dtype=torch.int64)))
    _, ts = scene_pair("cornell_box")
    kw = dict(width=8, height=8, max_bounces=2)
    for k in (0, 3):
        jf, _ = jinteg.render_pixels(None, jnp.asarray(frame), jnp.arange(64, dtype=jnp.uint32),
                                     jnp.int32(k), jnp.zeros(2), jnp.float32(1000.0), **kw)
        tf, _ = tinteg.render_pixels(ts, torch.as_tensor(frame), torch.arange(64), k,
                                     torch.zeros(2), 1000.0, **kw)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        assert torch.isfinite(tf).all()
        if k == 0:
            assert (tf[1:4] == 0).all()
        else:
            np.testing.assert_array_equal(tf[1:4].numpy(), frame[1:4])


# ---------------------------------------------------------------------------
# Finite gradients through every leaf (tests/test_parallel.py's oracle)
# ---------------------------------------------------------------------------


def _cornell_grad_scene():
    """tests/test_parallel.py's `cornell_grad`: the Cornell box's sphere,
    rects, box, light and dielectric, and one big triangle before the back
    wall, so that every leaf (tri_m too) takes a gradient."""
    b = mrt.SceneBuilder()
    b.name = "cornell_grad"
    tscenes._cornell_camera(b, 1.0)
    white = b.lambertian(b.tex_const([0.73, 0.73, 0.73]))
    green = b.lambertian(b.tex_const([0.12, 0.45, 0.15]))
    red = b.lambertian(b.tex_const([0.65, 0.05, 0.05]))
    light = b.diffuse_light(b.tex_const([15.0, 15.0, 15.0]))
    b.yz_rect(555, 0, 0, 555, 555, green)
    b.yz_rect(0, 555, 0, 555, 0, red)
    b.add_light(b.xz_rect(343, 213, 227, 332, 554, light))
    b.xz_rect(555, 0, 0, 555, 555, white)
    b.xz_rect(0, 555, 0, 555, 0, white)
    b.xy_rect(0, 555, 0, 555, 555, white)
    b.box([0, 0, 0], [165, 330, 165], white, rot_y_deg=15.0, offset=[265, 0, 295])
    b.sphere([190, 90, 190], 90, b.dielectric(1.5))
    b.triangle([30, 30, 540], [275, 520, 540], [525, 30, 540], white)
    b.use_sky = False
    return b.build()


@pytest.mark.parametrize("name", ["cornell_grad", "random_spheres_2"])
def test_scan_gradients_finite_through_every_leaf(name):
    """No NaN or inf in any leaf's gradient of the unpacked scan's summed
    radiance (the JAX package's test) and of the packed scan's, whose dead
    lanes and never-started items trace on: the double-where guards of the
    eager square roots, divisions and inverse trig (the image texture's
    sphere uv on random_spheres_2) and the VJP sweeps' masked primals."""
    scene = _cornell_grad_scene() if name == "cornell_grad" else scene_pair(name)[1]
    w = 8
    offs, _ = tinteg.sample_offsets(1)
    pix = torch.arange(w * w)
    for pack in (1, 8):
        leaves = ttrain.TrainParams(*(p.clone().requires_grad_(True)
                                      for p in ttrain.extract_params(scene)))
        sc = ttrain.apply_params(scene, leaves)
        kw = dict(width=w, height=w, max_bounces=4)
        if pack == 1:
            rad, _ = tinteg.sample_radiance(sc, pix, 0, offs[0], loop="scan", **kw)
        else:
            rad, done, _ = tinteg.sample_radiance_packed(sc, pix, 0, offs[0], pack=pack,
                                                         scan_steps=12, **kw)
            assert not bool(done.all())  # truncated: never-started items on dead lanes
        g = torch.autograd.grad(rad.arr.sum(), list(leaves), allow_unused=True)
        for leaf, gl in zip(ttrain.TrainParams._fields, g):
            assert gl is None or torch.isfinite(gl).all(), f"{name} pack {pack}: {leaf}"
        if pack == 1:  # geometry gradients flow (sph_c0; tri_m)
            assert float(g[3].abs().sum()) > 0
            assert name != "cornell_grad" or float(g[5].abs().sum()) > 0
