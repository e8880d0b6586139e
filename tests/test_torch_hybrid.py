"""The port's hybrid step renderer (`ops/hybrid.py`) against the JAX package's.

Three scenes reach the three modes of the step: `hybrid_probe` (spheres and
triangles swept outside, shared materials: 5 candidate rows), random_spheres
(a material a sphere: ext-material mode, 11 rows) and earth (an image
texture, no outside set). Lane states are taken from the port's own render
loop (the first step and later ones, with dead lanes, lanes inside glass and
moving spheres) and fed to both packages:

- the packed scene (`pack_scene_hybrid`: meta, tables) must be equal;
- one step: the port's `hybrid_step` (plain version, CPU) against JAX
  `bounce.wave_step(ext=...)` called eagerly on the same rows, and against
  the JAX step kernel `hybrid._step_call(interpret=True)` followed by
  `_apply_image_albedo`. Eager JAX rounds every operation on its own, as the
  port does: integers, keys and ray counts must be bit-equal on every lane
  and floats within 1e-6 of the row's scale. The jitted kernel contracts
  a*b+c into fused multiply-adds (as tests/test_torch_bounce.py explains), so
  against it a lane in a few hundred may take another discrete decision:
  at least 99% of lanes must agree in every integer, and on those 97% of
  the floats within 1e-5 and all within 1e-3 of the row's scale (when one
  multiply-add is fused, a hit point on a radius-1000 sphere moves by an ulp
  of 1000, 6e-5, the direction scattered off it by about 1e-4, and Perlin
  turbulence, a sum of hundreds of products that cancel, by more than 1e-5
  on a lane in a hundred);
- `_external_candidate`'s rows against JAX's on the same rays;
- whole renders against JAX `render_wavefront_hybrid(interpret=True)`, the
  jitted XLA wavefront and `golden_renders.npz`, statistically (ray drift
  < 2%, channel means to 5e-3 relative), as tests/test_hybrid.py compares
  its own two renderers;
- `pick_renderer` against the JAX rule on all nine scene classes, and which
  primitive counts route where.
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
from miniraytracer_tpu.ops import bounce as jbounce
from miniraytracer_tpu.ops import hybrid as jhybrid
from miniraytracer_tpu.ops import intersect as jix
from miniraytracer_tpu.ops.vecmath import V3 as JV3
from miniraytracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from miniraytracer_tpu_torch.models import integrator as tinteg
from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.ops import bounce as tbounce
from miniraytracer_tpu_torch.ops import flash as tflash
from miniraytracer_tpu_torch.ops import hybrid as thybrid
from miniraytracer_tpu_torch.scene import types as ttypes
from tests.make_goldens import BOUNCES as G_BOUNCES, SIZE as G_SIZE, SPP as G_SPP
from tests.test_torch_scene import _leaves

torch.set_num_threads(1)

MAX_LUM = 1000.0
W = H = 32  # 1024 lanes: one (8, 128) block of the JAX step kernel
SQ, BOUNCES = 2, 8
STEPS = (0, 2, 5, 11)
MODES = ["hybrid_probe", "random_spheres", "earth"]


def _pair(name):
    if name == "hybrid_probe":
        return (tscenes.hybrid_probe(1.0, 80, 100, builder_cls=JSceneBuilder),
                tscenes.hybrid_probe(1.0, 80, 100))
    return getattr(jscenes, name)(1.0), getattr(tscenes, name)(1.0)


@pytest.fixture(scope="module")
def captured():
    """{scene name: (jax scene, port scene, StepConfig, accel, [(state, ext)
    at each of STEPS])} from the port's plain render loop."""
    out = {}
    for name in MODES:
        js, ts = _pair(name)
        meta, tables = thybrid.pack_scene_hybrid(ts)
        cfg = thybrid.StepConfig(meta=meta, tables=tuple(tables), images=ts.images,
                                 width=W, height=H, sq=SQ, max_bounces=BOUNCES,
                                 max_lum=MAX_LUM, sample_lo=0, n_samples=SQ * SQ)
        accel = thybrid.hybrid_accel(ts)
        pix = torch.arange(W * H, dtype=torch.int32)
        state = thybrid.initial_state(ts, pix, 0, SQ * SQ, width=W, height=H, spp_sq=SQ)
        snaps = []
        for step in range(max(STEPS) + 1):
            f, i = state[0], state[1]
            ext = torch.stack(thybrid._external_candidate(
                ts, accel, thybrid.state_rays(f, i), f[thybrid.R_ALIVE] > 0, tbounce.TMIN))
            if step in STEPS:
                snaps.append((state, ext))
            state = thybrid.hybrid_step(cfg, *state, pix, ext)
        out[name] = (js, ts, cfg, accel, pix, snaps)
    return out


def _tile(t, dtype=None):
    a = t.numpy()
    if dtype is not None:
        a = a.astype(dtype)
    return jnp.asarray(a.reshape(*a.shape[:-1], -1, 128))


def _flat(a):
    a = np.asarray(a)
    return a.reshape(*a.shape[:-2], -1)


def _jax_inputs(state, ext, pix):
    f, i, k, r = state
    return (_tile(f), _tile(i), _tile(k).view(jnp.uint32), _tile(r, np.float32),
            _tile(pix).astype(jnp.uint32), _tile(ext))


def _compare_step(port, jax_out, float_tol, min_agree, typical_tol=None):
    """port = (f, i, k, rays) tensors; jax_out the same as flat numpy rows:
    at least `min_agree` of the lanes equal in every integer, and on those
    every float within `float_tol` of its row's scale (and 97% of them within
    `typical_tol`, where given)."""
    fp, ip, kp, rp = (t.numpy() for t in port)
    fj, ij, kj, rj = jax_out
    agree = ((ip == ij).all(0) & (kp.view(np.uint32) == kj) & (rp == rj)
             & (fp[thybrid.R_ALIVE] == fj[thybrid.R_ALIVE]))
    assert agree.mean() >= min_agree, agree.mean()
    for row in range(thybrid.NF):
        scale = max(float(np.abs(fj[row]).max()), 1.0)
        err = np.abs(fp[row] - fj[row])[agree]
        assert err.max() <= float_tol * scale, (row, err.max(), scale)
        if typical_tol is not None:
            assert (err <= typical_tol * scale).mean() >= 0.97, row


@pytest.mark.parametrize("name", MODES)
def test_pack_scene_hybrid_equals_jax(captured, name):
    js, ts, cfg, _, _, _ = captured[name]
    jmeta, jtabs = jhybrid.pack_scene_hybrid(js)
    assert jmeta == cfg.meta
    assert jhybrid.ext_mat_mode(js) == thybrid.ext_mat_mode(ts)
    assert jhybrid._ext_types(js) == thybrid._ext_types(ts)
    if thybrid.ext_mat_mode(ts):
        assert jhybrid.smem_plan(js) == thybrid.smem_plan(ts)
    for k in range(8):
        np.testing.assert_array_equal(np.asarray(jtabs[k]), cfg.tables[k].numpy())
    expect = {"hybrid_probe": (False, False, 5), "random_spheres": (True, False, 1),
              "earth": (False, True, 2)}[name]
    assert (bool(cfg.meta.get("ext_mat")), cfg.meta["image"], cfg.meta["M"]) == expect


@pytest.mark.parametrize("name", MODES)
def test_hybrid_step_matches_eager_jax_wave_step(captured, name):
    js, ts, cfg, _, pix, snaps = captured[name]
    jmeta, jtabs = jhybrid.pack_scene_hybrid(js)
    seen_dead = seen_inside = seen_ext = 0
    for state, ext in snaps:
        port = thybrid.hybrid_step(cfg, *state, pix, ext)
        f, i, k, r, pj, e = _jax_inputs(state, ext, pix)
        c = (*f, *i, k, r)
        out, b, cont = jbounce.wave_step(
            jmeta, jtabs[:7], jtabs[8], jtabs[7], W, H, SQ, BOUNCES,
            jnp.float32(MAX_LUM), jnp.int32(0), jnp.int32(SQ * SQ), pj, c, ext=tuple(e))
        fj = jnp.stack(out[:jbounce.NF])
        if jmeta["image"]:
            img = jnp.where(cont, b.img_id, jnp.full_like(b.safe_t, -1.0))
            fj = jhybrid._apply_image_albedo(js, fj, img[None])
            assert float((img >= 0).sum()) > 0
        jax_out = (_flat(fj), _flat(jnp.stack(out[jbounce.NF:jbounce.NF + jbounce.NI])),
                   _flat(out[-2]), _flat(out[-1]))
        _compare_step(port, jax_out, 1e-6, 1.0)
        seen_dead += int((state[0][thybrid.R_ALIVE] == 0).sum())
        seen_inside += int((state[1][thybrid.I_INSIDE] > 0).sum())
        seen_ext += int((ext[0] < 3e38).sum())
    assert seen_dead > 0
    if name != "earth":
        assert seen_ext > 100 and seen_inside > 0


@pytest.mark.parametrize("name", MODES)
def test_hybrid_step_matches_jax_step_kernel(captured, name):
    js, ts, cfg, _, pix, snaps = captured[name]
    jmeta, jtabs = jhybrid.pack_scene_hybrid(js)
    meta_t = tuple(sorted(jmeta.items()))
    misc = jnp.asarray([MAX_LUM, 0.0, float(SQ * SQ)], jnp.float32)
    for state, ext in snaps[:3]:
        port = thybrid.hybrid_step(cfg, *state, pix, ext)
        f, i, k, r, pj, e = _jax_inputs(state, ext, pix)
        fj, ij, kj, rj, img = jhybrid._step_call(
            meta_t, tuple(jtabs), f, i, k, r, pj, e, misc, width=W, height=H, sq=SQ,
            max_bounces=BOUNCES, image=jmeta["image"], interpret=True)
        if jmeta["image"]:
            fj = jhybrid._apply_image_albedo(js, fj, img)
        _compare_step(port, (_flat(fj), _flat(ij), _flat(kj), _flat(rj)), 1e-3, 0.99,
                      typical_tol=1e-5)


@pytest.mark.parametrize("name", ["hybrid_probe", "random_spheres"])
def test_external_candidate_matches_jax(captured, name):
    js, ts, cfg, accel, pix, snaps = captured[name]
    jaccel = jhybrid.hybrid_accel(js, interpret=True)
    assert set(jaccel) == set(accel)
    n_rows = thybrid.NE_MAT if thybrid.ext_mat_mode(ts) else thybrid.NE
    for state, ext in snaps[:3]:
        f, i = state[0].numpy(), state[1].numpy()
        row = lambda r: jnp.asarray(f[r])
        rays = jix.Rays(JV3(row(3), row(4), row(5)), JV3(row(6), row(7), row(8)),
                        row(thybrid.R_TIME), jnp.asarray(i[thybrid.I_INSIDE]))
        jrows = np.stack([np.asarray(r, np.float32) for r in jhybrid._external_candidate(
            js, jaccel, rays, row(thybrid.R_ALIVE) > 0, jbounce.TMIN, True)])
        trows = ext.numpy()
        assert trows.shape == jrows.shape == (n_rows, W * H)
        hit_t, hit_j = trows[0] < 3e38, jrows[0] < 3e38
        assert (hit_t == hit_j).mean() >= 0.995
        assert not hit_t[f[thybrid.R_ALIVE] == 0].any()  # dead lanes miss
        # the same winner: the same material rows (ids and parameters exact)
        both = hit_t & hit_j
        mat_rows = [4, 5, 6] if n_rows == thybrid.NE_MAT else [4]
        same = both & (trows[mat_rows] == jrows[mat_rows]).all(0)
        assert same.sum() >= 0.995 * both.sum() and same.sum() > 100
        # t as far as the two dots' summation orders allow (test_torch_flash),
        # normals and albedo then to 1e-3
        # (random_spheres: a third of the hits are on the radius-1000 ground)
        assert (np.abs(trows[0] - jrows[0])[same] <= 1e-5 * jrows[0][same] + 1e-6).mean() >= 0.8
        np.testing.assert_allclose(trows[0][same], jrows[0][same], rtol=5e-3, atol=5e-3)
        close = same & (np.abs(trows[0] - jrows[0]) <= 1e-5 * jrows[0])
        for r in range(1, n_rows):
            np.testing.assert_allclose(trows[r][close], jrows[r][close], atol=2e-3, err_msg=str(r))
        miss = ~hit_t & ~hit_j
        np.testing.assert_array_equal(trows[:, miss], jrows[:, miss])


def _statistical(frame_t, rays_t, frame_j, rays_j, mean_tol=5e-3, ray_tol=0.02):
    assert np.isfinite(frame_t).all()
    assert abs(rays_t - rays_j) / max(rays_j, 1.0) < ray_tol, (rays_t, rays_j)
    mt, mj = frame_t.mean((0, 1)), np.asarray(frame_j).mean((0, 1))
    rel = np.abs(mt - mj) / np.maximum(np.abs(mj), 1e-6)
    assert rel.max() < mean_tol, (mt, mj)


RENDERS = [("hybrid_probe", 16, 16, 8), ("random_spheres", 16, 4, 8),
           ("earth", G_SIZE, G_SPP, G_BOUNCES)]


@pytest.mark.parametrize("name,size,spp,bounces", RENDERS)
def test_render_matches_jax_hybrid_and_wavefront(name, size, spp, bounces):
    js, ts = _pair(name)
    ft, st = thybrid.render_wavefront_hybrid(ts, size, size, spp, max_bounces=bounces)
    assert st["renderer"] == "hybrid" and st["steps"] > bounces
    ft = ft.numpy()
    fx, sx = jinteg.render_wavefront(js, size, size, spp, max_bounces=bounces)
    _statistical(ft, st["rays"], fx, sx["rays"])
    if name == "earth":
        # No outside set here: the step and its texel fetch follow the
        # wavefront lane by lane but for the jitted oracle's fused
        # multiply-adds (about one pixel in a hundred takes another path).
        # (That JAX's own hybrid loop equals its wavefront on earth is
        # tests/test_hybrid.py's; its interpreted Perlin kernel takes two
        # minutes to compile.) This is the goldens' configuration: the golden
        # frame itself was rendered from the real earth map, which is absent
        # here, so both packages take the procedural map instead.
        assert abs(st["rays"] - sx["rays"]) <= 0.005 * sx["rays"]
        err = np.abs(ft - np.asarray(fx)).max(-1)
        assert (err < 1e-4).mean() >= 0.97, (err < 1e-4).mean()
        return
    fj, sj = jhybrid.render_wavefront_hybrid(js, size, size, spp, max_bounces=bounces,
                                             interpret=True)
    _statistical(ft, st["rays"], fj, sj["rays"])


def test_render_matches_golden():
    with np.load(os.path.join(os.path.dirname(__file__), "golden_renders.npz")) as z:
        g = z["random_spheres"]
    ft, _ = thybrid.render_wavefront_hybrid(tscenes.random_spheres(1.0), G_SIZE, G_SIZE,
                                            G_SPP, max_bounces=G_BOUNCES)
    ft = ft.numpy()
    assert np.isfinite(ft).all()
    # per pixel where no path took another decision; the means as a whole
    close = np.isclose(ft, g, rtol=2e-4, atol=2e-5).all(axis=-1)
    assert close.mean() >= 0.85, close.mean()
    np.testing.assert_allclose(ft.mean((0, 1)), g.mean((0, 1)), rtol=0.01)


def test_render_auto_routes_random_spheres_to_hybrid():
    scene = tscenes.random_spheres(1.0)
    assert mrt.pick_renderer(scene) == "hybrid"
    steps = thybrid.step_launches, tflash.sphere_launches
    frame, stats = mrt.render(scene, 8, 8, 1, max_bounces=4, device="cpu")
    assert stats["renderer"] == "hybrid" and frame.shape == (8, 8, 3)
    assert torch.isfinite(frame).all() and stats["rays"] >= 64
    # on the CPU the plain versions ran: no kernel launch was counted
    assert steps == (thybrid.step_launches, tflash.sphere_launches)
    # earth is in the hybrid class, but the rule sends image scenes to the
    # work queue, whose shade step is the same machinery
    earth = tscenes.earth(1.0)
    assert thybrid.can_hybrid(earth) and thybrid.prefer_hybrid(earth)
    frame, stats = mrt.render(earth, 8, 8, 1, device="cpu")
    assert stats["renderer"] == "workqueue" and torch.isfinite(frame).all()


def test_entry_points_need_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        mrt.render(tscenes.random_spheres(1.0), 8, 8, 1)


NINE = jscenes.SCENE_NAMES


@pytest.mark.parametrize("name", NINE)
def test_pick_renderer_follows_the_jax_rule(monkeypatch, name):
    """On all nine scene classes, with the JAX rule evaluated as on its
    accelerator. The two scenes the port cannot build are carried over from
    the JAX package (`from_numpy`); triangles lacks its mesh files here in
    both packages alike. random_spheres_2 goes to the work queue with its
    shading in tensor operations, and `render` draws it."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    js = getattr(jscenes, name)(1.0)
    want = jinteg.pick_renderer(js)
    ts = (getattr(tscenes, name)(1.0) if hasattr(tscenes, name)
          else ttypes.from_numpy(_leaves(js)))
    assert thybrid.can_hybrid(ts) == jhybrid.can_hybrid(js)
    assert thybrid.prefer_hybrid(ts) == jhybrid.prefer_hybrid(js)
    assert tinteg.pick_renderer(ts) == want
    if name != "triangles":  # without its meshes a Cornell box: fused
        assert want == {"random_spheres": "hybrid", "random_spheres_2": "workqueue",
                        "earth": "workqueue", "book2_final": "workqueue"}.get(name, "fused")
    if name == "random_spheres_2":
        frame, stats = mrt.render(ts, 4, 4, 1, max_bounces=3, device="cpu")
        assert stats["renderer"] == "workqueue" and torch.isfinite(frame).all()


def _many(n_sph=0, n_tri=0, n_box=0, own_materials=False, image=False):
    b = mrt.SceneBuilder()
    b.name = "many"
    b.set_camera([0, 3, 12], [0, 1, 0], [0, 1, 0], 40.0, 1.0, aperture=0.0,
                 focus_dist=10.0, t0=0.0, t1=0.0)
    m = b.lambertian(b.tex_const([0.5, 0.5, 0.5]))
    rs = np.random.RandomState(1)
    for _ in range(n_sph):
        if own_materials:
            m = b.lambertian(b.tex_const(rs.uniform(0, 1, 3).tolist()))
        b.sphere(rs.uniform(-5, 5, 3).tolist(), 0.1, m)
    for _ in range(n_tri):
        p = rs.uniform(-5, 5, 3)
        b.triangle(p.tolist(), (p + [0.1, 0, 0]).tolist(), (p + [0, 0.1, 0]).tolist(), m)
    for _ in range(n_box):
        p = rs.uniform(-5, 5, 3)
        b.box(p.tolist(), (p + 0.1).tolist(), m)
    if image:
        b.sphere([0, 1, 0], 1.0, b.lambertian(b.tex_image(
            rs.uniform(0, 1, (8, 16, 3)).astype(np.float32))))
    return b.build()


@pytest.mark.parametrize("counts,renderer,accel", [
    (dict(n_sph=600), "hybrid", {"sph_gate"}),
    (dict(n_sph=1500, n_tri=100), "hybrid", {"sph_gate", "tri"}),
    (dict(n_sph=70, n_box=70), "hybrid", {"sph"}),
    (dict(n_sph=2100), "workqueue", {"sph_gate"}),
    (dict(n_sph=4200), "workqueue", {"sph_cull"}),
    (dict(n_sph=70, n_box=400), "workqueue", {"sph"}),
    (dict(n_sph=70, own_materials=True, image=True), "workqueue", {"sph"}),
    (dict(n_sph=30, own_materials=True), "wavefront", set()),
    # the clustered triangle tiers (the seeded sweep B10 behind all five):
    # in the hybrid loop, beside a gated sphere set, in the queue with its
    # shade step, and in the queue with its shading in tensor operations
    (dict(n_tri=1100), "hybrid", {"tri_cull"}),
    (dict(n_tri=1100, n_sph=600), "hybrid", {"tri_cull", "sph_gate"}),
    (dict(n_tri=2100), "workqueue", {"tri_cull"}),
    (dict(n_tri=1100, n_sph=70, own_materials=True, image=True), "workqueue",
     {"tri_cull", "sph"}),
    (dict(n_tri=1100, n_sph=30, own_materials=True, image=True), "workqueue", {"tri_cull"})])
def test_ported_tiers_route_and_render(counts, renderer, accel):
    """The gated (B13) and streamed (B12) sphere tiers, the clustered
    triangle tier (B10: 1024 triangles or more), an outside box set, the work
    queue with its shading in tensor operations and the plain wavefront,
    which raised before they were ported: `hybrid_accel` (or, where the
    shading is in tensor operations, `intersect.make_accel`) builds the
    sweeps' entries by the JAX package's thresholds and `render` draws the
    scene."""
    from miniraytracer_tpu_torch.ops import intersect as tix

    scene = _many(**counts)
    eager = renderer == "wavefront" or not thybrid.prefer_hybrid(scene)
    assert set((tix.make_accel if eager else thybrid.hybrid_accel)(scene)) == accel
    assert thybrid._ext_types(scene)[2] == (counts.get("n_box", 0) > 64)
    assert mrt.pick_renderer(scene) == renderer
    frame, stats = mrt.render(scene, 4, 4, 1, max_bounces=3, device="cpu")
    assert stats["renderer"] == renderer and torch.isfinite(frame).all()
    assert stats["rays"] >= 16
